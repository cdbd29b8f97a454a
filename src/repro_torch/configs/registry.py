"""Architecture registry: ``--arch <id>`` selection over the LM configs,
every one of the JAX package's (``repro.configs.registry``)."""
from __future__ import annotations

import importlib

_ARCHS = ("rwkv6_1_6b", "zamba2_7b", "rwkv6_test", "qwen2_0_5b",
          "qwen2_1_5b", "qwen3_8b", "gemma_7b", "qwen3_moe_30b_a3b",
          "deepseek_v2_lite_16b", "musicgen_medium", "pixtral_12b")


def _mod_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def list_configs() -> list[str]:
    return [importlib.import_module(f"repro_torch.configs.{m}").CONFIG.name
            for m in _ARCHS]


def get_config(arch_id: str):
    mod = _mod_name(arch_id)
    if mod not in _ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {list_configs()}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
