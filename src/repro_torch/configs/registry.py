"""Architecture registry: ``--arch <id>`` selection over the LM configs the
port runs. The JAX package's other archs (``repro.configs.registry``) are
known by name and refused: each waits for the slice that ports the part
of its path the port does not have (ROADMAP.md §1)."""
from __future__ import annotations

import importlib

_ARCHS = ("rwkv6_1_6b", "zamba2_7b", "rwkv6_test", "qwen2_0_5b",
          "qwen2_1_5b", "qwen3_8b", "gemma_7b", "qwen3_moe_30b_a3b",
          "deepseek_v2_lite_16b")

# the JAX package's archs whose path the port does not run yet, with the
# part each waits for
_NOT_PORTED = {
    "musicgen_medium": "its audio-frame frontend (frontend='audio_frames')",
    "pixtral_12b": "its vision-patch frontend (frontend='vision_patches')",
}


def _mod_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def list_configs() -> list[str]:
    return [importlib.import_module(f"repro_torch.configs.{m}").CONFIG.name
            for m in _ARCHS]


def get_config(arch_id: str):
    mod = _mod_name(arch_id)
    if mod in _NOT_PORTED:
        raise NotImplementedError(
            f"arch '{arch_id}' is not ported yet: it needs "
            f"{_NOT_PORTED[mod]} (ROADMAP.md §1, item 15); ported: "
            f"{list_configs()}")
    if mod not in _ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {list_configs()}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
