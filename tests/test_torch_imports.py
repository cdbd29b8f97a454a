"""``repro_torch`` stands alone: importing every one of its modules pulls in
neither ``jax`` nor the JAX package ``repro``, and builds nothing."""
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "triton")
print(json.dumps({"modules": names, "bad": bad, "loaded": loaded}))
"""


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    for name in ("repro_torch.kernels.pop_matmul", "repro_torch.serve.server",
                 "repro_torch.launch.serve", "repro_torch.checkpoint.manager",
                 "repro_torch.telemetry.window_probe",
                 "repro_torch.core.dvd", "repro_torch.envs.core",
                 "repro_torch.kernels.pop_adam", "repro_torch.optim.pop_adam",
                 "repro_torch.rl.td3", "repro_torch.rl.fused",
                 "repro_torch.core.pbt", "repro_torch.core.vectorize",
                 "repro_torch.configs.base", "repro_torch.pop.trainer",
                 "repro_torch.pop.strategy", "repro_torch.pop.backend",
                 "repro_torch.data.replay_buffer",
                 "repro_torch.rollout.engine", "repro_torch.launch.train",
                 "repro_torch.kernels.wkv6", "repro_torch.kernels.ssd",
                 "repro_torch.kernels.ops", "repro_torch.nn.rwkv6",
                 "repro_torch.nn.mamba2", "repro_torch.nn.rotary",
                 "repro_torch.nn.attention", "repro_torch.models.lm",
                 "repro_torch.configs.registry",
                 "repro_torch.configs.rwkv6_1_6b",
                 "repro_torch.configs.zamba2_7b",
                 "repro_torch.configs.rwkv6_test",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.configs.qwen2_0_5b",
                 "repro_torch.configs.qwen2_1_5b",
                 "repro_torch.configs.qwen3_8b",
                 "repro_torch.configs.gemma_7b",
                 "repro_torch.configs.qwen3_moe_30b_a3b",
                 "repro_torch.configs.deepseek_v2_lite_16b",
                 "repro_torch.configs.musicgen_medium",
                 "repro_torch.configs.pixtral_12b",
                 "repro_torch.examples.population_lm",
                 "repro_torch.nn.moe",
                 "repro_torch.core.cem", "repro_torch.core.shared",
                 "repro_torch.examples.cemrl", "repro_torch.examples.dvd",
                 "repro_torch.rl.sac", "repro_torch.rl.dqn",
                 "repro_torch.rl.networks", "repro_torch.rl.registry",
                 "repro_torch.nn.basic", "repro_torch.convert",
                 "repro_torch.pop.agent", "repro_torch.rollout.collector",
                 "repro_torch.rollout.evaluator", "repro_torch.rollout.vecenv",
                 "repro_torch.serve.forward", "repro_torch.rl.ppo",
                 "repro_torch.data.experience",
                 "repro_torch.examples.pbt_ppo",
                 "repro_torch.envs.hopper2d", "repro_torch.kernels.hopper2d",
                 "repro_torch.rollout.graph", "repro_torch.rollout.overlap",
                 "repro_torch.telemetry.run", "repro_torch.telemetry.sink",
                 "repro_torch.telemetry.latency",
                 "repro_torch.elastic.resize", "repro_torch.elastic.relayout",
                 "repro_torch.data.prefetch", "repro_torch.models.accounting",
                 "repro_torch.examples.quickstart",
                 "repro_torch.examples.pbt_td3",
                 "repro_torch.core.distributed", "repro_torch.launch.mesh",
                 "repro_torch.elastic.layout", "repro_torch.elastic.islands",
                 "repro_torch.optim.compress", "repro_torch.optim.dp",
                 "repro_torch.models.sharding",
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.hlo_analysis"):
        assert name in result["modules"]
    # no module imported triton either: kernels compile at first use
    assert "triton" not in result["loaded"]


def test_chip_smoke_imports_no_jax():
    """The chip smoke script drives the port alone."""
    text = (SRC.parent / "chip_smoke.py").read_text()
    assert "import jax" not in text and "from jax" not in text
    assert "from repro." not in text and "import repro\n" not in text
