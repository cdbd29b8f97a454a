"""The dry run on the ``meta`` device (``launch/dryrun.py``) and its
counter (``launch/hlo_analysis.py``) against the JAX package's.

The counter on toy graphs: a matmul chain's FLOPs and bytes exactly, a
view free, a kernel's meta route counted by its stated formula with no
build and no launch, a collective weighted by its factor. The roofline's
bottleneck selection, as ``tests/test_accounting_hlo.py`` holds JAX's.

``build_cell`` against JAX's for the two cells of ``DRYRUN_LITE``
(``tests/test_sharding_dryrun.py``: qwen2-0.5b x train_4k and rwkv6-1.6b x
decode_32k) at smoke width on a 2 x 2 x 2 (pod, data, model) mesh, JAX's
in an 8-device subprocess: ``arguments`` bytes a device exactly; dot
FLOPs a device within 15%. Both count the dot and convolution ops of the
graph one device runs, but XLA's autodiff and the port's autograd take
other products: XLA's attention backward holds one more attention-sized
product a layer than autograd's (the port's train cell is 0.876 of JAX's,
one such product short: 2.749e11 of 2.208e12), and the port's decode
step 1.027 of it. Their collective kinds are listed side by side in the
assertion's message: XLA's SPMD partitioner adds permutes and
all-to-alls of its own, which the port's explicit collectives do not
have.

One full-size cell through the CLI (qwen2-0.5b x decode_32k at 16 x 16;
``--all`` takes minutes on a CPU: 202.4 s of passes for its 72 cells),
the decode cell one H100 holds reckoned byte for byte, and a population
cell.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.configs import LM_SHAPES, get_config
from repro_torch.core.distributed import (VirtualGroup, all_gather,
                                          all_reduce, broadcast)
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.pop_adam import pop_adam
from repro_torch.kernels.pop_matmul import pop_matmul
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import (COLL_FACTOR, HBM_BW, LINK_BW,
                                             PEAK_FLOPS, OpCounter,
                                             roofline_terms)
from repro_torch.models import lm
from repro_torch.models.sharding import MeshShape
from repro_torch.tree import leaves
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LITE = [("qwen2-0.5b", "qwen2_0_5b", "train_4k"),
        ("rwkv6-1.6b", "rwkv6_1_6b", "decode_32k")]
FLOPS_RTOL = 0.15
MESH = MeshShape(("pod", "data", "model"), (2, 2, 2))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_roofline_terms_bottleneck_selection():
    t = roofline_terms({"flops": PEAK_FLOPS, "traffic_bytes": HBM_BW * 2,
                        "collective_bytes": LINK_BW * 0.5})
    assert t["t_compute"] == pytest.approx(1.0)
    assert t["t_memory"] == pytest.approx(2.0)
    assert t["t_collective"] == pytest.approx(0.5)
    assert t["bottleneck"] == "memory"
    assert t["roofline_s"] == pytest.approx(2.0)
    t = roofline_terms({"flops": 0, "traffic_bytes": 0,
                        "collective_bytes": LINK_BW * 3})
    assert t["bottleneck"] == "collective"


def test_counter_counts_a_matmul_chain_exactly_and_views_free():
    x, w1, w2 = _meta(4, 8), _meta(8, 16), _meta(16, 2)
    with OpCounter((x, w1, w2)) as c:
        h = x @ w1
        y = (h @ w2).t()             # a view: nothing
    a = c.analysis()
    assert a["flops"] == 2 * 4 * 8 * 16 + 2 * 4 * 16 * 2
    assert a["traffic_bytes"] == 4 * ((32 + 128 + 64) + (64 + 32 + 8))
    assert a["peak_bytes"] == 4 * (64 + 8) and y.shape == (2, 4)
    with OpCounter() as c:
        _meta(3, 5).transpose(0, 1)[2:].unsqueeze(0).expand(4, 3, 3)
    assert c.analysis()["traffic_bytes"] == 0


def test_kernel_meta_routes_count_their_formula_and_launch_nothing(
        monkeypatch):
    """Each wrapper's meta route: meta outputs of the right shapes, one
    custom call with its operand and output bytes and its FLOPs, no
    build (``build.load`` raises here) and no launch counted."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "load", lambda *a: pytest.fail("built"))
    before = launch_counts()
    b, h, s, d = 2, 4, 64, 16
    q, k = _meta(b, h, s, d, dtype=torch.bfloat16), _meta(
        b, 2, s, d, dtype=torch.bfloat16)
    r, st, u = _meta(b, h, s, d), _meta(b, h, d, d), _meta(h, d)
    x, dt, a_, bc = _meta(b, h, s, d), _meta(b, h, s), _meta(h), _meta(
        b, s, 8)
    sst = _meta(b, h, d, 8)
    p = _meta(3, 100)
    with OpCounter() as c:
        out = flash_attention(q, k, k)
        y, s1 = wkv6(r, r, r, r, u, st, chunk=16)
        z, s2 = ssd(x, dt, a_, bc, bc, sst, chunk=16)
        pm = pop_matmul(_meta(3, 5, 7), _meta(3, 7, 9))
        pa = pop_adam(p, p, p, p, _meta(3), _meta(3, dtype=torch.int32),
                      inplace=True)
    assert launch_counts() == before
    assert (out.shape, y.shape, s1.shape, z.shape, s2.shape, pm.shape) == (
        q.shape, r.shape, st.shape, x.shape, sst.shape, (3, 5, 9))
    assert pa[0] is p
    a = c.analysis()
    assert a["custom_calls"] == dict.fromkeys(
        ("flash_attention", "wkv6", "ssd", "pop_matmul", "pop_adam"), 1)
    assert a["flops"] == (4 * b * h * d * s * (s + 1) // 2
                          + b * h * s * (4 * d * d + 2 * 16 * d)
                          + b * h * s * (4 * d * 8 + 16 * (8 + d))
                          + 2 * 3 * 5 * 7 * 9)
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    assert a["traffic_bytes"] == (
        nb(q, k, k, out) + nb(r, r, r, r, u, st, y, s1)
        + nb(x, dt, a_, bc, bc, sst, z, s2)
        + 4 * (3 * 5 * 7 + 3 * 7 * 9 + 3 * 5 * 9)
        + nb(p, p, p, p) + 4 * 3 + 4 * 3 + 3 * nb(p))


def test_collectives_are_recorded_by_kind_and_factor():
    g = VirtualGroup("model", 4)
    t = torch.zeros(10)                 # a CPU tensor: nothing is run
    with OpCounter() as c:
        all_reduce(t, g)
        parts = all_gather(t, g)
        broadcast(t, 0, g)
    a = c.analysis()
    assert len(parts) == 4
    assert a["collective_counts"] == {"all-reduce": 1, "all-gather": 1,
                                      "broadcast": 1}
    assert a["collective_bytes"] == 40 * (
        COLL_FACTOR["all-reduce"] + 4 * COLL_FACTOR["all-gather"]
        + COLL_FACTOR["broadcast"])
    assert c.collectives[0]["issuer"].startswith("test_torch_dryrun:")


JAX_LITE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
from repro.configs import get_config
from repro.launch import dryrun
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh(model=2, data=2, pod=2)
out = {}
for arch, shape in %r:
    compiled, _, info = dryrun.build_cell(
        arch, shape, mesh=mesh, cfg_override=get_config(arch).smoke())
    out[arch] = dryrun.analyze_cell(compiled, info)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_lite():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    cells = [(j, s) for _, j, s in LITE]
    r = subprocess.run([sys.executable, "-c", JAX_LITE % cells], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch, jax_arch, shape", LITE,
                         ids=[f"{a}-{s}" for a, _, s in LITE])
def test_build_cell_matches_jax_dryrun_lite(jax_lite, arch, jax_arch,
                                            shape):
    want = jax_lite[jax_arch]
    counter, info = dryrun.build_cell(
        arch, shape, mesh=MESH, cfg_override=get_config(arch).smoke())
    got = dryrun.analyze_cell(counter, info)
    side = (f"collectives: port {got['collective_counts']} | JAX "
            f"{want['collective_counts']}")
    assert got["num_devices"] == want["num_devices"] == 8
    assert got["mesh"] == want["mesh"]
    assert (got["bytes_per_device"]["arguments"]
            == want["bytes_per_device"]["arguments"]), side
    assert got["hlo_flops_per_device"] == pytest.approx(
        want["hlo_flops_per_device"], rel=FLOPS_RTOL), side
    assert got["collective_counts"] and want["collective_counts"], side
    for key in ("t_compute", "t_memory", "t_collective", "bottleneck",
                "roofline_s", "compile_s", "xla_cost_analysis_flops"):
        assert key in got and key in want


def test_full_size_cell_through_the_cli(tmp_path, capsys):
    """qwen2-0.5b x decode_32k on the 16 x 16 mesh at full size, without
    a device or a process group, in seconds (at most 30)."""
    import torch.distributed as dist
    out = tmp_path / "cells.json"
    t0 = time.perf_counter()
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--no-analyze", "--out", str(out)]) == 0
    assert time.perf_counter() - t0 < 30
    assert "[dryrun] 1/1 cells OK" in capsys.readouterr().out
    assert not dist.is_initialized()
    (info,) = json.loads(out.read_text())
    assert info["status"] == "ok" and info["num_devices"] == 256
    assert set(info["bytes_per_device"]) == {"arguments", "outputs",
                                             "temps", "aliased"}


def test_decode_cell_on_one_card_is_reckoned_byte_for_byte():
    """The cell ``chip_smoke.py`` allocates on the H100 (qwen2-0.5b x
    decode_32k on a 1 x 1 mesh): the arguments are the bf16 weights, the
    KV cache (24 layers x 2 x 128 x 32,768 x 2 heads x 64 x 2 B =
    51.5 GB), the tokens and the int32 cache index."""
    cfg = get_config("qwen2-0.5b")
    shape = LM_SHAPES["decode_32k"]
    counter, info = dryrun.build_cell(
        "qwen2-0.5b", "decode_32k", mesh=MeshShape(("data", "model"),
                                                    (1, 1)))
    weights = sum(t.numel() * t.element_size() for t in leaves(
        lm.cast_params(lm.param_shapes(cfg), cfg)))
    cache = 24 * 2 * 128 * 32768 * 2 * 64 * 2
    assert cache == 51_539_607_552
    assert info["bytes_per_device"]["arguments"] == (
        weights + cache + shape.global_batch * 4 + 4)
    assert info["bytes_per_device"]["aliased"] == cache


def test_population_cell_steps_its_rows_through_pop_adam():
    """``--population 8`` on a 2 x 2 x 2 mesh: this rank's 2 members of
    rwkv6-test at model 2, one ``pop_adam`` meta call, members' tokens
    split."""
    counter, info = dryrun.build_population_cell(
        "rwkv6-test", "train_4k", 8, mesh=MESH)
    a = counter.analysis()
    assert info["population"] == 8
    assert a["custom_calls"] == {"pop_adam": 1}
    assert a["collective_counts"]["all-reduce"] > 0
    assert info["bytes_per_device"]["aliased"] > 0
