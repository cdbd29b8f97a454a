"""The int8 data-parallel reduction against the JAX package's.

``compress_tree`` is bit for bit with JAX's (both round half to even),
including values that land exactly on a half. ``make_dp_update`` on 2
gloo ranks (``run_ranks``) runs the JAX test's problem (a linear fit,
Adam at lr 0.05): it converges with either reduction (atol 0.05, the JAX
test's), compressed matches plain within the JAX test's 0.1, and both
match ``make_dp_update`` of the JAX package on 2 fake devices (run in a
subprocess) on the same batches: plain at 1e-5, int8 at 1e-3 (a rounding
that lands on the other side of a half moves one quantum, which error
feedback carries into the next step).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compress import compress_tree as jax_compress_tree
from repro_torch.optim import adam
from repro_torch.optim.compress import compress_tree, decompress_tree
from repro_torch.optim.dp import make_dp_update, wire_bytes
from test_torch_islands import run_ranks
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TARGET = np.arange(8.0, dtype=np.float32) / 4 - 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_tree_is_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    grads = {"a": rng.standard_normal((33, 7)).astype(np.float32),
             "b": {"c": rng.standard_normal(5).astype(np.float32) * 1e-3}}
    error = {"a": rng.standard_normal((33, 7)).astype(np.float32) * 1e-2,
             "b": {"c": np.zeros(5, np.float32)}}
    # halves: 127 * k / 2 over an amax of 127 quantizes on a tie
    grads["b"]["c"][:] = np.array([127.0, 0.5, 1.5, -2.5, 63.5], np.float32)
    jq, js, je = jax_compress_tree(jax.tree.map(jnp.asarray, grads),
                                   jax.tree.map(jnp.asarray, error))
    t = lambda tree: jax.tree.map(torch.from_numpy, tree)
    q, s, e = compress_tree(t(grads), t(error))
    for mine, theirs in ((q, jq), (s, js), (e, je)):
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, mine)),
                        jax.tree.leaves(theirs)):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
    assert q["b"]["c"].tolist() == [127, 0, 2, -2, 64]    # half to even
    d = decompress_tree(q, s)
    np.testing.assert_array_equal(d["a"].numpy(),
                                  q["a"].float().numpy() * s["a"].item())


def _batches(steps, world, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((steps, 8 * world, 8)).astype(np.float32)


def _grad_fn(params, batch):
    w = params["w"].detach().requires_grad_(True)
    pred = batch @ w
    loss = torch.mean((pred - batch @ torch.from_numpy(TARGET)) ** 2)
    (grad,) = torch.autograd.grad(loss, w)
    return loss.detach(), {"w": grad}


def _dp_rank(rank, world, steps, seed):
    out = {}
    batches = _batches(steps, world, seed)
    for compression in ("none", "int8"):
        params = {"w": torch.zeros(8)}
        opt_init, opt_update = adam(lr=0.05)
        opt_state = opt_init(params)
        error = {"w": torch.zeros(8)}
        update = make_dp_update(_grad_fn, opt_update,
                                compression=compression)
        for i in range(steps):
            shard = torch.from_numpy(batches[i, 8 * rank:8 * (rank + 1)])
            params, opt_state, error, loss = update(params, opt_state, error,
                                                    shard)
        out[compression] = params["w"].numpy()
        out[compression + "_loss"] = float(loss)
    out["wire"] = {c: wire_bytes(params, world, c) for c in ("none", "int8")}
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp")
    long = run_ranks(_dp_rank, 2, base, 300, 0)
    short = run_ranks(_dp_rank, 2, base, 40, 1)
    return long, short


def test_dp_update_converges(two_ranks):
    long, _ = two_ranks
    for compression in ("none", "int8"):
        for rank in long:          # every rank holds the same parameters
            np.testing.assert_array_equal(rank[compression],
                                          long[0][compression])
        np.testing.assert_allclose(long[0][compression], TARGET, atol=0.05)
    # int8 puts a quarter of the fp32 bytes a rank on the wire, per tensor
    assert long[0]["wire"] == {"none": 32, "int8": 24}


def test_compressed_matches_plain_within_tolerance(two_ranks):
    _, short = two_ranks
    np.testing.assert_allclose(short[0]["int8"], short[0]["none"], atol=0.1)


JAX_DP = """
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from repro import compat
from repro.optim import adam
from repro.optim.dp import make_dp_update

steps, seed = int(sys.argv[1]), int(sys.argv[2])
mesh = compat.make_mesh((len(jax.devices()),), ("data",))
target = jnp.arange(8.0) / 4 - 1.0

def grad_fn(params, batch):
    def loss(p):
        return jnp.mean((batch @ p["w"] - batch @ target) ** 2)
    return jax.value_and_grad(loss)(params)

rng = np.random.default_rng(seed)
batches = rng.standard_normal((steps, 8 * len(jax.devices()), 8)).astype(
    np.float32)
out = {}
for compression in ("none", "int8"):
    params = {"w": jnp.zeros(8)}
    opt_init, opt_update = adam(lr=0.05)
    opt_state = opt_init(params)
    error = jax.tree.map(jnp.zeros_like, params)
    update = make_dp_update(grad_fn, opt_update, mesh,
                            compression=compression)
    with compat.set_mesh(mesh):
        for i in range(steps):
            params, opt_state, error, loss = update(
                params, opt_state, error, jnp.asarray(batches[i]))
    out[compression] = np.asarray(params["w"]).tolist()
print(json.dumps(out))
"""


def test_dp_update_matches_jax_on_two_devices(two_ranks):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", JAX_DP, "40", "1"], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    _, short = two_ranks
    np.testing.assert_allclose(short[0]["none"], want["none"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(short[0]["int8"], want["int8"], atol=1e-3)
