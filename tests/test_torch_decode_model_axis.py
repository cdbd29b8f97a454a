"""A decode state over the model axis: a model-sharded member served on
gloo ranks against the JAX package's ``make_serve_step`` on the whole
member.

Each family's smoke config (GQA with the heads layout; GQA with 3 kv
heads of 16, which forces the sequence layout; ``rwkv6-test``; zamba2;
deepseek's MLA; qwen3-moe) is served over 2 ranks spawned by
``run_ranks`` (``test_torch_islands``), and the GQA and zamba2 configs
over 4 as well: a 32-token prefill into a 40-slot cache, then 4 greedy
decode steps, each rank on its parts of the parameters (the rules'
``local_tree``) and its part of the decode state
(``init_decode_state(shard=)``). The JAX package's serve step (its
Pallas scans in interpret mode, ``ssm_chunk=16``) takes the same
parameters (the port's ``init_params``, float32) and the tokens the
ranks chose. Logits, and the decode state the ranks' parts put together
(``whole_decode_state``), agree to rtol = atol = 1e-4, the tolerance of
``tests/test_torch_lm.py``'s one-rank serve step (chunked and scanned
sums in other orders, and here the log-sum-exp combine of a cache split
over the sequence). Each rank's state is the part the layout rule gives
(half a cut leaf at 2 ranks, a padded sequence cut where the length does
not divide), and the rule is held leaf by leaf against the JAX dry run's
``_decode_state_shardings`` (an 8-device subprocess), with the
exception the rule states: Mamba2's conv state follows the forward onto
its channels.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro_torch.configs import get_config
from repro_torch.core.distributed import recording
from repro_torch.models import lm
from repro_torch.models.sharding import (ModelShard, decode_state_dims,
                                         local_tree, member_dims)
from repro_torch.nn.attention import _softmax_part, sdpa
from repro_torch.core.distributed import combine_softmax_parts
from repro_torch.tree import leaves
from test_torch_islands import run_ranks
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT, DECODE, BATCH, MAX_LEN = 32, 4, 2, 40
CASES = {
    "gqa_heads": ("qwen2-0.5b", {}),
    "gqa_seq": ("qwen2-0.5b", {"num_heads": 6, "num_kv_heads": 3,
                               "head_dim": 16}),
    "rwkv6": ("rwkv6-test", {}),
    "zamba2": ("zamba2-7b", {}),
    "mla": ("deepseek-v2-lite-16b", {}),
    "moe": ("qwen3-moe-30b-a3b", {}),
}
ON_FOUR = ("gqa_heads", "zamba2")


def _configs(arch, kw):
    jc, tc = jax_get_config(arch), get_config(arch)
    if arch != "rwkv6-test":
        jc, tc = jc.smoke(), tc.smoke()
    return (jc.replace(ssm_chunk=16, **kw),
            tc.replace(ssm_chunk=16, **kw))


def _whole_params(tc):
    return lm.cast_params(lm.init_params(torch.Generator().manual_seed(0),
                                         tc), tc)


def _tokens(vocab):
    return np.random.default_rng(1).integers(
        0, vocab, (BATCH, PROMPT)).astype(np.int64)


def _serve_rank(rank, world, names):
    """Every case of ``names`` on this rank: its parts of the member and
    of the state, a prefill and DECODE greedy steps."""
    import torch.distributed as dist
    out = {}
    shard = ModelShard(rank, world, dist.group.WORLD)
    for name in names:
        _, tc = _configs(*CASES[name])
        whole = _whole_params(tc)
        params = local_tree(whole, member_dims(whole, shard, lead=0), shard)
        step = lm.make_serve_step(tc, shard)
        state = lm.init_decode_state(tc, BATCH, MAX_LEN, shard=shard)
        shapes = lm.decode_state_shapes(tc, BATCH, MAX_LEN, shard=shard)
        local_shapes = [tuple(x.shape) for x in leaves(state)]
        tokens = torch.from_numpy(_tokens(tc.vocab_size))
        fed, logits, states = [], [], []
        for i in range(1 + DECODE):
            index = 0 if i == 0 else PROMPT + i - 1
            fed.append(tokens.numpy())
            got, state = step(params, {"tokens": tokens}, state, index)
            logits.append(got.numpy())
            if i in (0, DECODE):
                # copies: the state is updated in place by later steps
                states.append([x.float().numpy().copy() for x in leaves(
                    lm.whole_decode_state(tc, state, BATCH, MAX_LEN,
                                          shard))])
            tokens = got[:, -1].argmax(-1)[:, None]
        out[name] = {"fed": fed, "logits": logits, "states": states,
                     "local_shapes": local_shapes,
                     "want_shapes": [s for s, _ in _shape_leaves(shapes)],
                     "bytes": sum(x.numel() * x.element_size()
                                  for x in leaves(state))}
    return out


def _shape_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _shape_leaves(tree[k])]
    return [tree]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode")
    results, errors = {}, []

    def spawn(world, names):
        try:
            results[world] = run_ranks(_serve_rank, world, tmp, names,
                                       timeout=420)
        except BaseException as e:          # raised below
            errors.append(e)
    threads = [threading.Thread(target=spawn, args=a)
               for a in ((2, tuple(CASES)), (4, ON_FOUR))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _jax_serve(name, fed):
    jc, tc = _configs(*CASES[name])
    jc = jc.replace(use_kernels=True)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _whole_params(tc))
    step = jax.jit(jax_lm.make_serve_step(jc))
    state = jax_lm.init_decode_state(jc, BATCH, MAX_LEN)
    logits, states = [], []
    for i, tokens in enumerate(fed):
        index = 0 if i == 0 else PROMPT + i - 1
        got, state = step(jp, {"tokens": jnp.asarray(tokens, jnp.int32)},
                          state, jnp.asarray(index, jnp.int32))
        logits.append(np.asarray(got))
        if i in (0, DECODE):
            states.append([np.asarray(x, np.float32)
                           for x in jax.tree_util.tree_leaves(state)])
    return logits, states


@pytest.mark.parametrize("world, name",
                         [(2, n) for n in CASES] + [(4, n) for n in ON_FOUR])
def test_sharded_decode_matches_jax(served, world, name):
    """Every rank's logits at the prefill and each decode step, and the
    whole state its parts make after the prefill and the last step,
    against JAX's serve step on the whole member; each rank holds the
    part the rule gives."""
    ranks = [r[name] for r in served[world]]
    logits, states = _jax_serve(name, ranks[0]["fed"])
    for out in ranks:
        assert out["local_shapes"] == out["want_shapes"]
        for got, want in zip(out["logits"], logits):
            np.testing.assert_allclose(got, want, **TOL)
        for got_state, want_state in zip(out["states"], states):
            assert len(got_state) == len(want_state)
            for got, want in zip(got_state, want_state):
                assert got.shape == want.shape
                np.testing.assert_allclose(got, want, **TOL)
    _, tc = _configs(*CASES[name])
    whole = lm.decode_state_shapes(tc, BATCH, MAX_LEN)
    dims = decode_state_dims(tc, whole, world)
    expect = sum(np.prod(s) * torch.empty((), dtype=d).element_size()
                 // (world if dim is not None else 1)
                 for (s, d), dim in zip(_shape_leaves(whole),
                                        _shape_leaves(dims)))
    assert ranks[0]["bytes"] == expect


JAX_RULE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import LM_SHAPES, get_config
from repro.launch import dryrun
out = {}
for name, arch, kw, model in json.loads(sys.argv[1]):
    cfg = get_config(arch)
    cfg = (cfg if arch == "rwkv6-test" else cfg.smoke()).replace(**kw)
    mesh = Mesh(np.array(jax.devices()[:model]).reshape(1, model),
                ("data", "model"))
    shape = LM_SHAPES["decode_32k"].__class__("cell", %(seq)d, %(batch)d,
                                                "decode")
    shardings, shapes = dryrun._decode_state_shardings(cfg, shape, mesh)
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    out[f"{name}:{model}"] = {
        jax.tree_util.keystr(p): [i for i, a in enumerate(s.spec)
                                  if a == "model"] for p, s in flat}
print(json.dumps(out))
"""


def test_layout_rule_matches_jax_dry_run():
    """``decode_state_dim`` leaf by leaf against ``_decode_state_shardings``
    (a batch of 5 and 40 positions, which equal no head count), every
    case at model 2 and 4: the same dimension on ``model``, or none,
    except Mamba2's conv state, which the port cuts on the channels its
    forward convolves and JAX keeps whole. Then the parts the rule
    allocates, a padded sequence cut among them."""
    batch, seq = 5, 40
    jobs = [(n, *CASES[n], m) for n in CASES for m in (2, 4)]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c",
                        JAX_RULE % dict(seq=seq, batch=batch),
                        json.dumps(jobs)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    compared = differs = 0

    def paths(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree)
                    for x in paths(tree[k], f"{prefix}['{k}']")]
        return [(prefix, tree)]
    for name, arch, kw, m in jobs:
        _, tc = _configs(arch, kw)
        shapes = lm.decode_state_shapes(tc, batch, seq)
        got = dict(paths(decode_state_dims(tc, shapes, m)))
        rank = {p: len(s[0]) for p, s in paths(shapes)}
        assert sorted(got) == sorted(want[f"{name}:{m}"])
        for path, dim in got.items():
            jax_dims = want[f"{name}:{m}"][path]
            compared += 1
            if path.endswith("['conv']"):
                # the port's conv state follows its forward's channels
                assert jax_dims == [] and dim == rank[path] - 1
                differs += 1
                continue
            assert jax_dims == ([] if dim is None else [dim]), (name, m,
                                                                 path)
    assert (compared, differs) == (34, 2)
    _state_parts_and_padding()


def _state_parts_and_padding():
    """``init_decode_state(shard=)`` allocates only the rank's part: a
    sequence cut that does not divide is padded (41 positions, 21 a rank
    at model 2; the padded slots lie past every query); the whole state
    is the sum of the parts where each leaf is cut once."""
    _, tc = _configs(*CASES["gqa_seq"])
    shard = ModelShard(1, 2)
    part = lm.init_decode_state(tc, BATCH, 41, shard=shard)
    whole = lm.init_decode_state(tc, BATCH, 41)
    for got, full in zip(leaves(part), leaves(whole)):
        assert got.shape[:2] + got.shape[3:] == full.shape[:2] + \
            full.shape[3:]
        assert (got.shape[2], full.shape[2]) == (21, 41)
    _, tc = _configs(*CASES["rwkv6"])
    shapes = lm.decode_state_shapes(tc, BATCH, 41, shard=shard)["rwkv"]
    assert shapes["wkv"][0][2] == tc.d_model // tc.ssm_head_dim // 2
    assert shapes["tm_x"][0] == (tc.num_layers, BATCH, 1, tc.d_model)


def test_log_sum_exp_combine_is_the_softmax():
    """The flash-decoding combine of two halves of a cache equals
    ``sdpa`` over the whole cache (the halves' parts handed over by a
    recorder standing in for the all-gather)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, 4, 8, generator=g)
    k = torch.randn(2, 10, 2, 8, generator=g)
    v = torch.randn(2, 10, 2, 8, generator=g)
    qp = torch.tensor([[7, 8, 9]] * 2)
    kp = torch.arange(10).expand(2, 10)
    parts = [_softmax_part(q, k[:, s], v[:, s], qp, kp[:, s], scale=0.35)
             for s in (slice(0, 5), slice(5, 10))]
    packed = [torch.cat([m[..., None], l[..., None], o], -1)
              for m, l, o in parts]
    with recording(lambda kind, t, group: packed):
        out = combine_softmax_parts(*parts[0], ModelShard(0, 2))
    got = out.permute(0, 3, 1, 2, 4).reshape(2, 3, -1)
    torch.testing.assert_close(got, sdpa(q, k, v, qp, kp, scale=0.35),
                               rtol=1e-6, atol=1e-6)
