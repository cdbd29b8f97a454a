"""The port's LM training path against the JAX package's, on the CPU.

Parameters are drawn by the port (``lm.init_params``) and carried to JAX
as numpy arrays; tokens are made with numpy. ``rwkv6-test`` and
``qwen2-0.5b`` at ``.smoke()`` width (and ``zamba2-7b``'s for the
gradients, whose remat unit is a super-block) take 32 tokens with
``ssm_chunk=16``, so the port's scans take their chunked form; the JAX
side runs its literal scans (``use_chunked=False``), as
``tests/test_torch_autograd.py`` explains. Tolerances:

  * ``lm_loss`` (with and without ``logits_chunk``): rtol 1e-5, float32
    sums in other orders;
  * gradients (remat on and off, ``grad_accum`` 2): rtol 1e-4 and an atol
    of 5e-5 times the leaf's largest gradient, as in the autograd test;
  * three steps of ``make_population_update`` with per-member
    ``lr_scale``, ``weight_decay`` and ``warmup_frac`` against JAX's
    (its stock-Adam path on the CPU): rtol 1e-4, atol 1e-6 on the
    parameters, the update parity's tolerance, and the gradients' on the
    first step's Adam moments (mu and the square root of nu);
  * the optimizers, the schedules and ``clip_by_global_norm``: rtol 1e-5,
    atol 1e-6 (the schedules' cosine and the norms' square roots round
    differently in XLA and torch);
  * ``pop_adam_plain`` with a decay and a clip scale, and the population
    optimizer in both storage forms, against JAX's ``population_adam``
    kernel path (the Pallas kernel in interpret mode, its clip and its
    post-applied decay): rtol 1e-5, atol 1e-6;
  * ``host_batches`` bit for bit.

The Triton kernel itself is held against its plain version on the card
by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.data.lm_pipeline import host_batches as jax_host_batches
from repro.kernels import ref
from repro.models import lm as jax_lm
from repro.optim import optimizers as jax_opt
from repro.optim import population_adam as jax_population_adam
from repro.pop.agent import LMState as JaxLMState
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.lm_pipeline import host_batches
from repro_torch.kernels.pop_adam import pop_adam, pop_adam_plain
from repro_torch.models import lm
from repro_torch.optim import optimizers as opt
from repro_torch.optim import population_adam
from repro_torch.pop import LMAgent
from repro_torch.tree import flat_buffer, flat_copy, leaves, tree_map
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

SEQ = 32
TOL = dict(rtol=1e-5, atol=1e-6)
UPDATE_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 5e-5


def _configs(arch, **kw):
    jc, tc = jax_get_config(arch), get_config(arch)
    if arch != "rwkv6-test":
        jc, tc = jc.smoke(), tc.smoke()
    return (jc.replace(ssm_chunk=16, use_chunked=False, **kw),
            tc.replace(ssm_chunk=16, **kw))


def _params(tc, seed=1):
    tp = lm.init_params(torch.Generator().manual_seed(seed), tc)
    return tp, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)


def _tokens(tc, shape, seed=2):
    return np.random.default_rng(seed).integers(0, tc.vocab_size, shape,
                                                dtype=np.int32)


def _sorted_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_sorted_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_grads(got, want):
    got, want = _sorted_paths(got), _sorted_paths(want)
    assert list(got) == list(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * np.abs(w).max(), err_msg=path)


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("chunk", [0, 8, 12])
@pytest.mark.parametrize("arch", ["rwkv6-test", "qwen2-0.5b"])
def test_lm_loss_matches_jax(arch, chunk):
    """Chunk 8 divides the 32 tokens and takes the chunked loss; 12 does
    not and takes the whole-sequence one, on both sides."""
    jc, tc = _configs(arch, logits_chunk=chunk)
    tp, jp = _params(tc)
    tokens = _tokens(tc, (2, SEQ))
    jloss, jm = jax_lm.lm_loss(jp, jc, {"tokens": jnp.asarray(tokens)})
    tloss, tm = lm.lm_loss(tp, tc, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tm["ce"].item(), float(jm["ce"]), rtol=1e-5)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0


# ------------------------------------------------------------- gradients
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["rwkv6-test", "qwen2-0.5b", "zamba2-7b"])
def test_lm_grads_match_jax(arch, remat):
    """Every parameter's gradient of ``lm_loss`` (float32 masters, remat
    per layer or per super-block) against ``jax.grad`` of the JAX
    package's, with its ``jax.checkpoint`` on or off alike."""
    jc, tc = _configs(arch, remat=remat)
    tp, jp = _params(tc)
    tokens = _tokens(tc, (2, SEQ))
    want = jax.grad(lambda p: jax_lm.lm_loss(
        p, jc, {"tokens": jnp.asarray(tokens)})[0])(jp)
    grads_of = lm._make_grads_fn(tc, TrainConfig())
    got, loss, _ = grads_of(tp, {"tokens": torch.from_numpy(tokens)})
    assert not loss.requires_grad
    _assert_grads(got, want)


@pytest.mark.parametrize("arch", ["rwkv6-test", "qwen2-0.5b"])
def test_grad_accum_matches_jax(arch):
    """``grad_accum`` 2: two microbatches of 2 sequences, gradients averaged
    in float32, loss and metrics meaned."""
    jc, tc = _configs(arch)
    tp, jp = _params(tc)
    tokens = _tokens(tc, (4, SEQ))
    jg, jloss, jm = jax_lm._make_grads_fn(
        jc, JaxTrainConfig(grad_accum=2))(jp, {"tokens": jnp.asarray(tokens)})
    tg, tloss, tm = lm._make_grads_fn(tc, TrainConfig(grad_accum=2))(
        tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tm["ce"].item(), float(jm["ce"]), rtol=1e-5)
    _assert_grads(tg, jg)


# -------------------------------------------------- the population update
N = 3
TCFG = dict(total_steps=50, warmup_steps=5, lr=1e-3, weight_decay=0.1)


def _hypers():
    return {"lr_scale": np.linspace(0.5, 2.0, N).astype(np.float32),
            "weight_decay": np.linspace(0.01, 0.2, N).astype(np.float32),
            "warmup_frac": np.array([0.01, 0.05, 0.2], np.float32)}


@pytest.mark.parametrize("hypers", [None, "pbt"], ids=["plain", "hypers"])
def test_population_update_matches_jax_over_three_steps(hypers):
    """``make_population_update`` (member gradients in a loop, one
    ``population_adam`` step in place over the flat buffers) against the
    JAX package's (vmapped gradients, its stock Adam per member on the
    CPU), 3 steps with a fresh batch each: per-member steps, losses, the
    first step's moments and every parameter after the third."""
    jc, tc = _configs("rwkv6-test")
    agent = LMAgent(tc, TrainConfig(**TCFG), device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(3), N)
    bases = [flat_buffer(t).data_ptr() for t in
             (state.params, state.opt_state.mu, state.opt_state.nu)]
    jstate = JaxLMState(
        params=jax.tree.map(lambda t: jnp.asarray(t.numpy()), state.params),
        opt_state=jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                               state.opt_state),
        step=jnp.zeros((N,), jnp.int32))
    h = _hypers() if hypers else None
    jh = None if h is None else {k: jnp.asarray(v) for k, v in h.items()}
    th = None if h is None else {k: torch.from_numpy(v) for k, v in h.items()}
    jupdate = jax.jit(jax_lm.make_population_update(
        jc, JaxTrainConfig(**TCFG)))
    tupdate = agent.fused_update()
    for k in range(3):
        tokens = _tokens(tc, (N, 2, SEQ), seed=10 + k)
        jstate, jm = jupdate(jstate, {"tokens": jnp.asarray(tokens)}, jh)
        state, tm = tupdate(state, {"tokens": torch.from_numpy(tokens)}, th)
        np.testing.assert_allclose(tm["loss"].numpy(),
                                   np.asarray(jm["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(tm["step"].numpy(),
                                      np.asarray(jm["step"]))
        if k == 0:
            # the first step's moments are the (clipped) gradients and
            # their squares, scaled: mu and sqrt(nu) at the gradients'
            # tolerance (later steps' gradients are taken at parameters
            # that already differ by rounding)
            _assert_grads(state.opt_state.mu, jstate.opt_state.mu)
            _assert_grads(tree_map(torch.sqrt, state.opt_state.nu),
                          jax.tree.map(jnp.sqrt, jstate.opt_state.nu))
    np.testing.assert_array_equal(state.step.numpy(), [3] * N)
    np.testing.assert_array_equal(state.opt_state.step.numpy(), [3] * N)
    for g, w in zip(leaves(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **UPDATE_TOL)
    # the step wrote the flat buffers in place
    assert [flat_buffer(t).data_ptr() for t in
            (state.params, state.opt_state.mu, state.opt_state.nu)] == bases


def test_member_train_step_matches_jax():
    """One member's stock-AdamW ``make_train_step`` (the sequential arm's
    step), 3 steps with per-member hypers as scalars, on ``rwkv6-test``
    (the JAX package's anchor). Not on qwen2: its key bias's gradient is
    near zero (attention's softmax ignores a shift common to all keys;
    only the rotary embedding breaks that), Adam scales it to a step of
    full size, and its float32 rounding, held by the gradient tests above,
    then shows at 1e-3 of the parameter."""
    jc, tc = _configs("rwkv6-test")
    tp, jp = _params(tc)
    j_init, j_step = jax_lm.make_train_step(jc, JaxTrainConfig(**TCFG))
    t_init, t_step = lm.make_train_step(tc, TrainConfig(**TCFG))
    js, ts = j_init(jp), t_init(tp)
    hyp = {"lr_scale": 2.0, "weight_decay": 0.05, "warmup_frac": 0.01}
    for k in range(3):
        tokens = _tokens(tc, (2, SEQ), seed=20 + k)
        jp, js, jm = jax.jit(j_step)(
            jp, js, {"tokens": jnp.asarray(tokens)}, jnp.int32(k),
            *(jnp.float32(v) for v in hyp.values()))
        tp, ts, tm = t_step(tp, ts, {"tokens": torch.from_numpy(tokens)},
                            torch.tensor(k, dtype=torch.int32),
                            **{n: torch.tensor(v) for n, v in hyp.items()})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
    for g, w in zip(leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **UPDATE_TOL)


# -------------------------------------------------------- the optimizers
def _tree(seed, lead=()):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(lead + (5, 7)).astype(np.float32),
            "b": rng.standard_normal(lead + (7,)).astype(np.float32)}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _close(got, want, tol=TOL):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "keeps"])
def test_clip_by_global_norm_matches_jax(max_norm):
    jt, tt = _both(_tree(0))
    jclipped, jnorm = jax_opt.clip_by_global_norm(jt, max_norm)
    tclipped, tnorm = opt.clip_by_global_norm(tt, max_norm)
    np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(opt.global_norm(tt).item(),
                               float(jax_opt.global_norm(jt)), rtol=1e-6)
    _close(tclipped, jclipped)


@pytest.mark.parametrize("wd, clip, override", [
    (0.1, None, None), (0.0, 1.0, None), (0.1, 0.5, 0.03)],
    ids=["decay", "clip", "decay-clip-override"])
def test_adam_decay_and_clip_match_jax(wd, clip, override):
    """Adam/AdamW with decoupled decay, global-norm clip and a decay given
    at update time, 3 steps with a fresh gradient each."""
    jp, tp = _both(_tree(0))
    ji, ju = jax_opt.adam(3e-3, weight_decay=wd, max_grad_norm=clip)
    ti, tu = opt.adam(3e-3, weight_decay=wd, max_grad_norm=clip)
    js, ts = ji(jp), ti(tp)
    for s in (1, 2, 3):
        jg, tg = _both(_tree(s))
        ju_, js = ju(jg, js, jp, wd_override=override)
        jp = jax_opt.apply_updates(jp, ju_)
        tu_, ts = tu(tg, ts, tp, wd_override=override)
        tp = opt.apply_updates(tp, tu_)
    _close(tp, jp)
    _close(ts.mu, js.mu)
    _close(ts.nu, js.nu)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_jax(momentum):
    jp, tp = _both(_tree(0))
    ji, ju = jax_opt.sgd(0.05, momentum=momentum)
    ti, tu = opt.sgd(0.05, momentum=momentum)
    js, ts = ji(jp), ti(tp)
    for s in (1, 2, 3):
        jg, tg = _both(_tree(s))
        ju_, js = ju(jg, js)
        jp = jax_opt.apply_updates(jp, ju_)
        tu_, ts = tu(tg, ts)
        tp = opt.apply_updates(tp, tu_)
    _close(tp, jp)


@pytest.mark.parametrize("name", ["cosine", "warmup_cosine",
                                  "dynamic_warmup_cosine"])
def test_schedules_match_jax(name):
    steps = np.arange(0, 130, dtype=np.int32)
    if name == "cosine":
        j = jax_opt.cosine_schedule(1e-3, 100)(jnp.asarray(steps))
        t = opt.cosine_schedule(1e-3, 100)(torch.from_numpy(steps))
    elif name == "warmup_cosine":
        j = jax_opt.warmup_cosine(1e-3, 10, 100)(jnp.asarray(steps))
        t = opt.warmup_cosine(1e-3, 10, 100)(torch.from_numpy(steps))
    else:
        # per-member (step, warmup_frac) vectors, as the population uses it
        frac = np.linspace(0.0, 0.3, steps.size).astype(np.float32)
        j = jax_opt.dynamic_warmup_cosine(1e-3, 100)(jnp.asarray(steps),
                                                    jnp.asarray(frac))
        t = opt.dynamic_warmup_cosine(1e-3, 100)(torch.from_numpy(steps),
                                                 torch.from_numpy(frac))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


# ------------------------------------------------------- pop_adam's decay
@pytest.mark.parametrize("n, p", [(1, 7), (3, 129), (3, 4096)])
def test_pop_adam_decay_and_scale_match_jax(n, p):
    """``pop_adam_plain`` with a per-member decay and gradient scale (and
    the wrapper, which takes it on the CPU, in place too) against the JAX
    package's kernel path: the gradients scaled first, the Pallas kernel
    in interpret mode, then ``- lr wd p`` on the old parameters."""
    rng = np.random.default_rng(n * 1000 + p)
    params, grads, mu = (rng.standard_normal((n, p)).astype(np.float32)
                         for _ in range(3))
    nu = rng.random((n, p)).astype(np.float32)
    lr = np.linspace(1e-4, 3e-3, n).astype(np.float32)
    step = np.array([(1, 2, 1000)[i % 3] for i in range(n)], np.int32)
    wd = np.linspace(0.0, 0.3, n).astype(np.float32)
    scale = np.linspace(1.0, 0.2, n).astype(np.float32)

    from repro.kernels.pop_adam import pop_adam as jax_pop_adam
    jp, jm, jv = jax_pop_adam(
        jnp.asarray(params), jnp.asarray(grads * scale[:, None]),
        jnp.asarray(mu), jnp.asarray(nu), jnp.asarray(lr),
        jnp.asarray(step), block=p, interpret=True)
    jp = jp - (jnp.asarray(lr) * jnp.asarray(wd))[:, None] * params
    oracle = ref.pop_adam_ref(
        jnp.asarray(params), jnp.asarray(grads * scale[:, None]),
        jnp.asarray(mu), jnp.asarray(nu), jnp.asarray(lr), jnp.asarray(step))

    t = [torch.from_numpy(a) for a in (params, grads, mu, nu, lr, step)]
    extra = dict(wd=torch.from_numpy(wd), scale=torch.from_numpy(scale))
    got = pop_adam_plain(*t, **extra)
    for g, w in zip(got, (jp, jm, jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(oracle[1]), **TOL)
    before = pop_adam.launches
    copies = [x.clone() for x in t]
    out = pop_adam(*copies, **extra, inplace=True)
    assert pop_adam.launches == before          # the CPU runs no kernel
    assert all(o is c for o, c in zip(out, (copies[0], copies[2],
                                            copies[3])))
    for o, g in zip(out, got):
        assert torch.equal(o, g)


@pytest.mark.parametrize("storage", ["tree", "flat"])
def test_population_adam_decay_and_clip_match_jax(storage):
    """``population_adam(weight_decay, max_grad_norm)`` with per-member lr
    and decay, 3 steps, against the JAX package's kernel path
    (``fused=True``: its clip, the Pallas kernel in interpret mode, its
    post-applied decay): on stacked leaves (copied into (N, P) and
    rebuilt) and on flat buffers (stepped in place)."""
    n = 3
    lr = np.asarray([1e-3, 3e-4, 3e-3], np.float32)
    wd = np.asarray([0.0, 0.1, 0.3], np.float32)
    jp, tp = _both(_tree(0, (n,)))
    ji, ja = jax_population_adam(3e-4, weight_decay=0.1, max_grad_norm=2.0,
                                 fused=True)
    ti, ta = population_adam(3e-4, weight_decay=0.1, max_grad_norm=2.0,
                             flat=storage == "flat")
    if storage == "flat":
        _, tp = flat_copy(tp)
    js, ts = ji(jp), ti(tp)
    for s in (1, 2, 3):
        jg, tg = _both(_tree(s, (n,)))
        if storage == "flat":
            _, tg = flat_copy(tg)
        jp, js = ja(jp, jg, js, lr_override=jnp.asarray(lr),
                    wd_override=jnp.asarray(wd))
        tp2, ts = ta(tp, tg, ts, lr_override=torch.from_numpy(lr),
                     wd_override=torch.from_numpy(wd))
        assert (tp2 is tp) == (storage == "flat")
        tp = tp2
    _close(tp, jp)
    _close(ts.mu, js.mu)
    _close(ts.nu, js.nu)
    np.testing.assert_array_equal(ts.step.numpy(), np.asarray(js.step))
    if storage == "flat":
        assert flat_buffer(ts.mu).shape == (n, 5 * 7 + 7)
    else:
        with pytest.raises(ValueError, match="not views"):
            flat_buffer(ts.mu)


def test_flat_population_adam_refuses_trees_not_in_flat_buffers():
    """``population_adam(flat=True)`` asked to step leaves that are not
    views of one (N, P) buffer raises, where ``flat=False`` copies: the
    in-place form is never taken, or given up, silently."""
    _, tp = _both(_tree(0, (3,)))
    _, tg = _both(_tree(1, (3,)))
    init, apply = population_adam(3e-4, flat=True)
    _, fp = flat_copy(tp)
    state = init(fp)
    with pytest.raises(ValueError, match="not views"):
        apply(tp, tg, state)
    # a tree whose leaves alias one buffer out of flatten order
    buffer, fg = flat_copy(tg)
    swapped = {"w": buffer[:, :35].view(3, 5, 7),
               "b": buffer[:, 7:14]}
    with pytest.raises(ValueError, match="not laid out"):
        apply(fp, swapped, state)
    # the LM update: a population copied out of its buffers is refused
    _, tc = _configs("rwkv6-test")
    agent = LMAgent(tc, TrainConfig(**TCFG), device="cpu")
    lm_state = agent.population_init(torch.Generator().manual_seed(1), 2)
    copied = lm_state._replace(params=tree_map(torch.clone,
                                               lm_state.params))
    with pytest.raises(ValueError, match="not views"):
        agent.fused_update()(copied, {"tokens": torch.from_numpy(
            _tokens(tc, (2, 1, SEQ)))})


def test_population_adam_clip_norm_holds_over_long_rows():
    """The clip's per-member norm over rows of 4M parameters, read off the
    first step's mu (= (1 - b1) scale g), against the norm taken in
    float64: within 1e-6. (``torch.linalg.vector_norm`` on the CPU sums
    such rows 7.5e-5 off, and 0.5% off at 60M.)"""
    rng = np.random.default_rng(4)
    tree = {"w": (rng.standard_normal((2, 4_000_000)) * 1e-3)
            .astype(np.float32),
            "b": rng.standard_normal((2, 3)).astype(np.float32)}
    _, grads = flat_copy({k: torch.from_numpy(v) for k, v in tree.items()})
    _, params = flat_copy(tree_map(torch.zeros_like, grads))
    init, apply = population_adam(1e-3, max_grad_norm=0.5, flat=True)
    _, state = apply(params, grads, init(params))
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).reshape(2, -1).sum(1)
                       for v in tree.values()))
    want = np.minimum(1.0, 0.5 / (norm + 1e-9))
    got = (state.mu["w"][:, :1000] / (0.1 * grads["w"][:, :1000])).double()
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(
        want[:, None], got.shape), rtol=1e-6)


# ------------------------------------------------------------ the data
@pytest.mark.parametrize("vocab, batch, seq, start", [
    (256, 3, 32, 0), (151936, 2, 64, 0), (512, 2, 16, 3)])
def test_host_batches_match_jax_bitwise(vocab, batch, seq, start):
    ours = host_batches(vocab, batch, seq, seed=7, start_step=start)
    theirs = jax_host_batches(vocab, batch, seq, seed=7, start_step=start)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.dtype == b.dtype == np.int32 and a.shape == (batch, seq)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- flat storage and PBT
def test_flat_views_survive_a_pbt_gather():
    """``LMAgent.population_init`` keeps parameters, mu and nu each in one
    (N, P) buffer; PBT's gather writes member ``parents[i]``'s state into
    member i's slot of those buffers, the leaves stay their views, and a
    later update writes through them."""
    _, tc = _configs("rwkv6-test")
    agent = LMAgent(tc, TrainConfig(**TCFG), device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(5), 4)
    trees = lambda s: (s.params, s.opt_state.mu, s.opt_state.nu)
    bases = [flat_buffer(t) for t in trees(state)]
    assert all(b is not None and b.shape == (4, bases[0].shape[1])
               for b in bases)
    update = agent.fused_update()
    state, _ = update(state, {"tokens": torch.from_numpy(
        _tokens(tc, (4, 2, SEQ)))})
    state, _ = update(state, {"tokens": torch.from_numpy(
        _tokens(tc, (4, 2, SEQ), seed=3))})
    before = tree_map(torch.clone, state)
    parents = torch.tensor([2, 2, 0, 3])
    out = agent.gather_members(state, parents)
    assert out is state
    for base, tree in zip(bases, trees(state)):
        assert flat_buffer(tree).data_ptr() == base.data_ptr()
    for got, old in zip(leaves(state), leaves(before)):
        assert torch.equal(got, old[parents])
    for base, old in zip(bases, trees(before)):
        assert torch.equal(base, flat_copy(old)[0][parents])
    # the next update steps the gathered population in its buffers
    state, _ = update(state, {"tokens": torch.from_numpy(
        _tokens(tc, (4, 2, SEQ), seed=4))})
    for base, tree in zip(bases, trees(state)):
        assert flat_buffer(tree).data_ptr() == base.data_ptr()
    assert torch.equal(bases[0], flat_copy(state.params)[0])
    assert state.step.tolist() == [3, 3, 3, 3]
