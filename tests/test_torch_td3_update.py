"""The port's population-level TD3 update against the JAX package's.

The same member-stacked state (JAX-initialised, carried across through
numpy), batches and per-member hypers go through JAX's
``make_population_update(fused_linear=True, fused=False)`` and the port's
``make_population_update(fused_linear=True)``; the target-smoothing noise
JAX draws from ``pop_split(state.key)`` is drawn in the test and passed to
the port as ``noise``. Per-member ``policy_freq`` makes the delayed-actor
gate open for different members at different steps, so members' Adam
clocks diverge. Tolerance rtol = 1e-4, atol = 1e-5: the JAX package's own
for this comparison (fp32 sums in another order, carried through Adam).
Small widths: hidden (32, 32), N = 3, B = 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.population import member as jax_member
from repro.core.population import population_init as jax_population_init
from repro.rl import networks as jax_nets
from repro.core.vectorize import chain_steps as jax_chain_steps
from repro.rl import td3 as jax_td3
from repro.rl.fused import pop_split
from repro_torch.convert import from_jax_params
from repro_torch.core.population import (member, population_init,
                                         population_size, stack_members)
from repro_torch.core.vectorize import chain_steps
from repro_torch.optim import AdamState
from repro_torch.rl import networks as nets
from repro_torch.rl import td3
from repro_torch.tree import leaves
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

N, B, OBS, ACT, HIDDEN = 3, 8, 3, 1, (32, 32)
TOL = dict(rtol=1e-4, atol=1e-5)
HYPERS = {"actor_lr": [1e-3, 3e-4, 5e-4], "critic_lr": [3e-4, 1e-3, 2e-4],
          "policy_freq": [0.5, 1.0, 0.3], "noise": [0.2, 0.5, 0.1],
          "discount": [0.99, 0.95, 0.9]}


def _jax_state():
    return jax_population_init(
        lambda k: jax_td3.init(k, OBS, ACT, hidden=HIDDEN),
        jax.random.PRNGKey(3), N)


def _batches(k, seed=0):
    rng = np.random.default_rng(seed)
    shape = (k, N, B)
    return {"obs": rng.standard_normal(shape + (OBS,)).astype(np.float32),
            "action": rng.uniform(-1, 1, shape + (ACT,)).astype(np.float32),
            "reward": rng.standard_normal(shape).astype(np.float32),
            "next_obs": rng.standard_normal(shape + (OBS,)).astype(
                np.float32),
            "done": (rng.random(shape) < 0.2).astype(np.float32)}


def _port_state(js):
    c = from_jax_params
    opt = lambda o: AdamState(step=c(o.step), mu=c(o.mu), nu=c(o.nu))
    return td3.TD3State(actor=c(js.actor), critic=c(js.critic),
                        target_actor=c(js.target_actor),
                        target_critic=c(js.target_critic),
                        actor_opt=opt(js.actor_opt),
                        critic_opt=opt(js.critic_opt), step=c(js.step))


def _jax_noise(key, k):
    """The eps each of k chained JAX steps draws from its key chain."""
    out = []
    for _ in range(k):
        key, kc = pop_split(key)
        out.append(jax.vmap(lambda kk: jax.random.normal(kk, (B, ACT)))(kc))
    return np.stack([np.asarray(e) for e in out])


def _assert_state_close(port, js):
    fields = ("actor", "critic", "target_actor", "target_critic",
              "actor_opt", "critic_opt", "step")
    for f in fields:
        got, want = leaves(getattr(port, f)), jax.tree.leaves(getattr(js, f))
        assert len(got) == len(want), f
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=f)


def test_one_step_matches_jax():
    js = _jax_state()
    batch = {k: v[0] for k, v in _batches(1).items()}
    hypers = {k: np.asarray(v, np.float32) for k, v in HYPERS.items()}
    jnew, jm = jax_td3.make_population_update(fused_linear=True, fused=False)(
        js, {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in hypers.items()})
    noise = _jax_noise(js.key, 1)[0]

    update = td3.make_population_update(fused_linear=True)
    new, m = update(_port_state(js),
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    {k: torch.from_numpy(v) for k, v in hypers.items()},
                    noise=torch.from_numpy(noise))
    _assert_state_close(new, jnew)
    for name in ("critic_loss", "actor_loss"):
        assert m[name].shape == (N,)
        np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                   **TOL)
    # the gate: floor(1 * f) > 0 only for policy_freq 1.0 at step 0
    np.testing.assert_array_equal(new.actor_opt.step.numpy(), [0, 1, 0])
    np.testing.assert_array_equal(new.critic_opt.step.numpy(), [1, 1, 1])


def test_chained_steps_match_jax():
    k = 3
    js = _jax_state()
    batches = _batches(k, seed=1)
    hypers = {key: np.asarray(v, np.float32) for key, v in HYPERS.items()}
    jupd = jax_chain_steps(
        jax_td3.make_population_update(fused_linear=True, fused=False), k)
    jnew, jm = jupd(js, {key: jnp.asarray(v) for key, v in batches.items()},
                    {key: jnp.asarray(v) for key, v in hypers.items()})
    noise = _jax_noise(js.key, k)

    upd = chain_steps(td3.make_population_update(fused_linear=True), k)
    new, m = upd(_port_state(js),
                 {key: torch.from_numpy(v) for key, v in batches.items()},
                 {key: torch.from_numpy(v) for key, v in hypers.items()},
                 noise=torch.from_numpy(noise))
    _assert_state_close(new, jnew)
    for name in ("critic_loss", "actor_loss"):
        np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                   **TOL)
    # members' Adam clocks diverged: f = 0.5 opens at step 2, 0.3 not yet
    np.testing.assert_array_equal(new.actor_opt.step.numpy(), [1, 3, 0])


def test_plain_route_matches_kernel_route_and_counts_calls(monkeypatch):
    """One step makes 24 pop_matmul calls and 2 pop_adam calls through the
    wrappers (the kernels' launches on the card); the plain route makes
    none and gives the same state."""
    import repro_torch.kernels.pop_adam as pa_mod
    import repro_torch.kernels.pop_matmul as pm_mod
    calls = {"pop_matmul": 0, "pop_adam": 0}
    fwd, plain = pm_mod._forward, pa_mod.pop_adam_plain

    def count_mm(*a, **kw):
        calls["pop_matmul"] += 1
        return fwd(*a, **kw)

    def count_adam(*a, **kw):
        calls["pop_adam"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(pm_mod, "_forward", count_mm)
    monkeypatch.setattr(pa_mod, "pop_adam_plain", count_adam)
    state = _port_state(_jax_state())
    batch = {k: torch.from_numpy(v[0]) for k, v in _batches(1).items()}
    noise = torch.zeros((N, B, ACT))
    kern, _ = td3.make_population_update(fused_linear=True)(
        state, batch, None, noise=noise)
    assert calls == {"pop_matmul": 24, "pop_adam": 2}
    ref, _ = td3.make_population_update(fused_linear=False, fused=False)(
        state, batch, None, noise=noise)
    assert calls == {"pop_matmul": 24, "pop_adam": 2}
    for a, b in zip(leaves(kern), leaves(ref)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_update_draws_noise_from_the_generator():
    state = _port_state(_jax_state())
    batch = {k: torch.from_numpy(v[0]) for k, v in _batches(1).items()}
    update = td3.make_population_update(fused_linear=True)
    a, _ = update(state, batch, None, torch.Generator().manual_seed(1))
    b, _ = update(state, batch, None, torch.Generator().manual_seed(1))
    c, _ = update(state, batch, None, torch.Generator().manual_seed(2))
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, y) for x, y in
                   zip(leaves(a.critic), leaves(c.critic)))


def test_state_layout_critic_and_population_helpers_match_jax():
    """``td3.init`` stacked by ``population_init`` has JAX's leaves (shape,
    dtype, order) in every field but the absent ``key``; one member's
    ``critic_apply`` gives JAX's twin Q values; ``member``,
    ``stack_members`` and ``population_size`` act as JAX's."""
    js = _jax_state()
    port = population_init(
        lambda g: td3.init(g, OBS, ACT, hidden=HIDDEN),
        torch.Generator().manual_seed(0), N)
    assert td3.TD3State._fields == jax_td3.TD3State._fields[:-1]
    for f in td3.TD3State._fields:
        got, want = leaves(getattr(port, f)), jax.tree.leaves(getattr(js, f))
        assert [(tuple(g.shape), str(g.dtype).split(".")[-1]) for g in got] \
            == [(w.shape, str(w.dtype)) for w in want], f

    converted = _port_state(js)
    assert population_size(converted) == N
    one = member(converted, 1)
    for g, w in zip(leaves(one), jax.tree.leaves(jax_member(js, 1))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    restacked = stack_members([member(converted, i) for i in range(N)])
    for g, w in zip(leaves(restacked), leaves(converted)):
        assert torch.equal(g, w)

    rng = np.random.default_rng(5)
    obs = rng.standard_normal((B, OBS)).astype(np.float32)
    act = rng.uniform(-1, 1, (B, ACT)).astype(np.float32)
    want = jax_nets.critic_apply(jax_member(js, 1).critic, jnp.asarray(obs),
                                 jnp.asarray(act))
    got = nets.critic_apply(one.critic, torch.from_numpy(obs),
                            torch.from_numpy(act))
    for g, w in zip(got, want):
        assert g.shape == (B,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
