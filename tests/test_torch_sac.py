"""The port's SAC against the JAX package's ``repro.rl.sac``.

The same member-stacked state (JAX-initialised, carried across through
numpy), batches and per-member hypers go through the JAX update and the
port's; the two standard normal draws JAX takes from its key each step
are drawn in the test and passed to the port as ``noise``. Tolerance
rtol = 1e-4, atol = 1e-5 (the JAX package's own for the TD3 comparison:
fp32 sums in another order, carried through Adam). Small widths: hidden
(32, 32), N = 3, B = 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.population import member as jax_member
from repro.core.population import population_init as jax_population_init
from repro.core.vectorize import chain_steps as jax_chain_steps
from repro.envs import make as jax_make
from repro.rl import make_agent as jax_make_agent
from repro.rl import networks as jax_nets
from repro.rl import sac as jax_sac
from repro.rl.fused import pop_split
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import PolicyForward as JaxForward
from repro.serve import make_serving_set as jax_make_serving_set
from repro_torch.convert import from_jax_params
from repro_torch.core.population import member
from repro_torch.core.vectorize import chain_steps
from repro_torch.envs import make
from repro_torch.optim import AdamState
from repro_torch.pop import make_update
from repro_torch.rl import make_agent
from repro_torch.rl import networks as nets
from repro_torch.rl import sac
from repro_torch.serve import BatchServer, PolicyForward, make_serving_set
from repro_torch.tree import leaves, tree_map
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401
from test_torch_train import train_then_serve

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

N, B, OBS, ACT, HIDDEN = 3, 8, 3, 2, (32, 32)
TOL = dict(rtol=1e-4, atol=1e-5)
HYPERS = {"actor_lr": [1e-3, 3e-4, 5e-4], "critic_lr": [3e-4, 1e-3, 2e-4],
          "alpha_lr": [1e-3, 3e-4, 3e-3],
          "target_entropy_scale": [1.0, 0.5, 2.0],
          "reward_scale": [1.0, 2.0, 0.5], "discount": [0.99, 0.95, 0.9]}


def _jax_state():
    return jax_population_init(
        lambda k: jax_sac.init(k, OBS, ACT, hidden=HIDDEN),
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


def _hypers(i=None):
    h = {k: np.asarray(v, np.float32) for k, v in HYPERS.items()}
    return h if i is None else {k: v[i] for k, v in h.items()}


def _port_state(js):
    c = from_jax_params
    opt = lambda o: AdamState(step=c(o.step), mu=c(o.mu), nu=c(o.nu))
    return sac.SACState(actor=c(js.actor), critic=c(js.critic),
                        target_critic=c(js.target_critic),
                        log_alpha=c(js.log_alpha),
                        actor_opt=opt(js.actor_opt),
                        critic_opt=opt(js.critic_opt),
                        alpha_opt=opt(js.alpha_opt), step=c(js.step))


def _jax_noise(key, k):
    """The (N, 2, B, act) draws of each of k chained JAX population steps,
    from their key chain: (k, N, 2, B, act)."""
    draw = jax.vmap(lambda kk: jax.random.normal(kk, (B, ACT)))
    out = []
    for _ in range(k):
        key, k1, k2 = pop_split(key, 3)
        out.append(np.stack([np.asarray(draw(k1)), np.asarray(draw(k2))],
                            axis=1))
    return np.stack(out)


def _assert_state_close(port, js):
    for f in sac.SACState._fields:
        got, want = leaves(getattr(port, f)), jax.tree.leaves(getattr(js, f))
        assert len(got) == len(want), f
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=f)


def _assert_metrics_close(m, jm):
    assert sorted(m) == sorted(jm) == ["actor_loss", "alpha", "critic_loss"]
    for name in m:
        np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                   **TOL, err_msg=name)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_gaussian_head_and_sample_squashed_match_jax():
    js = _jax_state()
    rng = np.random.default_rng(7)
    obs = rng.standard_normal((N, B, OBS)).astype(np.float32)
    actors = from_jax_params(js.actor)
    mean, log_std = nets.pop_gaussian_actor_apply(actors,
                                                  torch.from_numpy(obs))
    jmean, jlog_std = jax.jit(jax_nets.pop_gaussian_actor_apply)(
        js.actor, jnp.asarray(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(log_std.numpy(), np.asarray(jlog_std), **TOL)

    one = jax_member(js, 1).actor
    m1, l1 = nets.gaussian_actor_apply(member(_port_state(js), 1).actor,
                                       torch.from_numpy(obs[1]))
    np.testing.assert_allclose(m1.numpy(), np.asarray(jmean[1]), **TOL)
    np.testing.assert_allclose(l1.numpy(), np.asarray(jlog_std[1]), **TOL)
    # the clip: a log std pushed past both ends
    big = jnp.asarray(np.array([[0.3, 0.1, -30.0, 5.0]], np.float32))
    want_m, want_l = jnp.split(big, 2, -1)
    got_m, got_l = nets._mean_log_std(torch.from_numpy(np.array(big)))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_l.numpy(), [[-20.0, 2.0]])

    key = jax.random.PRNGKey(11)
    eps = np.asarray(jax.random.normal(key, jmean[1].shape))
    ja, jlogp = jax.jit(jax_nets.sample_squashed)(key, jmean[1],
                                                  jlog_std[1])
    a, logp = nets.sample_squashed(torch.from_numpy(eps), m1, l1)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), **TOL)
    # the deterministic policy: tanh of the mean, one member and all
    np.testing.assert_allclose(
        sac.policy(member(_port_state(js), 1).actor,
                   torch.from_numpy(obs[1])).numpy(),
        np.asarray(jax.jit(jax_sac.policy)(one, jnp.asarray(obs[1]))),
        **TOL)
    np.testing.assert_allclose(
        sac.pop_policy(actors, torch.from_numpy(obs)).numpy(),
        np.tanh(np.asarray(jmean)), **TOL)


def test_member_update_matches_jax():
    """One member's stock update (plain layers, stock Adam) against
    ``sac.update``, with the draws of its key split injected."""
    js = jax_member(_jax_state(), 2)
    batch = {k: v[0, 2] for k, v in _batches(1, seed=4).items()}
    hypers = _hypers(2)
    jnew, jm = jax.jit(jax_sac.update)(js, _j(batch), _j(hypers))
    _, k1, k2 = jax.random.split(js.key, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, ACT)))
                      for k in (k1, k2)])
    new, m = sac.update(member(_port_state(_jax_state()), 2), _t(batch),
                        {k: float(v) for k, v in hypers.items()},
                        noise=torch.from_numpy(noise))
    _assert_state_close(new, jnew)
    _assert_metrics_close(m, jm)


@pytest.mark.parametrize("steps", [1, 3])
def test_population_update_matches_jax(steps):
    """``steps`` chained population steps of the port's kernel route
    against JAX's ``make_population_update(fused_linear=True,
    fused=False)``: every field of the state (the three optimizers'
    moments among them) and the per-member metrics."""
    js = _jax_state()
    batches = _batches(steps, seed=steps)
    jupd = jax_chain_steps(
        jax_sac.make_population_update(fused_linear=True, fused=False),
        steps)
    jnew, jm = jupd(js, _j(batches), _j(_hypers()))
    noise = torch.from_numpy(_jax_noise(js.key, steps))

    upd = chain_steps(sac.make_population_update(fused_linear=True), steps)
    new, m = upd(_port_state(js), _t(batches), _t(_hypers()), noise=noise)
    _assert_state_close(new, jnew)
    _assert_metrics_close(m, jm)
    assert new.log_alpha.shape == (N,)
    np.testing.assert_array_equal(new.alpha_opt.step.numpy(), [steps] * N)
    if steps == 1:          # the metric is exp of the NEW log_alpha
        torch.testing.assert_close(m["alpha"], torch.exp(new.log_alpha))


def test_plain_route_matches_kernel_route_and_counts_calls(monkeypatch):
    """One step makes 24 pop_matmul calls and 3 pop_adam calls through the
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
    batch = _t({k: v[0] for k, v in _batches(1).items()})
    noise = torch.from_numpy(_jax_noise(_jax_state().key, 1)[0])
    kern, _ = sac.make_population_update(fused_linear=True)(
        state, batch, None, noise=noise)
    assert calls == {"pop_matmul": 24, "pop_adam": 3}
    ref, _ = sac.make_population_update(fused_linear=False, fused=False)(
        state, batch, None, noise=noise)
    assert calls == {"pop_matmul": 24, "pop_adam": 3}
    for a, b in zip(leaves(kern), leaves(ref)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_steps", [1, 2])
def test_sequential_matches_vectorized(num_steps):
    """The sequential backend (each member's stock update, the noise
    sliced per member) and the vectorized one (the population update)
    agree from the same state, batches, hypers and noise."""
    agent = make_agent("sac", make("pendulum").spec, device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(0), N)
    gen = torch.Generator().manual_seed(1)
    lead = (num_steps, N) if num_steps > 1 else (N,)
    batch = {"obs": torch.randn(lead + (B, 3), generator=gen),
             "action": torch.rand(lead + (B, 1), generator=gen) * 2 - 1,
             "reward": torch.randn(lead + (B,), generator=gen),
             "next_obs": torch.randn(lead + (B, 3), generator=gen),
             "done": (torch.rand(lead + (B,), generator=gen) < 0.2).float()}
    noise = torch.randn(lead + (2, B, 1), generator=gen)
    hypers = _t(_hypers())
    seq, ms = make_update(agent, "sequential", num_steps=num_steps)(
        tree_map(torch.clone, state), batch, hypers, noise=noise)
    vec, mv = make_update(agent, "vectorized", num_steps=num_steps)(
        state, batch, hypers, noise=noise)
    for a, b in zip(leaves(seq), leaves(vec)):
        torch.testing.assert_close(a, b, **TOL)
    for name in mv:
        torch.testing.assert_close(ms[name], mv[name], **TOL)


def test_batch_server_mean_matches_jax():
    """The population-level serve head (tanh of the gaussian's mean, one
    pop_matmul a layer) in ``mean`` mode answers as JAX's server."""
    jagent = jax_make_agent("sac", jax_make("pendulum").spec)
    actors = jagent.actor_params(jagent.population_init(
        jax.random.PRNGKey(0), 4))
    fitness = np.linspace(0.0, 1.0, 4)
    theirs = JaxBatchServer(
        JaxForward.fused_for_agent(jagent), jax_make("pendulum").spec,
        jax_make_serving_set(actors, np.arange(4), step=0, fitness=fitness),
        max_batch=8, mode="mean")
    agent = make_agent("sac", make("pendulum").spec, device="cpu")
    ours = BatchServer(PolicyForward.fused_for_agent(agent),
                       make("pendulum").spec,
                       make_serving_set(from_jax_params(actors),
                                        np.arange(4), step=0,
                                        fitness=fitness),
                       max_batch=8, mode="mean")
    obs = np.random.default_rng(0).standard_normal((11, 3)).astype(
        np.float32)
    got = ours.serve(obs)
    assert got.shape == (11, 1) and np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, theirs.serve(obs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, PolicyForward.for_agent(agent).members(
            ours.set.params, torch.from_numpy(obs)).mean(0).numpy(),
        rtol=1e-5, atol=1e-6)


# (env, strategy, backend, serving mode): both strategies, both backends
_CLI = (("pendulum", "pbt", "vectorized", "mean"),
        ("pendulum", "cem", "sequential", "mean"))


@pytest.mark.parametrize("env, strategy, backend, mode", _CLI,
                         ids=["-".join(c[:3]) for c in _CLI])
def test_train_cli_then_serve_cli(tmp_path, capsys, env, strategy, backend,
                                  mode):
    """SAC through the train CLI (PBT or CEM, either backend) and the
    serve CLI (`mean`) on the checkpoint it wrote, on the CPU."""
    train_then_serve(tmp_path, capsys, "sac", env, strategy, backend,
                     mode)
