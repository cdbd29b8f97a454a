"""The port's on-policy experience pipeline against the JAX package's
(``repro.data.experience``, ``repro.rollout.engine``): GAE with its two
masks and per-member discount and gae_lambda, the trajectory buffer and
its spec filtering, the ops bundle, the collector's recorded extras, and
the engine's epoch minibatches with JAX's permutations injected.

GAE is held at rtol 1e-6 (the same float32 recursion in the same order);
anything that goes through a network at rtol 1e-5, atol 1e-6 (float32
sums in another order). Small sizes: hidden (32, 32) where a test builds
its own network, N = 3, T = 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import compute_gae as jax_compute_gae
from repro.data import experience_ops as jax_experience_ops
from repro.data import traj_add as jax_traj_add
from repro.data import traj_full as jax_traj_full
from repro.data import traj_init as jax_traj_init
from repro.data import traj_reset as jax_traj_reset
from repro.data import trajectory_spec as jax_trajectory_spec
from repro.data.experience import TrajectoryBuffer as JaxTrajectoryBuffer
from repro.envs import make as jax_make
from repro.rl import ppo as jax_ppo
from repro.rollout.engine import RolloutEngine as JaxRolloutEngine
from repro_torch.configs.base import PopulationConfig
from repro_torch.data import (compute_gae, experience_ops, traj_add,
                              traj_full, traj_init, traj_reset,
                              trajectory_spec)
from repro_torch.envs import make
from repro_torch.pop import PopTrainer, PPOAgent, SharedCriticAgent
from repro_torch.rl import get_algo, ppo
from repro_torch.rollout import RolloutEngine
from repro_torch.tree import leaves
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

GAE_TOL = dict(rtol=1e-6, atol=1e-6)
NET_TOL = dict(rtol=1e-5, atol=1e-6)
DISCOUNT = [0.95, 0.99, 0.9]
LAMBDA = [0.9, 0.95, 1.0]

# the hand-built rollout of tests/test_experience_ppo.py: a true
# termination at t=2 (no bootstrap, chain cut), a time-limit truncation
# at t=5 (bootstrap from the pre-reset next value, chain still cut) and an
# unfinished episode at the rollout's edge (bootstrap from nv[-1])
R = [1.0, -0.5, 2.0, 0.3, 0.1, 1.5, -1.0, 0.7]
V = [0.2, 0.4, -0.1, 0.8, 0.5, 0.3, 0.6, -0.2]
NV = [0.4, -0.1, 9.9, 0.5, 0.3, 1.7, -0.2, 0.9]
DONE = [0, 0, 1, 0, 0, 0, 0, 0]
TRUNC = [0, 0, 0, 0, 0, 1, 0, 0]


def _gae_ref(r, v, nv, done, ep_end, gamma, lam):
    """Pure-Python GAE on 1-D arrays (the textbook backward recursion)."""
    adv = np.zeros(len(r))
    last = 0.0
    for t in reversed(range(len(r))):
        delta = r[t] + gamma * nv[t] * (1 - done[t]) - v[t]
        last = delta + gamma * lam * (1 - ep_end[t]) * last
        adv[t] = last
    return adv, adv + v


def _hand_built():
    """The hand-built rollout for 3 members, 2 envs each: member i's env e
    sees the rewards scaled by (1 + i + e) (N, T, E)."""
    scale = 1.0 + np.arange(3)[:, None, None] + np.arange(2)
    col = lambda x: np.broadcast_to(np.asarray(x, np.float32)[None, :, None],
                                    (3, len(x), 2))
    r = (col(R) * scale).astype(np.float32)
    done, trunc = col(DONE), col(TRUNC)
    return r, col(V), col(NV), done, np.maximum(done, trunc)


def _jax_gae(r, v, nv, done, ep_end, discount, lam):
    fn = jax.jit(jax.vmap(jax_compute_gae))
    adv, ret = fn(*(jnp.asarray(x) for x in (r, v, nv, done, ep_end)),
                  jnp.asarray(discount, jnp.float32),
                  jnp.asarray(lam, jnp.float32))
    return np.asarray(adv), np.asarray(ret)


def _port_gae(r, v, nv, done, ep_end, discount, lam):
    adv, ret = compute_gae(*(torch.from_numpy(np.ascontiguousarray(x))
                             for x in (r, v, nv, done, ep_end)),
                           torch.tensor(discount), torch.tensor(lam))
    return adv.numpy(), ret.numpy()


def test_gae_matches_jax_on_hand_built_episodes():
    """Every boundary case, per-member discount and gae_lambda: the port's
    population-wide GAE equals JAX's vmapped one and the Python
    recursion."""
    inputs = _hand_built()
    adv, ret = _port_gae(*inputs, DISCOUNT, LAMBDA)
    want_adv, want_ret = _jax_gae(*inputs, DISCOUNT, LAMBDA)
    np.testing.assert_allclose(adv, want_adv, **GAE_TOL)
    np.testing.assert_allclose(ret, want_ret, **GAE_TOL)
    r, v, nv, done, ep_end = inputs
    for i in range(3):
        for e in range(2):
            ref = _gae_ref(r[i, :, e], v[i, :, e], nv[i, :, e],
                           done[i, :, e], ep_end[i, :, e], DISCOUNT[i],
                           LAMBDA[i])
            np.testing.assert_allclose(adv[i, :, e], ref[0], rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(ret[i, :, e], ref[1], rtol=1e-5,
                                       atol=1e-6)
    # scalars broadcast over the members as (N,) vectors do
    one, _ = _port_gae(*inputs, 0.95, 0.9)
    same, _ = _port_gae(*inputs, [0.95] * 3, [0.9] * 3)
    np.testing.assert_array_equal(one, same)


def test_gae_masks_cut_the_chain_and_bootstrap_truncations():
    """The termination cuts the chain (what precedes it ignores later
    rewards); the truncated step bootstraps (its next value matters); the
    two masks are not interchangeable."""
    r, v, nv, done, ep_end = _hand_built()
    adv, _ = _port_gae(r, v, nv, done, ep_end, DISCOUNT, LAMBDA)
    r2 = r.copy()
    r2[:, 3:] += 100.0
    adv2, _ = _port_gae(r2, v, nv, done, ep_end, DISCOUNT, LAMBDA)
    np.testing.assert_allclose(adv2[:, :3], adv[:, :3], rtol=1e-6)
    nv3 = nv.copy()
    nv3[:, 5] = 0.0
    adv3, _ = _port_gae(r, v, nv3, done, ep_end, DISCOUNT, LAMBDA)
    assert np.abs(adv3[:, 5] - adv[:, 5]).min() > 1e-3
    # done in place of ep_end lets the chain run through the truncation
    leak, _ = _port_gae(r, v, nv, done, done, DISCOUNT, LAMBDA)
    want, _ = _jax_gae(r, v, nv, done, done, DISCOUNT, LAMBDA)
    np.testing.assert_allclose(leak, want, **GAE_TOL)
    assert np.abs(leak[:, 5] - adv[:, 5]).min() > 1e-3


def _ppo_trainer(env_name, n=3, **kw):
    env = make(env_name)
    agent = PPOAgent(env.spec.obs_dim, env.spec.act_dim,
                     discrete=env.spec.discrete, device="cpu")
    pcfg = PopulationConfig(size=n, strategy="none")
    trainer = PopTrainer(agent, pcfg, seed=3)
    engine = trainer.attach_rollout(env, **kw)
    return trainer, engine


def test_gae_matches_jax_on_collected_cartpole_rollout():
    """GAE over a rollout the port collected (random cartpole terminates
    within 40 steps): the engine's advantages and returns equal JAX's
    ``compute_gae`` fed the stored rewards, values and masks and JAX's
    values of the stored next observations, with each member's own
    discount and gae_lambda."""
    trainer, engine = _ppo_trainer("cartpole", num_envs=2, collect_steps=40,
                                   batch_size=40, epochs=1, eval_envs=1)
    trainer.hypers = {"discount": torch.tensor(DISCOUNT),
                      "gae_lambda": torch.tensor(LAMBDA)}
    actors = trainer.actors
    _, traj = engine.collector.collect(
        actors, engine.vstate, trainer.generator, 40, trainer.hypers,
        flat=False)
    bufs = engine.exp.add(engine.bufs, traj)
    d = {k: v.numpy() for k, v in bufs.data.items()}
    assert d["done"].sum() > 0
    adv, ret = engine.advantages(bufs, actors, trainer.hypers)
    jactors = jax.tree.map(lambda x: jnp.asarray(x.numpy()), actors)
    nv = np.asarray(jax.jit(jax.vmap(jax_ppo.value))(
        jactors, jnp.asarray(d["next_obs"])))
    want_adv, want_ret = _jax_gae(
        d["reward"], d["value"], nv, d["done"],
        np.maximum(d["done"], d["truncated"]), DISCOUNT, LAMBDA)
    np.testing.assert_allclose(adv.numpy(), want_adv, **NET_TOL)
    np.testing.assert_allclose(ret.numpy(), want_ret, **NET_TOL)


def test_trajectory_buffer_mechanics_and_spec_filtering():
    """The port's population buffer against JAX's per-member ``traj_*``
    under ``vmap``: the same adds (an extra key dropped, a wrap past
    capacity), fill positions, ``traj_full`` and ``traj_reset``."""
    jspec = jax_trajectory_spec(jax_make("pendulum").spec)
    spec = trajectory_spec(make("pendulum").spec)
    assert {k: (tuple(s.shape), str(s.dtype)) for k, s in jspec.items()} \
        == {k: (shape, str(dt).replace("torch.", ""))
            for k, (shape, dt) in spec.items()}
    n = 2
    jbuf = jax.vmap(lambda _: jax_traj_init(4, 2, jspec))(jnp.arange(n))
    buf = traj_init(n, 4, 2, spec)
    rng = np.random.default_rng(0)

    def steps(t):
        out = {k: rng.standard_normal((n, t, 2) + shape).astype(np.float32)
               for k, (shape, _) in spec.items()}
        out["bogus_extra"] = np.zeros((n, t, 2), np.float32)
        return out

    for t in (1, 3, 2):                # the last add wraps around
        s = steps(t)
        jbuf = jax.vmap(jax_traj_add)(jbuf, {k: jnp.asarray(v)
                                             for k, v in s.items()})
        buf = traj_add(buf, {k: torch.from_numpy(v) for k, v in s.items()})
        assert "bogus_extra" not in buf.data
        np.testing.assert_array_equal(buf.pos.numpy(), np.asarray(jbuf.pos))
        np.testing.assert_array_equal(traj_full(buf).numpy(),
                                      np.asarray(jax_traj_full(jbuf)))
        for k in spec:
            np.testing.assert_array_equal(buf.data[k].numpy(),
                                          np.asarray(jbuf.data[k]), k)
    assert buf.pos.tolist() == [6, 6] and traj_full(buf).all()
    buf, jbuf = traj_reset(buf), jax.vmap(jax_traj_reset)(jbuf)
    assert buf.pos.tolist() == [0, 0] == np.asarray(jbuf.pos).tolist()
    assert not traj_full(buf).any()


def test_experience_ops_bundles_and_unknown_kind():
    """The two kinds build, fill and gate their population buffers; an
    unknown kind raises JAX's error."""
    spec = make("pendulum").spec
    replay = experience_ops("replay").init(spec, 2, capacity=8)
    assert leaves(replay.data)[0].shape[:2] == (2, 8)
    traj = experience_ops("trajectory")
    buf = traj.init(spec, 2, num_steps=4, num_envs=3)
    assert buf.data["log_prob"].shape == (2, 4, 3)
    assert buf.data["action"].shape == (2, 4, 3, 1)
    assert not traj.ready(buf).any()
    full = {k: torch.ones((2, 4, 3) + tuple(v.shape[3:]), dtype=v.dtype)
            for k, v in buf.data.items()}
    buf = traj.add(traj.add(buf, full), full)   # the store replaces
    assert buf.pos.tolist() == [4, 4] and traj.ready(buf).all()
    for kind in ("replay", "trajectory"):
        assert experience_ops(kind).kind == jax_experience_ops(kind).kind
    with pytest.raises(ValueError) as ours:
        experience_ops("episodic")
    with pytest.raises(ValueError) as theirs:
        jax_experience_ops("episodic")
    assert str(ours.value) == str(theirs.value)
    assert "unknown experience kind" in str(ours.value)


@pytest.mark.parametrize("env_name", ["pendulum", "cartpole"])
def test_collector_records_policy_extras(env_name):
    """The collector stores what ``pop_explore`` emits: log_prob and value
    come back time-major and equal JAX's ``log_prob_entropy`` and
    ``value`` of the stored (obs, action) on the same parameters."""
    n, t, e = 3, 5, 2
    trainer, engine = _ppo_trainer(env_name, num_envs=e, collect_steps=t,
                                   batch_size=t * e, epochs=1, eval_envs=1)
    _, traj = engine.collector.collect(trainer.actors, engine.vstate,
                                       trainer.generator, t, None,
                                       flat=False)
    assert traj["log_prob"].shape == traj["value"].shape == (n, t, e)
    assert traj["truncated"].shape == (n, t, e)
    jactors = jax.tree.map(lambda x: jnp.asarray(x.numpy()), trainer.actors)
    obs = jnp.asarray(traj["obs"].numpy()).reshape(n, t * e, -1)
    act = jnp.asarray(traj["action"].numpy()).reshape((n, t * e)
                                                      + traj["action"].shape[3:])
    logp, _ = jax.jit(jax.vmap(jax_ppo.log_prob_entropy))(jactors, obs, act)
    value = jax.jit(jax.vmap(jax_ppo.value))(jactors, obs)
    np.testing.assert_allclose(traj["log_prob"].reshape(n, -1).numpy(),
                               np.asarray(logp), **NET_TOL)
    np.testing.assert_allclose(traj["value"].reshape(n, -1).numpy(),
                               np.asarray(value), **NET_TOL)


def _jax_rollout_engine(n, t, e, b, epochs):
    """A JAX engine with just the attributes ``population_batches`` reads
    (its fused iteration is never built)."""
    env = jax_make("pendulum")
    from repro.pop import PPOAgent as JaxPPOAgent
    eng = object.__new__(JaxRolloutEngine)
    eng.agent = JaxPPOAgent(env.spec.obs_dim, env.spec.act_dim)
    eng.n, eng.collect_steps, eng.num_envs, eng.batch_size = n, t, e, b
    eng.epochs, eng.num_steps = epochs, epochs * (t * e // b)
    eng._gae_defaults = {"discount": 0.99, "gae_lambda": 0.95}
    return eng


@pytest.mark.parametrize("epochs, batch", [(2, 8), (1, 16)],
                         ids=["K4", "K1"])
def test_population_batches_match_jax(epochs, batch):
    """The engine's GAE and epoch minibatches with JAX's permutations
    injected (per member, per epoch, from the member's key) equal JAX's
    ``population_batches`` on the same rollout and parameters, in the
    chained layout (K, N, B, ...), or (N, B, ...) when K == 1."""
    n, t, e = 3, 8, 2
    trainer, engine = _ppo_trainer("pendulum", num_envs=e, collect_steps=t,
                                   batch_size=batch, epochs=epochs,
                                   eval_envs=1)
    rng = np.random.default_rng(epochs)
    spec = trajectory_spec(make("pendulum").spec)
    data = {k: rng.standard_normal((n, t, e) + shape).astype(np.float32)
            for k, (shape, _) in spec.items()}
    data["done"] = (rng.random((n, t, e)) < 0.15).astype(np.float32)
    data["truncated"] = ((rng.random((n, t, e)) < 0.15)
                         * (1 - data["done"])).astype(np.float32)
    bufs = traj_add(engine.bufs, {k: torch.from_numpy(v)
                                  for k, v in data.items()})
    hypers = {"discount": torch.tensor(DISCOUNT),
              "gae_lambda": torch.tensor(LAMBDA),
              "lr": torch.tensor([1e-3, 3e-4, 1e-4])}

    jeng = _jax_rollout_engine(n, t, e, batch, epochs)
    jbufs = JaxTrajectoryBuffer(
        data={k: jnp.asarray(v) for k, v in data.items()},
        pos=jnp.full((n,), t, jnp.int32))
    jactors = jax.tree.map(lambda x: jnp.asarray(x.numpy()), trainer.actors)
    key = jax.random.PRNGKey(7)
    jhypers = {k: jnp.asarray(v.numpy()) for k, v in hypers.items()}
    want = jax.jit(jeng.population_batches)(jbufs, jactors, jhypers, key)
    perms = np.stack([np.asarray(jax.vmap(
        lambda k: jax.random.permutation(k, t * e))(
            jax.random.split(mk, epochs)))
        for mk in jax.random.split(key, n)])           # (N, epochs, D)
    got = engine.population_batches(bufs, trainer.actors, hypers, None,
                                    perms=torch.from_numpy(perms))
    lead = (engine.num_steps,) if engine.num_steps > 1 else ()
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert tuple(got[k].shape[:len(lead) + 2]) == lead + (n, batch)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **NET_TOL, err_msg=k)
    # drawn from the generator: every member's epochs are permutations
    drawn = engine.population_batches(bufs, trainer.actors, hypers,
                                      torch.Generator().manual_seed(0))
    flat_obs = bufs.data["obs"].flatten(1, 2)
    per_epoch = drawn["obs"].reshape(epochs, -1, n, batch, 3) if lead else \
        drawn["obs"].reshape(1, 1, n, batch, 3)
    for ep in range(epochs):
        for i in range(n):
            seen = per_epoch[ep, :, i].reshape(-1, 3)
            assert torch.equal(seen[torch.argsort(seen[:, 0])],
                               flat_obs[i][torch.argsort(flat_obs[i][:, 0])])


def test_onpolicy_engine_validation():
    """JAX's two refusals: a minibatch size that does not divide the
    rollout (or exceeds it), and a population-level agent."""
    for batch in (7, 32):
        with pytest.raises(ValueError, match="must divide"):
            _ppo_trainer("pendulum", num_envs=2, collect_steps=8,
                         batch_size=batch)
    agent = SharedCriticAgent(3, 1, device="cpu")
    agent.experience_kind = "trajectory"
    pcfg = PopulationConfig(size=2, strategy="none")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="requires per-member agents"):
        RolloutEngine(agent, pcfg, make("pendulum"), update=None,
                      generator=gen,
                      init_state=agent.population_init(gen, 2))


def test_onpolicy_iteration_updates_every_call(monkeypatch):
    """Each iteration collects, runs GAE and K = epochs * minibatches
    chained updates: did_update is True from the first call, each member's
    Adam step counts K an iteration, and the population-batched linears
    are counted: 6 per acting step, 3 for the GAE values and 6 per update
    step (the CPU runs the kernels' plain versions through the same
    wrapper)."""
    import repro_torch.kernels.pop_matmul as pm_mod
    calls = [0]
    fwd = pm_mod._forward

    def counted(*a, **kw):
        calls[0] += 1
        return fwd(*a, **kw)

    monkeypatch.setattr(pm_mod, "_forward", counted)
    t, e, b, epochs = 8, 2, 4, 2
    trainer, engine = _ppo_trainer("pendulum", num_envs=e, collect_steps=t,
                                   batch_size=b, epochs=epochs, eval_envs=1)
    k = epochs * t * e // b
    assert engine.num_steps == k == 8
    assert get_algo("ppo").experience_kind == engine.kind == "trajectory"
    for it in range(2):
        metrics, stats, did = trainer.env_iteration()
        assert did
        assert set(metrics) == {"policy_loss", "value_loss", "entropy",
                                "approx_kl"}
        assert all(v.shape == (3,) and torch.isfinite(v).all()
                   for v in metrics.values())
        assert trainer.state.opt.step.tolist() == [k * (it + 1)] * 3
        assert calls[0] == (it + 1) * (6 * t + 3 + 6 * k)
    assert stats["episodes"].shape == (3,)
    assert ppo.DEFAULT_HYPERS["gae_lambda"] == \
        jax_ppo.DEFAULT_HYPERS["gae_lambda"]
