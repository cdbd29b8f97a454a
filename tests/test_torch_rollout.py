"""The port's acting side against the JAX package's ``repro.rollout`` and
``repro.data``.

* Replay: the population's FIFO ring (one tree, leaves (N, capacity, ...))
  against JAX's per-member ``buffer_add`` under ``vmap``, with wraparound,
  and sampling with the indices JAX's ``buffer_sample`` draws injected:
  both bitwise (copies only).
* ``VecEnv``: the same env states and actions give the same transitions
  and episode statistics across the 200-step time limit (rtol = atol =
  1e-5, fp32 transcendental functions of two libraries); the draws of the
  auto-reset differ by design, so steps after a reset are checked for the
  contract only.
* ``Evaluator``: fitness from the same initial env states and actors
  (rtol = atol = 1e-4: 200 steps of fp32 dynamics with the policy in the
  loop, and two libraries' sin/cos/tanh).
* The can-sample gate is the host's count and matches the device's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.replay_buffer import buffer_add as jax_buffer_add
from repro.data.replay_buffer import buffer_init as jax_buffer_init
from repro.data.replay_buffer import buffer_sample as jax_buffer_sample
from repro.data.experience import transition_spec as jax_transition_spec
from repro.envs import make as jax_make
from repro.rl import td3 as jax_td3
from repro.rollout import Collector as JaxCollector
from repro.rollout import Evaluator as JaxEvaluator
from repro.rollout import VecEnv as JaxVecEnv
from repro.rollout import episode_stats as jax_episode_stats
from repro.rollout.collector import \
    exploration_policy as jax_exploration_policy
from repro_torch.configs.base import PopulationConfig
from repro_torch.convert import from_jax_params
from repro_torch.data.experience import transition_spec
from repro_torch.data.replay_buffer import (buffer_add, buffer_can_sample,
                                            buffer_init, buffer_sample)
from repro_torch.envs import make
from repro_torch.pop import ModuleAgent, make_update
from repro_torch.rl import td3
from repro_torch.rollout import (Collector, Evaluator, RolloutEngine,
                                 VecEnv, VecEnvState, episode_stats,
                                 exploration_policy, reset_stats)
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SPEC = make("pendulum").spec


def _items(n, t, seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, t, 3)).astype(np.float32),
            "action": rng.standard_normal((n, t, 1)).astype(np.float32),
            "reward": rng.standard_normal((n, t)).astype(np.float32),
            "next_obs": rng.standard_normal((n, t, 3)).astype(np.float32),
            "done": (rng.random((n, t)) < 0.3).astype(np.float32),
            "truncated": np.zeros((n, t), np.float32)}


def test_replay_insert_wraparound_and_sample_match_jax():
    n, cap, b = 3, 10, 6
    jbuf = jax.vmap(lambda _: jax_buffer_init(
        cap, jax_transition_spec(jax_make("pendulum").spec)))(jnp.arange(n))
    buf = buffer_init(n, cap, transition_spec(SPEC))
    for i, t in enumerate((4, 4, 5)):          # 13 items: wraps at 10
        items = _items(n, t, seed=i)
        jbuf = jax.vmap(jax_buffer_add)(
            jbuf, {k: jnp.asarray(v) for k, v in items.items()})
        buf = buffer_add(buf, {k: torch.from_numpy(v)
                               for k, v in items.items()})
        np.testing.assert_array_equal(buf.insert_pos.numpy(),
                                      np.asarray(jbuf.insert_pos))
        np.testing.assert_array_equal(buf.total.numpy(),
                                      np.asarray(jbuf.total))
        for k in buf.data:
            np.testing.assert_array_equal(buf.data[k].numpy(),
                                          np.asarray(jbuf.data[k]))
    assert sorted(buf.data) == ["action", "done", "next_obs", "obs",
                                "reward"]
    assert buf.insert_pos.tolist() == [3, 3, 3]

    # JAX's draws: per member randint(key, (B,), 0, min(total, cap))
    keys = jax.random.split(jax.random.PRNGKey(9), 2 * n).reshape(2, n, 2)
    idx = np.stack([[np.asarray(jax.random.randint(
        keys[s, m], (b,), 0, min(13, cap))) for m in range(n)]
        for s in range(2)])
    got = buffer_sample(buf, None, b, 2, idx=torch.from_numpy(idx))
    for s in range(2):
        want = jax.vmap(lambda bb, kk: jax_buffer_sample(bb, kk, b))(
            jbuf, keys[s])
        for k in want:
            assert got[k].shape[:3] == (2, n, b)
            np.testing.assert_array_equal(got[k][s].numpy(),
                                          np.asarray(want[k]))
    assert buffer_can_sample(buf, 13).all() and \
        not buffer_can_sample(buf, 14).any()


def test_replay_sample_draws_in_range_and_refuses_empty():
    n, cap = 2, 16
    buf = buffer_init(n, cap, transition_spec(SPEC))
    with pytest.raises(ValueError, match="empty buffer"):
        buffer_sample(buf, torch.Generator().manual_seed(0), 4)
    with pytest.raises(ValueError, match="empty buffer"):
        buffer_sample(buf, torch.Generator().manual_seed(0), 4, filled=0)
    items = {k: torch.from_numpy(v) for k, v in _items(n, 5, 0).items()}
    items["obs"][:] = torch.arange(5, dtype=torch.float32)[None, :, None]
    buf = buffer_add(buf, items)
    got = buffer_sample(buf, torch.Generator().manual_seed(0), 64, 3,
                        filled=5)
    assert got["obs"].shape == (3, n, 64, 3)
    assert got["obs"].min() >= 0 and got["obs"].max() <= 4


def _jax_pop_vstate(venv, key, n):
    return jax.vmap(venv.reset)(jax.random.split(key, n))


def _port_vstate(jvs):
    """A JAX population VecEnvState (leaves (N, E, ...)) in the port's
    layout; the per-env PRNG key leaf has no counterpart."""
    c = lambda x: torch.from_numpy(np.array(x))
    env_state = {k: c(v) for k, v in jvs.env_state.items() if k != "key"}
    return VecEnvState(env_state, *(c(x) for x in jvs[1:]))


def test_vecenv_matches_jax_across_the_time_limit():
    n, e = 2, 3
    jvenv = JaxVecEnv(jax_make("pendulum"), e)
    jvs = _jax_pop_vstate(jvenv, jax.random.PRNGKey(4), n)
    # start near the time limit so 12 steps cross it
    jvs = jvs._replace(env_state=dict(
        jvs.env_state, t=jnp.full((n, e), 192, jnp.int32)))
    vs = _port_vstate(jvs)
    venv = VecEnv(make("pendulum"), e)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    for step in range(1, 13):
        actions = rng.uniform(-1, 1, (n, e, 1)).astype(np.float32)
        jvs, jtr = jax.vmap(jvenv.step)(jvs, jnp.asarray(actions))
        vs, tr = venv.step(vs, torch.from_numpy(actions), gen)
        if step <= 8:                 # up to and including the truncation
            for k in ("obs", "reward", "next_obs", "done", "truncated"):
                np.testing.assert_allclose(tr[k].numpy(),
                                           np.asarray(jtr[k]), **TOL,
                                           err_msg=f"{k} step {step}")
            got, want = episode_stats(vs), jax_episode_stats(jvs)
            for k in want:
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), **TOL,
                                           err_msg=f"{k} step {step}")
        if step == 8:
            # the 200th step: truncation, not termination, for every env;
            # next_obs is the pre-reset terminal observation
            assert tr["truncated"].eq(1).all() and tr["done"].eq(0).all()
            assert (vs.episode_length == 0).all()
            assert (vs.completed_episodes == 1).all()
            assert not torch.equal(tr["next_obs"], vs.obs)
            assert (vs.env_state["t"] == 0).all()
        if step > 8:
            assert (vs.episode_length == step - 8).all()
    zeroed = reset_stats(vs)
    assert (zeroed.completed_episodes == 0).all()
    assert torch.equal(zeroed.obs, vs.obs)


def _jax_actors(n, hidden=(32, 32)):
    return jax.vmap(lambda k: jax_td3.init(k, 3, 1, hidden=hidden).actor)(
        jax.random.split(jax.random.PRNGKey(2), n))


def test_evaluator_matches_jax_from_the_same_states():
    n, e = 3, 4
    jactors = _jax_actors(n)
    key = jax.random.PRNGKey(11)
    jev = JaxEvaluator(jax_make("pendulum"), jax_td3.policy, num_envs=e)
    want = jev.evaluate(jactors, key)
    # the same initial states JAX's evaluate resets to
    init = _port_vstate(_jax_pop_vstate(jev.venv, key, n))
    ev = Evaluator(make("pendulum"), lambda a, o: td3.pop_policy(a, o),
                   num_envs=e)
    got = ev.evaluate(from_jax_params(jactors),
                      torch.Generator().manual_seed(0), init_state=init)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # fresh states from the generator: deterministic given its seed
    a = ev.evaluate(from_jax_params(jactors),
                    torch.Generator().manual_seed(5))
    b = ev.evaluate(from_jax_params(jactors),
                    torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


def test_collector_uses_member_noise_and_flattens_time_major():
    n, e, t = 2, 3, 4
    actors = from_jax_params(_jax_actors(n))
    venv = VecEnv(make("pendulum"), e)
    col = Collector(venv, exploration_policy(td3))
    vs = col.init(torch.Generator().manual_seed(0), n)
    hypers = {"explore_noise": torch.tensor([0.0, 0.5]),
              "noise": torch.tensor([0.9, 0.9])}
    vs2, traj = col.collect(actors, vs, torch.Generator().manual_seed(1), t,
                            hypers)
    assert traj["obs"].shape == (n, t * e, 3)
    assert traj["action"].shape == (n, t * e, 1)
    # member 0 acts deterministically (explore_noise 0 wins over noise)
    np.testing.assert_array_equal(traj["obs"][:, :e].numpy(),
                                  vs.obs.numpy())
    det = td3.pop_policy(actors, vs.obs)
    np.testing.assert_allclose(traj["action"][0, :e].numpy(),
                               det[0].numpy(), rtol=0, atol=0)
    assert not torch.allclose(traj["action"][1, :e], det[1])
    assert (vs2.episode_length == t).all()

    # JAX's collect (flat=True) from the same env states, exploration off
    jvenv = JaxVecEnv(jax_make("pendulum"), e)
    jvs = _jax_pop_vstate(jvenv, jax.random.PRNGKey(3), n)
    off = np.zeros(n, np.float32)
    _, want = JaxCollector(jvenv, jax_exploration_policy(jax_td3)).collect(
        _jax_actors(n), jvs, jax.random.PRNGKey(5), t,
        {"explore_noise": jnp.asarray(off)})
    _, got = col.collect(actors, _port_vstate(jvs),
                         torch.Generator().manual_seed(1), t,
                         {"explore_noise": torch.from_numpy(off)})
    for k in ("obs", "action", "reward", "next_obs", "done", "truncated"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


def test_engine_gate_is_the_host_count():
    """collect 4 x 2 envs = 8 transitions per iteration with a batch of 20:
    the first two iterations only collect, the host's count equals the
    device's, and the updates then run on every iteration."""
    n = 2
    agent = ModuleAgent(td3, 3, 1, device="cpu")
    pcfg = PopulationConfig(size=n, num_steps=2)
    gen = torch.Generator().manual_seed(0)
    state = agent.population_init(torch.Generator().manual_seed(0), n)
    eng = RolloutEngine(agent, pcfg, make("pendulum"),
                        update=make_update(agent, num_steps=2), generator=gen,
                        init_state=state, num_envs=2, collect_steps=4,
                        batch_size=20, buffer_capacity=64)
    assert [eng.can_sample(i) for i in range(5)] == [False, False, False,
                                                     True, True]
    dids = []
    for i in range(4):
        state, metrics, stats, did = eng.iterate(state, None, gen)
        dids.append(did)
        assert (metrics is None) == (not did)
        assert eng.bufs.total.tolist() == [eng.filled()] * n
        assert bool(buffer_can_sample(eng.bufs, 20).all()) == did
    assert dids == [False, False, True, True]
    assert state.critic_opt.step.tolist() == [4, 4]
    assert set(metrics) == {"critic_loss", "actor_loss"}
    assert stats["episodes"].shape == (n,)
    assert eng.env_steps_per_iteration == 16
    agent.experience_kind = "episodic"
    with pytest.raises(ValueError, match="unknown experience kind"):
        RolloutEngine(agent, pcfg, make("pendulum"), update=None,
                      generator=gen, init_state=state)
