"""The port's envs against the JAX package's: the same state and action
give the same next observation and reward (pendulum: rtol = atol = 1e-5,
fp32 transcendental functions of two libraries, one step; cartpole,
mountain_car and acrobot: rtol = 1e-5, atol = 1e-6 over 10 chained raw
steps, with every termination flag equal), resets draw from the same
ranges, and the time-limit wrapper keeps the terminal-observation
contract."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import core as jax_core
from repro.envs import make as jax_make
from repro.envs.core import _pendulum_obs as jax_obs
from repro.envs.core import _pendulum_step as jax_step
from repro_torch.envs import core, make
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def test_pendulum_step_matches_jax():
    rng = np.random.default_rng(0)
    n = 64
    theta = rng.uniform(-4.0, 4.0, n).astype(np.float32)
    thetadot = rng.uniform(-9.0, 9.0, n).astype(np.float32)
    action = rng.uniform(-1.5, 1.5, (n, 1)).astype(np.float32)
    t = np.zeros(n, np.int32)

    jstate = {"theta": jnp.asarray(theta), "thetadot": jnp.asarray(thetadot),
              "t": jnp.asarray(t),
              "key": jax.random.split(jax.random.PRNGKey(0), n)}
    jnew, jobs, jrew, jdone = jax.vmap(jax_step)(jstate, jnp.asarray(action))

    env = make("pendulum")
    state = {"theta": torch.from_numpy(theta),
             "thetadot": torch.from_numpy(thetadot),
             "t": torch.from_numpy(t)}
    np.testing.assert_allclose(env.observe(state).numpy(),
                               np.asarray(jax.vmap(jax_obs)(jstate)), **TOL)
    new, obs, rew, done, trunc = env.step(state, torch.from_numpy(action),
                                          torch.Generator().manual_seed(0))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), **TOL)
    np.testing.assert_allclose(new["theta"].numpy(),
                               np.asarray(jnew["theta"]), **TOL)
    assert not done.any() and not trunc.any() and not np.asarray(jdone).any()
    assert (new["t"] == 1).all()


def test_pendulum_reset_ranges_and_time_limit():
    env = make("pendulum")
    assert (env.spec.obs_dim, env.spec.act_dim) == (3, 1)
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen, 256)
    assert obs.shape == (256, 3) and obs.dtype == torch.float32
    assert state["theta"].abs().max() <= math.pi
    assert state["thetadot"].abs().max() <= 1.0
    assert (state["t"] == 0).all()

    state["t"][:3] = env.spec.episode_length - 1
    last_obs = env.observe(state)
    new, obs, _, done, trunc = env.step(state, torch.zeros((256, 1)), gen)
    assert done[:3].all() and trunc[:3].all() and not done[3:].any()
    # the step's obs is the pre-reset terminal observation; the state of a
    # finished env restarted
    assert (new["t"][:3] == 0).all() and (new["t"][3:] == 1).all()
    assert not torch.equal(obs[:3], env.observe(new)[:3])
    assert not torch.equal(obs[:3], last_obs[:3])


# start states of the discrete and mountain-car envs: wide enough that
# cartpole fails, mountain_car reaches the goal and hits its left wall,
# and acrobot's angles wrap (and some swing up) within 10 steps
def _cartpole_states(rng, n):
    x = rng.uniform(-0.2, 0.2, (n, 4)).astype(np.float32)
    x[: n // 4, 0] = rng.uniform(-2.45, 2.45, n // 4)
    x[n // 4: n // 2, 2] = rng.uniform(-0.21, 0.21, n // 2 - n // 4)
    return {"x": x}


def _mountain_car_states(rng, n):
    pos = rng.uniform(-1.2, 0.6, n).astype(np.float32)
    vel = rng.uniform(-0.07, 0.07, n).astype(np.float32)
    pos[:8], vel[:8] = -1.19, -0.05        # into the left wall
    pos[8:16], vel[8:16] = 0.44, 0.05      # onto the goal
    return {"pos": pos, "vel": vel}


def _acrobot_states(rng, n):
    q = np.concatenate([rng.uniform(-np.pi, np.pi, (n, 2)),
                        rng.uniform(-12.0, 12.0, (n, 2))], 1)
    return {"q": q.astype(np.float32)}


# name -> (start states, number of discrete actions or None for
# mountain_car's continuous one, the reset's half width around its centre)
CLASSIC = {
    "cartpole": (_cartpole_states, 2, 0.05),
    "mountain_car": (_mountain_car_states, None, 0.1),
    "acrobot": (_acrobot_states, 3, 0.1),
}


@pytest.mark.parametrize("name", sorted(CLASSIC))
def test_raw_steps_match_jax(name):
    states, actions, _ = CLASSIC[name]
    rng = np.random.default_rng(1)
    n, steps = 64, 10
    state = states(rng, n)
    state["t"] = np.zeros(n, np.int32)
    if actions is None:          # mountain_car: continuous, act 1
        acts = rng.uniform(-1.5, 1.5, (steps, n, 1)).astype(np.float32)
    else:
        acts = rng.integers(0, actions, (steps, n)).astype(np.int32)
    jax_step_fn = jax.jit(jax.vmap(getattr(jax_core, f"_{name}_step")))
    step = getattr(core, f"_{name}_step")
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    jstate["key"] = jax.random.split(jax.random.PRNGKey(0), n)
    ended = []
    for i in range(steps):
        # each step from JAX's state: fp32 rounding differences would
        # otherwise grow through the dynamics (acrobot's RK4 doubles them
        # a step at these speeds, in either package against an fp64 run)
        tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()
                  if k != "key"}
        jstate, jobs, jrew, jdone = jax_step_fn(jstate, jnp.asarray(acts[i]))
        new, obs, rew, done = step(tstate, torch.from_numpy(acts[i]))
        for got, want in ((obs, jobs), (rew, jrew)) + tuple(
                (new[k], jstate[k]) for k in new):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        ended.append(done.numpy())
        if name == "mountain_car" and i == 0:
            assert (new["vel"][:8] == 0).all()    # stopped by the wall
    # the checks saw both kinds of step
    assert 0 < np.mean(ended) < 1


@pytest.mark.parametrize("name", sorted(CLASSIC))
def test_reset_ranges_and_auto_reset(name):
    _, _, half_width = CLASSIC[name]
    env, jenv = make(name), jax_make(name)
    assert env.spec == type(env.spec)(**vars(jenv.spec))
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen, 512)
    assert obs.shape == (512, env.spec.obs_dim) and obs.dtype == torch.float32
    if name == "mountain_car":
        box = state["pos"] + 0.5
    else:
        box = state["x" if name == "cartpole" else "q"]
    assert box.abs().max() <= half_width
    assert box.abs().max() > 0.9 * half_width       # the whole range
    # a terminated env and a truncated one restart, the step's obs is the
    # pre-reset terminal observation, and truncation is not termination
    act = (torch.zeros((512,), dtype=torch.int64) if env.spec.discrete
           else torch.zeros((512, 1)))
    if name == "cartpole":
        state["x"][0, 2] = 0.3                     # past the angle limit
    elif name == "mountain_car":
        state["pos"][0], state["vel"][0] = 0.5, 0.05
    else:
        state["q"][0, :2] = torch.tensor([math.pi, 0.0])   # swung up
    state["t"][1] = env.spec.episode_length - 1
    new, obs, _, done, trunc = env.step(state, act, gen)
    assert done[:2].all() and not done[2:].any()
    assert trunc.tolist()[:2] == [False, True]
    assert (new["t"][:2] == 0).all() and (new["t"][2:] == 1).all()
    assert not torch.equal(obs[:2], env.observe(new)[:2])
    torch.testing.assert_close(obs[2:], env.observe(new)[2:])


def test_unported_and_unknown_envs():
    # every env of the JAX registry is ported; hopper2d was the last
    assert make("hopper2d").spec == core.EnvSpec("hopper2d", 11, 3, False,
                                                 400, 1.0)
    with pytest.raises(ValueError, match="unknown env"):
        make("walker")
