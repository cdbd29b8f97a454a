"""The port's pendulum against the JAX package's: the same state and
action give the same next observation and reward (rtol = atol = 1e-5,
fp32 transcendental functions of two libraries), resets draw from the
same ranges, and the time-limit wrapper keeps the terminal-observation
contract."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs.core import _pendulum_obs as jax_obs
from repro.envs.core import _pendulum_step as jax_step
from repro_torch.envs import make
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


def test_unported_and_unknown_envs():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        make("cartpole")
    with pytest.raises(ValueError, match="unknown env"):
        make("walker")
