"""The port's hopper2d (``repro_torch.envs.hopper2d``) against the JAX
package's (``repro.envs.hopper2d``) and the float64 numpy integrator of
``tests/test_hopper_env.py``.

The plain step (what the kernel wrapper runs for CPU tensors) starts from
JAX's reset states and must stay within rtol = atol = 2e-4 of JAX's step
and of the oracle over 3 control steps (15 substeps), the tolerance at
which the JAX package holds its own step to the oracle. Then the env
contract: spec, reward, termination, auto-reset, determinism, stability
under random torques, standing under zero action, and a two-iteration
engine run. The CUDA kernel is held to the plain version on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import make as jax_make
from repro.envs.hopper2d import (_H2D, _hopper2d_obs, _hopper2d_reset,
                                 _hopper2d_step)
from repro_torch.configs.base import PopulationConfig
from repro_torch.envs import make
from repro_torch.envs.hopper2d import (H2D, hopper2d_observe,
                                       hopper2d_reset, hopper2d_step_plain)
from repro_torch.kernels.hopper2d import hopper2d_step
from repro_torch.pop import PopTrainer
from repro_torch.rl import make_agent
from repro_torch.tree import leaves
from test_hopper_env import _np_control_step
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
ACTIONS = [np.zeros(3), np.array([0.7, -0.4, 0.9]),
           np.array([-1.0, 1.0, -1.0])]
KEYS = ("pos", "th", "vel", "om")
jax_step = jax.jit(_hopper2d_step)


def _port_state(jstate):
    """A JAX single-env state as a port batch of one."""
    state = {k: torch.from_numpy(np.array(jstate[k]))[None] for k in KEYS}
    state["t"] = torch.from_numpy(np.array(jstate["t"]))[None]
    return state


def _step(state, action):
    out = hopper2d_step_plain(*(state[k] for k in KEYS),
                              torch.as_tensor(action, dtype=torch.float32)
                              .reshape(-1, 3))
    return dict(zip(KEYS, out[:4])), out[4], out[5], out[6]


def test_parameters_are_the_jax_packages():
    assert H2D == _H2D


@pytest.mark.parametrize("action", ACTIONS, ids=["zero", "mixed", "limits"])
def test_plain_step_matches_jax(action):
    jstate, jobs = _hopper2d_reset(jax.random.PRNGKey(3))
    state = _port_state(jstate)
    np.testing.assert_allclose(hopper2d_observe(state)[0].numpy(),
                               np.asarray(jobs), **TOL)
    for step in range(3):
        jstate, jobs, jrew, jterm = jax_step(jstate,
                                             jnp.asarray(action, jnp.float32))
        state, obs, reward, term = _step(state, action)
        for k in KEYS:
            np.testing.assert_allclose(
                state[k][0].numpy(), np.asarray(jstate[k]), **TOL,
                err_msg=f"{k} at control step {step}")
        np.testing.assert_allclose(obs[0].numpy(), np.asarray(jobs), **TOL)
        np.testing.assert_allclose(float(reward[0]), float(jrew), **TOL)
        assert bool(term[0]) == bool(jterm)


@pytest.mark.parametrize("action", ACTIONS, ids=["zero", "mixed", "limits"])
def test_plain_step_matches_float64_oracle(action):
    jstate, _ = _hopper2d_reset(jax.random.PRNGKey(3))
    state = _port_state(jstate)
    ref = [np.asarray(jstate[k], np.float64) for k in KEYS]
    for step in range(3):
        state, _, _, _ = _step(state, action)
        ref = _np_control_step(*ref, action)
        for k, want in zip(KEYS, ref):
            np.testing.assert_allclose(
                state[k][0].numpy(), want, **TOL,
                err_msg=f"{k} diverged at control step {step}")


def test_batched_step_matches_vmapped_jax():
    """16 envs from JAX's resets, actions past the clip: one batched
    plain step against JAX's vmapped one, env for env."""
    jstate, _ = jax.vmap(_hopper2d_reset)(
        jax.random.split(jax.random.PRNGKey(0), 16))
    action = np.random.default_rng(0).uniform(-1.2, 1.2, (16, 3)).astype(
        np.float32)
    want = jax.vmap(_hopper2d_step)(jstate, jnp.asarray(action))
    state = {k: torch.from_numpy(np.array(jstate[k])) for k in KEYS}
    new, obs, reward, term = _step(state, action)
    for k in KEYS:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(want[0][k]),
                                   **TOL, err_msg=k)
    np.testing.assert_allclose(obs.numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(reward.numpy(), np.asarray(want[2]), **TOL)
    np.testing.assert_array_equal(term.numpy(), np.asarray(want[3]))


def test_observation_matches_jax():
    jstate, _ = _hopper2d_reset(jax.random.PRNGKey(1))
    for _ in range(5):
        jstate, *_ = jax_step(jstate, jnp.array([0.3, -0.2, 0.5]))
    got = hopper2d_observe(_port_state(jstate))[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(_hopper2d_obs(jstate)))


def test_reward_is_forward_progress():
    state, _ = hopper2d_reset(torch.Generator().manual_seed(0), 1)
    new, _, reward, _ = _step(state, np.zeros(3))
    fwd = (new["pos"][0, 0, 0] - state["pos"][0, 0, 0]) / (
        H2D["dt"] * H2D["substeps"])
    np.testing.assert_allclose(float(reward[0]), float(fwd) + 1.0,
                               rtol=1e-5)
    _, _, clipped, _ = _step(state, np.full(3, 3.0))
    _, _, at_limit, _ = _step(state, np.ones(3))
    assert float(clipped[0]) == float(at_limit[0])


def test_termination_on_fallen_or_tipped_torso():
    state, _ = hopper2d_reset(torch.Generator().manual_seed(0), 3)
    state["pos"][1, 0, 1] = 0.5
    state["th"][2, 0] = 1.5
    _, _, _, term = _step(state, np.zeros((3, 3)))
    assert term.tolist() == [False, True, True]


def test_registry_spec_shapes_and_reset_ranges():
    env = make("hopper2d")
    assert (env.spec.obs_dim, env.spec.act_dim, env.spec.discrete,
            env.spec.episode_length) == (11, 3, False, 400)
    spec = jax_make("hopper2d").spec
    assert (spec.obs_dim, spec.act_dim, spec.episode_length) == (11, 3, 400)
    state, obs = env.reset(torch.Generator().manual_seed(0), 64)
    assert obs.shape == (64, 11) and state["t"].dtype == torch.int32
    rest = torch.tensor([(-0.0975, 1.21), (-0.0975, 0.785),
                         (-0.0975, 0.31), (0.0, 0.06)])
    assert (state["pos"] - rest).abs().max() <= 5e-3
    assert state["th"].abs().max() <= 5e-3
    assert not state["vel"].any() and not state["om"].any()
    state, obs, reward, done, trunc = env.step(
        state, torch.zeros((64, 3)), torch.Generator().manual_seed(1))
    assert obs.shape == (64, 11) and reward.shape == done.shape == (64,)


def test_time_limit_truncates_and_auto_resets():
    env = make("hopper2d")
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset(gen, 3)
    state["t"][:2] = 399
    state["pos"][0, 0, 1] = 0.5               # env 0 also falls
    new, obs, _, done, trunc = env.step(state, torch.zeros((3, 3)), gen)
    assert done.tolist() == [True, True, False]
    assert trunc.tolist() == [False, True, False]
    assert new["t"].tolist() == [0, 0, 1]
    assert not torch.equal(obs[:2], env.observe(new)[:2])
    torch.testing.assert_close(obs[2:], env.observe(new)[2:])


def test_determinism():
    env = make("hopper2d")
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        state, obs = env.reset(gen, 4)
        for i in range(10):
            action = torch.sin(torch.arange(3.0) + i).expand(4, 3)
            state, obs, reward, _, _ = env.step(state, action, gen)
        outs.append((obs, reward))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_stability_under_random_torques():
    """200 random-torque control steps over 32 envs stay finite and bounded
    (no spring blow-up); the auto-reset keeps episodes going."""
    env = make("hopper2d")
    gen = torch.Generator().manual_seed(2)
    state, obs = env.reset(gen, 32)
    worst = 0.0
    for _ in range(200):
        action = torch.rand((32, 3), generator=gen) * 2 - 1
        state, obs, reward, _, _ = env.step(state, action, gen)
        assert torch.isfinite(obs).all() and torch.isfinite(reward).all()
        worst = max(worst, float(obs.abs().max()))
    assert worst < 100.0


def test_stands_under_zero_action():
    """Zero torques for 300 control steps from the JAX package's test's
    reset state (key 11), with its checks: the torso height of the state
    after every step (the auto-reset's, where an episode ended) stays
    above the termination height and below launch height, and the bodies'
    velocities stay small. Both packages end that episode at step 135."""
    env = make("hopper2d")
    gen = torch.Generator().manual_seed(11)
    state = _port_state(_hopper2d_reset(jax.random.PRNGKey(11))[0])
    heights = []
    for _ in range(300):
        state, _, _, _, _ = env.step(state, torch.zeros((1, 3)), gen)
        heights.append(state["pos"][:, 0, 1])
    z = torch.stack(heights)
    assert z.min() > H2D["z_min"] and z.max() < 1.4
    assert state["vel"].abs().max() < 5.0


def test_kernel_wrapper_checks_and_cpu_route():
    """The wrapper takes CPU tensors to the plain version (no launch) and
    refuses wrong shapes and types before any kernel."""
    state, _ = hopper2d_reset(torch.Generator().manual_seed(0), 5)
    args = [state[k] for k in KEYS]
    before = hopper2d_step.launches
    got = hopper2d_step(*args, torch.zeros((5, 3)))
    want = hopper2d_step_plain(*args, torch.zeros((5, 3)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert hopper2d_step.launches == before
    with pytest.raises(ValueError, match="action must be"):
        hopper2d_step(*args, torch.zeros((5, 2)))
    with pytest.raises(TypeError, match="float32"):
        hopper2d_step(*args, torch.zeros((5, 3), dtype=torch.float64))


def test_rollout_engine_smoke():
    """Two TD3 iterations on hopper2d through the acting engine give finite
    parameters and metrics."""
    env = make("hopper2d")
    pcfg = PopulationConfig(size=2, strategy="none", num_steps=1)
    tr = PopTrainer(make_agent("td3", env.spec, hidden=(8, 8),
                               device="cpu"), pcfg, seed=0)
    tr.attach_rollout(env, num_envs=2, collect_steps=8, batch_size=16,
                      buffer_capacity=256, eval_envs=1, eval_steps=10)
    for _ in range(2):
        metrics, stats, did = tr.env_iteration()
    assert did and all(torch.isfinite(m).all() for m in metrics.values())
    assert all(torch.isfinite(x).all() for x in leaves(tr.state)
               if x.is_floating_point())
    assert tr.evaluate_fitness().shape == (2,)
