"""The vector env's whole step on hopper2d in one call
(``repro_torch.kernels.hopper2d.hopper2d_vec_step``, CPU route: the plain
version ``hopper2d_vec_step_plain``) against the generic ``VecEnv.step``
it stands in for, bit for bit, and against the JAX package's
``VecEnv.step`` on hopper2d; the time limit, the reset and the accounting
on a hand-set state; the wrapper's checks; and ``VecEnv`` taking the
route. The CUDA kernel is held to the plain version on the card by
``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import make as jax_make
from repro.rollout.vecenv import VecEnv as JaxVecEnv
from repro.rollout.vecenv import VecEnvState as JaxVecEnvState
from repro_torch.envs import make
from repro_torch.envs.hopper2d import (REST_POS, hopper2d_obs,
                                       hopper2d_vec_step_plain)
from repro_torch.kernels.hopper2d import ACCOUNTS, hopper2d_step, \
    hopper2d_vec_step
from repro_torch.rollout.evaluator import Evaluator
from repro_torch.rollout.vecenv import VecEnv, VecEnvState
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

KEYS = ("pos", "th", "vel", "om")
# the JAX step against the port's plain one: the tolerance at which the
# JAX package holds its own step to the float64 oracle
TOL = dict(rtol=2e-4, atol=2e-4)
N, E = 8, 16


def _spread_start(vs, seed):
    """Start every env somewhere in its episode, so that some reach the
    400-step time limit within a few hundred steps."""
    t = torch.randint(0, 400, vs.obs.shape[:2],
                      generator=torch.Generator().manual_seed(seed),
                      dtype=torch.int32)
    vs.env_state["t"] = t
    return vs


def _draws(rng, num):
    return (rng.random((num, 4, 2), dtype=np.float32),
            rng.random((num, 4), dtype=np.float32))


def _accounts(rng, num):
    return (torch.from_numpy(rng.normal(size=num).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 400, num, dtype=np.int32)),
            torch.from_numpy(rng.integers(0, 9, num, dtype=np.int32)),
            torch.from_numpy(rng.normal(size=num).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 999, num, dtype=np.int32)),
            torch.from_numpy(rng.normal(size=num).astype(np.float32)))


def test_plain_vec_step_equals_generic_vecenv_step():
    """8 x 16 envs for 410 steps from one generator each: the route's
    state and transitions equal the generic path's bit for bit, through
    falls and time limits."""
    env = make("hopper2d")
    routed, generic = VecEnv(env, E), VecEnv(
        dataclasses.replace(env, vec_step=None), E)
    gen_a, gen_b = (torch.Generator().manual_seed(0) for _ in range(2))
    sa = _spread_start(routed.reset(gen_a, N), 2)
    sb = _spread_start(generic.reset(gen_b, N), 2)
    act_gen = torch.Generator().manual_seed(1)
    falls = truncations = 0
    for step in range(410):
        actions = torch.rand((N, E, 3), generator=act_gen) * 0.6 - 0.3
        sa, ta = routed.step(sa, actions, gen_a)
        sb, tb = generic.step(sb, actions, gen_b)
        for x, y in zip(torch.utils._pytree.tree_leaves((sa, ta)),
                        torch.utils._pytree.tree_leaves((sb, tb))):
            assert x.dtype == y.dtype and torch.equal(x, y), step
        falls += int(ta["done"].sum())
        truncations += int(ta["truncated"].sum())
    assert falls > 0 and truncations > 0
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


def _jax_state(pos, th, vel, om, t, accounts, key):
    num = pos.shape[0]
    env_state = {"pos": jnp.asarray(pos), "th": jnp.asarray(th),
                 "vel": jnp.asarray(vel), "om": jnp.asarray(om),
                 "t": jnp.asarray(t), "key": jax.random.split(key, num)}
    obs = hopper2d_obs(*(torch.from_numpy(x) for x in (pos, th, vel, om)))
    return JaxVecEnvState(env_state, jnp.asarray(obs.numpy()),
                          *(jnp.asarray(a.numpy()) for a in accounts))


def test_plain_vec_step_matches_jax_vecenv_step():
    """12 steps of 128 envs, each from the state the port's step left:
    JAX's VecEnv.step on the same state and actions, its reset rows
    rebuilt from the draws the port was given (numpy arrays), at
    rtol = atol = 2e-4; done and truncated exactly."""
    rng = np.random.default_rng(3)
    venv = JaxVecEnv(jax_make("hopper2d"), N * E)
    jstep = jax.jit(venv.step)
    vs = _spread_start(VecEnv(make("hopper2d"), E).reset(
        torch.Generator().manual_seed(4), N), 5)
    state = [vs.env_state[k].reshape((N * E,) + vs.env_state[k].shape[2:])
             for k in (*KEYS, "t")]
    state[0][::7, 0, 1] = 0.5                 # some torsos fallen
    accounts = _accounts(rng, N * E)
    rest = np.asarray(REST_POS, np.float32)
    ends = 0
    for step in range(12):
        action = rng.uniform(-1.2, 1.2, (N * E, 3)).astype(np.float32)
        u_pos, u_th = _draws(rng, N * E)
        out = hopper2d_vec_step_plain(
            *state, torch.from_numpy(action), torch.from_numpy(u_pos),
            torch.from_numpy(u_th), accounts, 400)
        jnew, trans = jstep(_jax_state(
            *(x.numpy() for x in state), accounts,
            jax.random.PRNGKey(step)), jnp.asarray(action))
        done = np.asarray(trans["done"]) + np.asarray(trans["truncated"]) > 0
        np.testing.assert_array_equal(out[8].numpy(), done)
        np.testing.assert_array_equal(out[9].numpy(),
                                      np.asarray(trans["truncated"]) > 0)
        np.testing.assert_array_equal(out[10].numpy(), trans["done"])
        np.testing.assert_array_equal(out[11].numpy(), trans["truncated"])
        fresh = {"pos": rest + (np.float32(-5e-3) + np.float32(1e-2) * u_pos),
                 "th": np.float32(-5e-3) + np.float32(1e-2) * u_th,
                 "vel": np.zeros((N * E, 4, 2), np.float32),
                 "om": np.zeros((N * E, 4), np.float32),
                 "t": np.zeros(N * E, np.int32)}
        for i, k in enumerate((*KEYS, "t")):
            want = np.asarray(jnew.env_state[k]).copy()
            want[done] = fresh[k][done]
            np.testing.assert_allclose(out[i].numpy(), want, **TOL,
                                       err_msg=f"{k} at step {step}")
        want_obs = hopper2d_obs(*(torch.from_numpy(
            np.asarray(jnew.env_state[k]).copy()) for k in KEYS)).numpy()
        want_obs[done] = hopper2d_obs(*(torch.from_numpy(fresh[k])
                                        for k in KEYS)).numpy()[done]
        np.testing.assert_allclose(out[5].numpy(), want_obs, **TOL)
        np.testing.assert_allclose(out[6].numpy(), trans["next_obs"], **TOL)
        np.testing.assert_allclose(out[7].numpy(), trans["reward"], **TOL)
        for got, want in zip(out[12], jnew[2:]):
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        state, accounts = list(out[:5]), out[12]
        ends += int(done.sum())
    assert ends > 0


def test_time_limit_fall_and_accounting_on_a_hand_set_state():
    """Env 0 at t = 399 (timed out), env 1 with its torso at z = 0.5
    (fallen), env 2 running: flags, t, the reset rows, both observations
    and the six accounting tensors."""
    state, _ = make("hopper2d").reset(torch.Generator().manual_seed(0), 3)
    state["t"][:] = torch.tensor([399, 10, 20], dtype=torch.int32)
    state["pos"][1, 0, 1] = 0.5
    u_pos = torch.full((3, 4, 2), 0.5)
    u_th = torch.full((3, 4), 0.25)
    accounts = (torch.tensor([5.0, 2.0, 1.0]),
                torch.tensor([399, 10, 20], dtype=torch.int32),
                torch.tensor([3, 1, 0], dtype=torch.int32),
                torch.tensor([30.0, 4.0, 0.0]),
                torch.tensor([800, 60, 0], dtype=torch.int32),
                torch.tensor([7.0, 6.0, 0.5]))
    (*new, obs, terminal, reward, done, trunc, done_f, trunc_f,
     acc) = hopper2d_vec_step(*(state[k] for k in (*KEYS, "t")),
                              torch.zeros((3, 3)), u_pos, u_th, accounts,
                              400)
    assert done.tolist() == [True, True, False]
    assert trunc.tolist() == [True, False, False]
    assert done_f.tolist() == [0.0, 1.0, 0.0]
    assert trunc_f.tolist() == [1.0, 0.0, 0.0]
    assert new[4].tolist() == [0, 0, 21]
    rest = torch.tensor(REST_POS)
    for i in (0, 1):                           # reset: draws 0.5 / 0.25
        assert torch.equal(new[0][i], rest + (-5e-3 + 1e-2 * u_pos[i]))
        assert torch.equal(new[1][i], -5e-3 + 1e-2 * u_th[i])
        assert not new[2][i].any() and not new[3][i].any()
    assert torch.equal(obs, hopper2d_obs(*new[:4]))
    assert not torch.equal(obs[:2], terminal[:2])
    assert torch.equal(obs[2], terminal[2])
    ret = accounts[0] + reward
    assert acc[0].tolist() == [0.0, 0.0, float(ret[2])]
    assert acc[1].tolist() == [0, 0, 21]
    assert acc[2].tolist() == [4, 2, 0]
    assert acc[3].tolist() == [float(30.0 + ret[0]), float(4.0 + ret[1]),
                               0.0]
    assert acc[4].tolist() == [1200, 71, 0]
    assert acc[5].tolist() == [float(ret[0]), float(ret[1]), 0.5]


def _vec_args(num=5):
    state, _ = make("hopper2d").reset(torch.Generator().manual_seed(0), num)
    return ([state[k] for k in (*KEYS, "t")], torch.zeros((num, 3)),
            torch.rand((num, 4, 2)), torch.rand((num, 4)),
            _accounts(np.random.default_rng(0), num))


def test_wrapper_cpu_route_launches_nothing():
    state, action, u_pos, u_th, accounts = _vec_args()
    before = (hopper2d_step.launches, dict(hopper2d_step.launches_by_route))
    got = hopper2d_vec_step(*state, action, u_pos, u_th, accounts, 400)
    want = hopper2d_vec_step_plain(*state, action, u_pos, u_th, accounts,
                                   400)
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(g, w)
    assert (hopper2d_step.launches,
            hopper2d_step.launches_by_route) == before


@pytest.mark.parametrize("fault", ["action_shape", "draw_shape", "dtype",
                                   "accounts", "device"])
def test_wrapper_refuses(fault):
    """Wrong shapes, dtypes and counts, and a device with no kernel (not
    the CPU, not CUDA), are refused before anything runs."""
    state, action, u_pos, u_th, accounts = _vec_args()
    accounts = list(accounts)
    error, match = ValueError, None
    if fault == "action_shape":
        action, match = torch.zeros((5, 2)), "action must be"
    elif fault == "draw_shape":
        u_th, match = torch.rand((5, 3)), "u_th must be"
    elif fault == "dtype":
        accounts[1] = accounts[1].float()
        error, match = TypeError, "episode_length must be torch.int32"
    elif fault == "accounts":
        accounts, match = accounts[:5], "6 accounting tensors"
    else:
        state, action, u_pos, u_th, accounts = (
            [x.to("meta") for x in state], action.to("meta"),
            u_pos.to("meta"), u_th.to("meta"),
            [a.to("meta") for a in accounts])
        match = "no kernel for device meta"
    with pytest.raises(error, match=match):
        hopper2d_vec_step(*state, action, u_pos, u_th, accounts, 400)


def test_vecenv_and_evaluator_take_the_route():
    """hopper2d's VecEnv.step, and an Evaluator through it, never call the
    env's generic step; every other env has no route."""
    env = make("hopper2d")
    assert env.vec_step is not None
    assert all(make(name).vec_step is None for name in
               ("pendulum", "reacher", "cartpole", "mountain_car",
                "acrobot"))
    assert list(ACCOUNTS) == list(VecEnvState._fields[2:])
    routed = dataclasses.replace(env, step=None)
    venv = VecEnv(routed, 4)
    gen = torch.Generator().manual_seed(0)
    vs = venv.reset(gen, 2)
    vs, trans = venv.step(vs, torch.zeros((2, 4, 3)), gen)
    assert trans["next_obs"].shape == (2, 4, 11)
    assert vs.episode_length.tolist() == [[1] * 4] * 2
    fitness = Evaluator(routed, lambda actors, obs: torch.zeros(
        obs.shape[:2] + (3,)), num_envs=3, num_steps=5).evaluate(
        {"w": torch.zeros((2, 1))}, gen)
    assert fitness.shape == (2,) and torch.isfinite(fitness).all()
