"""The port's CEM, DvD and reacher against the JAX package's.

The JAX functions' normal draws are made by the same ``jax.random`` calls
they make and handed to the port as ``eps`` (``cem_sample``) or patched
into the strategy's sampler (``CEM.bind``/``evolve``). Inputs are made
from a seed with numpy. Tolerances: the CEM update and sample at rtol
1e-5, atol 1e-6 (fp32 weighted sums of a few elites, XLA may contract
``mean + sqrt(.) * eps`` into one FMA); the elites' order and the lineage
exactly; ``dvd_loss`` and its gradient at rtol 1e-5, atol 1e-6 (an LU
of a 4x4 matrix in two libraries); reacher at rtol = atol = 1e-5 as the
pendulum's test. Small widths: N = 4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PopulationConfig as JaxPopulationConfig
from repro.core import cem as jax_cem
from repro.core import dvd as jax_dvd
from repro.core import shared as jax_shared
from repro.envs.core import _reacher_obs as jax_reacher_obs
from repro.envs.core import _reacher_step as jax_reacher_step
from repro.pop.agent import SharedCriticAgent as JaxSharedCriticAgent
from repro.pop.strategy import CEM as JaxCEM
from repro_torch.configs.base import PopulationConfig
from repro_torch.convert import from_jax_params
from repro_torch.core import cem, dvd
from repro_torch.core.shared import SharedCriticState
from repro_torch.envs import make
from repro_torch.optim import AdamState
from repro_torch.pop import (CEM, DvD, ModuleAgent, NoEvolution,
                             SharedCriticAgent, make_strategy)
from repro_torch.pop import strategy as strategy_mod
from repro_torch.rl import networks as nets
from repro_torch.rl import td3
from repro_torch.tree import leaves
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

N, OBS, ACT = 4, 3, 2
CEM_TOL = dict(rtol=1e-5, atol=1e-6)
ENV_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _template(rng):
    return {"layer_0": {"b": rng.standard_normal(5).astype(np.float32),
                        "w": rng.standard_normal((3, 5)).astype(np.float32)},
            "layer_1": {"b": rng.standard_normal(2).astype(np.float32),
                        "w": rng.standard_normal((5, 2)).astype(np.float32)}}


def test_cem_init_sample_update_match_jax():
    rng = np.random.default_rng(0)
    tmpl = _template(rng)
    jstate, junravel = jax_cem.cem_init(
        jax.tree.map(jnp.asarray, tmpl), sigma_init=0.05, noise_init=0.02)
    state, unravel = cem.cem_init(from_jax_params(tmpl), sigma_init=0.05,
                                  noise_init=0.02)
    # the flat vector is ravel_pytree's: sorted keys, row-major leaves
    np.testing.assert_array_equal(state.mean.numpy(), _np(jstate.mean))
    np.testing.assert_array_equal(state.var.numpy(), _np(jstate.var))
    assert float(state.noise) == pytest.approx(float(jstate.noise))

    key = jax.random.PRNGKey(1)
    jsamples = jax_cem.cem_sample(key, jstate, 6)
    eps = jax.random.normal(key, (6,) + jstate.mean.shape)
    samples = cem.cem_sample(None, state, 6, eps=_t(eps))
    np.testing.assert_allclose(samples.numpy(), _np(jsamples), **CEM_TOL)
    # the noise is added to the variance, not to the standard deviation
    np.testing.assert_allclose(
        samples.numpy(), _np(jstate.mean) + np.sqrt(0.05 + 0.02) * _np(eps),
        **CEM_TOL)

    # a fitness tie at the elite cut and inside the elites: the stable
    # sort keeps member order, as jnp.argsort does
    fitness = np.asarray([3.0, 1.0, 3.0, 0.5, 1.0, 3.0], np.float32)
    jnew = jax_cem.cem_update(jstate, jsamples, jnp.asarray(fitness),
                              elite_frac=0.5, noise_decay=0.9)
    new = cem.cem_update(state, samples, _t(fitness), elite_frac=0.5,
                         noise_decay=0.9)
    np.testing.assert_allclose(new.mean.numpy(), _np(jnew.mean), **CEM_TOL)
    np.testing.assert_allclose(new.var.numpy(), _np(jnew.var), **CEM_TOL)
    np.testing.assert_allclose(float(new.noise), float(jnew.noise),
                               rtol=1e-6)
    # the elites are members 0, 2, 5 in that order, weighted by reversed
    # log-ranks; the variance is about the OLD mean
    k = 3
    w = np.log(1 + k) - np.log(np.arange(1, k + 1))
    w = (w / w.sum())[::-1]
    elites = samples.numpy()[[0, 2, 5]]
    np.testing.assert_allclose(new.mean.numpy(), w @ elites, **CEM_TOL)
    np.testing.assert_allclose(
        new.var.numpy(), w @ (elites - state.mean.numpy()) ** 2, **CEM_TOL)

    # unravel gives the member-stacked tree of the JAX unravel
    mats = unravel(samples)
    for i in range(6):
        want = junravel(jsamples[i])
        for got, exp in zip(leaves(mats), jax.tree.leaves(want)):
            np.testing.assert_allclose(got[i].numpy(), _np(exp), **CEM_TOL)
    assert cem.ravel_stacked(mats).shape == (6, state.mean.shape[0])
    np.testing.assert_array_equal(cem.ravel_stacked(mats).numpy(),
                                  samples.numpy())


def test_cem_sample_draws_from_the_generator():
    state, _ = cem.cem_init({"w": torch.zeros(7)}, sigma_init=1.0)
    a = cem.cem_sample(torch.Generator().manual_seed(3), state, 4)
    b = cem.cem_sample(torch.Generator().manual_seed(3), state, 4)
    assert a.shape == (4, 7) and torch.equal(a, b)


def test_dvd_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((N, 12)).astype(np.float32)
    jl, jg = jax.value_and_grad(jax_dvd.dvd_loss)(jnp.asarray(emb))
    x = torch.from_numpy(emb).requires_grad_(True)
    loss = dvd.dvd_loss(x)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **CEM_TOL)
    np.testing.assert_allclose(x.grad.numpy(), _np(jg), **CEM_TOL)
    # a diverse population has the smaller loss
    assert float(dvd.dvd_loss(torch.ones((N, 12)))) > float(loss.detach())


@pytest.mark.parametrize("period", [4, 400])
def test_dvd_coef_schedule_matches_jax_across_a_boundary(period):
    half = period // 2
    steps = [0, 1, half - 1, half, half + 1, period - 1, period,
             period + half, 3 * period + half - 1]
    got = dvd.dvd_coef_schedule(torch.tensor(steps, dtype=torch.int32),
                                period=period)
    want = jax_dvd.dvd_coef_schedule(jnp.asarray(steps, jnp.int32),
                                     period=period)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    # lo for the first period // 2 steps, hi from there
    assert float(dvd.dvd_coef_schedule(half - 1, period=period)) == 0.0
    assert float(dvd.dvd_coef_schedule(half, period=period)) == 0.5


def test_pop_behavior_embedding_is_the_per_member_embedding():
    agent = SharedCriticAgent(OBS, ACT, device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(0), N)
    probe = torch.randn((7, OBS), generator=torch.Generator().manual_seed(1))
    emb = dvd.pop_behavior_embedding(state.policies, probe)
    want = dvd.behavior_embedding(nets.actor_apply, state.policies, probe)
    assert emb.shape == (N, 7 * ACT)
    torch.testing.assert_close(emb, want, rtol=1e-5, atol=1e-6)


def _port_shared(js):
    c = from_jax_params
    opt = lambda o: AdamState(step=c(o.step), mu=c(o.mu), nu=c(o.nu))
    return SharedCriticState(
        policies=c(js.policies), critic=c(js.critic),
        target_policies=c(js.target_policies),
        target_critic=c(js.target_critic), policy_opt=opt(js.policy_opt),
        critic_opt=opt(js.critic_opt), step=c(js.step))


def _assert_tree_close(got, want, **tol):
    got, want = leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **tol)


def test_cem_strategy_on_the_shared_critic_matches_jax(monkeypatch):
    js = jax_shared.init(jax.random.PRNGKey(0), OBS, ACT, N)
    jcfg = JaxPopulationConfig(size=N, strategy="cem", sigma_init=0.02,
                               cem_noise_init=0.01, cem_noise_decay=0.9)
    jstrat, jagent = JaxCEM(jcfg), JaxSharedCriticAgent(OBS, ACT)
    k_bind, k_evolve = jax.random.split(jax.random.PRNGKey(5))
    jbound = jstrat.bind(k_bind, jagent, js)
    fitness = np.asarray([2.0, -1.0, 2.0, 0.5], np.float32)   # a tie
    jnew, jh, jlineage = jstrat.evolve(k_evolve, jbound, None,
                                       jnp.asarray(fitness))
    p = jstrat.cem_state.mean.shape[0]
    draws = iter([jax.random.normal(k, (N, p)) for k in (k_bind, k_evolve)])
    real = strategy_mod.cem_sample
    monkeypatch.setattr(strategy_mod, "cem_sample",
                        lambda g, s, n: real(g, s, n, eps=_t(next(draws))))

    cfg = PopulationConfig(size=N, strategy="cem", sigma_init=0.02,
                           cem_noise_init=0.01, cem_noise_decay=0.9)
    strat = make_strategy(cfg)
    assert isinstance(strat, CEM)
    state = _port_shared(js)
    agent = SharedCriticAgent(OBS, ACT, device="cpu")
    bound = strat.bind(None, agent, state)
    _assert_tree_close(bound.policies, jbound.policies, **CEM_TOL)
    # a redraw replaces the targets too; the critic and Adam state stay
    _assert_tree_close(bound.target_policies, jbound.policies, **CEM_TOL)
    for f in ("critic", "target_critic", "policy_opt", "critic_opt"):
        for g, w in zip(leaves(getattr(bound, f)), leaves(getattr(state, f))):
            assert torch.equal(g, w), f

    new, h, lineage = strat.evolve(None, bound, None, _t(fitness))
    assert h is None and jh is None
    assert lineage.tolist() == _np(jlineage).tolist() == [-1] * N
    _assert_tree_close(new.policies, jnew.policies, **CEM_TOL)
    _assert_tree_close(new.target_policies, jnew.target_policies, **CEM_TOL)
    exported = strat.export_state()
    for g, w in zip(exported, jstrat.export_state()):
        np.testing.assert_allclose(g.numpy(), _np(w), **CEM_TOL)
    # the noise decays by cem_noise_decay an evolve
    assert float(exported.noise) == pytest.approx(0.01 * 0.9, rel=1e-6)
    strat.import_state(tuple(exported))
    assert isinstance(strat.cem_state, cem.CEMState)


def test_cem_over_td3_actors_replaces_actor_and_target():
    agent = ModuleAgent(td3, OBS, ACT, device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(0), N)
    strat = CEM(PopulationConfig(size=N, strategy="cem"))
    gen = torch.Generator().manual_seed(1)
    bound = strat.bind(gen, agent, state)
    assert not torch.equal(bound.actor["layer_0"]["w"],
                           state.actor["layer_0"]["w"])
    for a, t in zip(leaves(bound.actor), leaves(bound.target_actor)):
        assert torch.equal(a, t) and a.data_ptr() != t.data_ptr()
    for g, w in zip(leaves(bound.critic), leaves(state.critic)):
        assert torch.equal(g, w)
    _, _, lineage = strat.evolve(gen, bound, None,
                                 torch.arange(N, dtype=torch.float32))
    assert lineage.tolist() == [-1] * N


def test_dvd_strategy_installs_the_schedule_and_evolves_as_identity():
    strat = make_strategy(PopulationConfig(size=N, strategy="dvd",
                                           dvd_period=40))
    assert isinstance(strat, DvD)
    agent = SharedCriticAgent(OBS, ACT, device="cpu")
    strat.configure_agent(agent)
    assert float(agent.dvd_coef_fn(torch.tensor(19))) == 0.0
    assert float(agent.dvd_coef_fn(torch.tensor(20))) == 0.5
    # an agent's own coefficient is kept
    mine = SharedCriticAgent(OBS, ACT, dvd_coef_fn=lambda s: 0.1,
                             device="cpu")
    strat.configure_agent(mine)
    assert mine.dvd_coef_fn(0) == 0.1
    state = {"x": torch.arange(N)}
    same, h, lineage = strat.evolve(None, state, None, torch.zeros(N))
    assert same is state and h is None
    assert lineage.tolist() == list(range(N))
    assert isinstance(make_strategy(PopulationConfig(size=1,
                                                     strategy="cem")),
                      NoEvolution)


def test_reacher_reset_and_step_match_jax():
    env = make("reacher")
    assert (env.spec.obs_dim, env.spec.act_dim, env.spec.episode_length) \
        == (6, 2, 100)
    rng = np.random.default_rng(3)
    n = 64
    pos = rng.uniform(-2.5, 2.5, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    target = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    action = rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    t = np.zeros(n, np.int32)
    jstate = {"pos": jnp.asarray(pos), "vel": jnp.asarray(vel),
              "target": jnp.asarray(target), "t": jnp.asarray(t),
              "key": jax.random.split(jax.random.PRNGKey(0), n)}
    jnew, jobs, jrew, jdone = jax.vmap(jax_reacher_step)(jstate,
                                                         jnp.asarray(action))
    state = {"pos": _t(pos), "vel": _t(vel), "target": _t(target),
             "t": _t(t)}
    np.testing.assert_allclose(env.observe(state).numpy(),
                               _np(jax.vmap(jax_reacher_obs)(jstate)),
                               **ENV_TOL)
    new, obs, rew, done, trunc = env.step(state, _t(action),
                                          torch.Generator().manual_seed(0))
    np.testing.assert_allclose(obs.numpy(), _np(jobs), **ENV_TOL)
    np.testing.assert_allclose(rew.numpy(), _np(jrew), **ENV_TOL)
    for k in ("pos", "vel"):
        np.testing.assert_allclose(new[k].numpy(), _np(jnew[k]), **ENV_TOL)
    assert not done.any() and not np.asarray(jdone).any()

    # reset: at rest at the origin, the target uniform in [-1, 1]^2; the
    # time limit restarts a finished env and keeps its terminal obs
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen, 256)
    assert obs.shape == (256, 6) and obs.dtype == torch.float32
    assert (state["pos"] == 0).all() and (state["vel"] == 0).all()
    assert state["target"].abs().max() <= 1.0
    assert state["target"].min() < -0.9 and state["target"].max() > 0.9
    torch.testing.assert_close(obs[:, 4:], state["target"])
    state["t"][:3] = env.spec.episode_length - 1
    new, obs, _, done, trunc = env.step(state, torch.ones((256, 2)), gen)
    assert done[:3].all() and trunc[:3].all() and not done[3:].any()
    assert (new["pos"][:3] == 0).all() and (new["pos"][3:] != 0).all()
    assert (obs[:3, :2] != 0).all()
