"""The port's PBT against the JAX package's, with the JAX key chain's draws
injected.

``sample_hypers``, ``perturb_hypers`` and ``pbt_step`` split every random
step into draws and a pure apply; here the draws are made by the same
``jax.random`` calls the JAX functions make, handed to the port, and the
lineage and hypers of ``perturb_hypers`` and ``pbt_step`` must match
exactly (fitness values are distinct, so the ranking has no ties).
``sample_hypers`` turns uniform draws into values with ``u * (hi - lo) +
lo`` and, for learning rates, ``exp``: XLA contracts the first into one
FMA and has its own ``exp``, so it is held at rtol = 2e-6 (1 ulp for the
uniform priors, about 1e-6 after ``exp``). The strategy wiring runs on the
port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HyperSpace as JaxHyperSpace
from repro.configs.base import PopulationConfig as JaxPopulationConfig
from repro.core.hyperparams import perturb_hypers as jax_perturb_hypers
from repro.core.hyperparams import sample_hypers as jax_sample_hypers
from repro.core.pbt import pbt_step as jax_pbt_step
from repro.rl.registry import get_algo as jax_get_algo
from repro_torch.configs.base import HyperSpace, PopulationConfig
from repro_torch.core.hyperparams import perturb_hypers, sample_hypers
from repro_torch.core.pbt import exploit_count, pbt_step
from repro_torch.pop.strategy import (CEM, PBT, DvD, NoEvolution,
                                      make_strategy)
from repro_torch.rl import get_algo
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

SPACE = get_algo("td3").hyper_space
JSPACE = jax_get_algo("td3").hyper_space


def test_hyper_space_is_the_jax_copy():
    assert SPACE.log_uniform == JSPACE.log_uniform
    assert SPACE.uniform == JSPACE.uniform
    assert SPACE.names == JSPACE.names
    # the copy keeps JAX's field order and defaults, CEM's and DvD's
    # included, less the fields of what the port has not got: buffer
    # donation and the kernel switches (the port's update always runs the
    # kernels)
    fields = PopulationConfig.__dataclass_fields__
    jax_fields = JaxPopulationConfig.__dataclass_fields__
    left_out = {"donate", "fused_adam", "fused_linear"}
    assert list(fields) == [f for f in jax_fields if f not in left_out]
    assert left_out <= set(jax_fields)
    for name, f in fields.items():
        if name != "hyper_space":
            assert f.default == \
                JaxPopulationConfig.__dataclass_fields__[name].default
    assert HyperSpace().names == JaxHyperSpace().names == ()


def _jax_uniforms(key, space, n):
    """The uniform [0, 1) draws ``jax_sample_hypers`` makes."""
    out = {}
    for i, (name, _, _) in enumerate(space.log_uniform):
        out[name] = jax.random.uniform(jax.random.fold_in(key, i), (n,))
    for j, (name, _, _) in enumerate(space.uniform):
        out[name] = jax.random.uniform(jax.random.fold_in(key, 1000 + j),
                                       (n,))
    return _t(out)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_hypers_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    want = jax_sample_hypers(key, JSPACE, 8)
    got = sample_hypers(None, SPACE, 8, draws=_jax_uniforms(key, JSPACE, 8))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=2e-6, atol=0, err_msg=name)
        lo, hi = next((lo, hi) for n, lo, hi in
                      SPACE.log_uniform + SPACE.uniform if n == name)
        assert (got[name] >= lo * (1 - 1e-6)).all()
        assert (got[name] <= hi * (1 + 1e-6)).all()


def _jax_perturb_draws(kh, names, n, perturb_prob):
    """The draws ``jax_perturb_hypers`` makes from its key."""
    fresh = jax_sample_hypers(jax.random.fold_in(kh, 0), JSPACE, n)
    up, resample = {}, {}
    for i, name in enumerate(sorted(names)):
        k1, k2 = jax.random.split(jax.random.fold_in(kh, 17 + i))
        up[name] = jax.random.bernoulli(k1, 0.5, (n,))
        resample[name] = jax.random.bernoulli(k2, perturb_prob, (n,))
    return {"fresh": _t(fresh), "up": _t(up), "resample": _t(resample)}


@pytest.mark.parametrize("seed", [0, 5])
def test_perturb_hypers_matches_jax(seed):
    n = 8
    key = jax.random.PRNGKey(seed)
    hypers = jax_sample_hypers(jax.random.PRNGKey(100 + seed), JSPACE, n)
    mask = np.array([True, False] * 4)
    want = jax_perturb_hypers(key, hypers, JSPACE, jnp.asarray(mask),
                              perturb_prob=0.5, scale=1.2)
    got = perturb_hypers(None, _t(hypers), SPACE, torch.from_numpy(mask),
                         perturb_prob=0.5, scale=1.2,
                         draws=_jax_perturb_draws(key, hypers, n, 0.5))
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
        # unmasked members keep theirs
        np.testing.assert_array_equal(got[name].numpy()[~mask],
                                      np.asarray(hypers[name])[~mask])


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_pbt_step_matches_jax(seed):
    n = 8
    pcfg = PopulationConfig(size=n, hyper_space=SPACE)
    jpcfg = JaxPopulationConfig(size=n, hyper_space=JSPACE)
    rng = np.random.default_rng(seed)
    fitness = rng.permutation(n).astype(np.float32) * 3.0 - 10.0
    state = {"w": rng.standard_normal((n, 4, 2)).astype(np.float32),
             "step": np.arange(n, dtype=np.int32)}
    hypers = jax_sample_hypers(jax.random.PRNGKey(50 + seed), JSPACE, n)
    key = jax.random.PRNGKey(seed)

    jstate, jhypers, jparents = jax_pbt_step(
        key, {k: jnp.asarray(v) for k, v in state.items()}, hypers,
        jnp.asarray(fitness), jpcfg)
    k = exploit_count(n, pcfg.exploit_frac)
    kp, kh = jax.random.split(key)
    draws = {"parent": torch.from_numpy(np.array(
                 jax.random.randint(kp, (k,), 0, k))),
             "perturb": _jax_perturb_draws(kh, hypers, n,
                                           pcfg.perturb_prob)}
    tstate, thypers, parents = pbt_step(
        None, {k_: torch.from_numpy(v) for k_, v in state.items()},
        _t(hypers), torch.from_numpy(fitness), pcfg, draws=draws)

    np.testing.assert_array_equal(parents.numpy(), np.asarray(jparents))
    assert (parents.numpy() != np.arange(n)).sum() == k == 2
    for name in jhypers:
        np.testing.assert_array_equal(thypers[name].numpy(),
                                      np.asarray(jhypers[name]))
    for name in jstate:
        np.testing.assert_array_equal(tstate[name].numpy(),
                                      np.asarray(jstate[name]))
    # the bottom k by fitness were replaced by members of the top k
    order = np.argsort(fitness, kind="stable")
    replaced = np.flatnonzero(parents.numpy() != np.arange(n))
    assert set(replaced) == set(order[:k])
    assert set(parents.numpy()[replaced]) <= set(order[-k:])


def test_strategies_on_the_port():
    """PBT draws on the generator's device and evolves; NoEvolution is the
    identity; size 1 is always NoEvolution; cem and dvd resolve to CEM and
    DvD."""
    n = 6
    pcfg = PopulationConfig(size=n, hyper_space=SPACE)
    strat = make_strategy(pcfg)
    assert isinstance(strat, PBT) and not strat.null
    gen = torch.Generator().manual_seed(0)
    hypers = strat.init_hypers(gen, n)
    assert sorted(hypers) == sorted(SPACE.names)

    class _Agent:
        def gather_members(self, pop_state, parents):
            return {k: v[parents] for k, v in pop_state.items()}

    state = {"x": torch.arange(n, dtype=torch.float32)}
    strat.bind(gen, _Agent(), state)
    fitness = torch.tensor([5.0, 1.0, 3.0, 0.0, 4.0, 2.0])
    new, new_h, lineage = strat.evolve(gen, state, hypers, fitness)
    assert lineage.shape == (n,) and (lineage != torch.arange(n)).sum() == 2
    assert torch.equal(new["x"], lineage.float())
    for name in SPACE.names:
        kept = lineage == torch.arange(n)
        assert torch.equal(new_h[name][kept], hypers[name][kept])

    assert isinstance(make_strategy(PopulationConfig(size=1)), NoEvolution)
    same, h, lin = NoEvolution().evolve(gen, state, hypers, fitness)
    assert same is state and h is hypers and torch.equal(lin,
                                                         torch.arange(n))
    for name, cls in (("cem", CEM), ("dvd", DvD)):
        assert type(make_strategy(PopulationConfig(size=4,
                                                   strategy=name))) is cls
    with pytest.raises(ValueError, match="unknown strategy"):
        make_strategy(PopulationConfig(size=4, strategy="bogus"))
