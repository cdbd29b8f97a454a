"""The port's TD3 actor and population-batched applies against the JAX
package's, at the real width (obs 3 -> 256 -> 256 -> 1).

Parameters are drawn by the JAX package, carried across with
``repro_torch.convert``, and both sides see the same numpy observations.
JAX runs ``pop_actor_apply`` with ``fused=True`` (the Pallas kernel in
interpret mode) and ``fused=False`` (einsum); the port runs its CPU path.
Tolerance rtol = atol = 1e-5: fp32 sums in another order.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.population import population_init as jax_population_init
from repro.rl import networks as jnets
from repro.rl import td3 as jtd3
from repro_torch.convert import from_jax_params, to_numpy
from repro_torch.nn.basic import lecun_normal, mlp_apply, mlp_init
from repro_torch.rl import networks as nets
from repro_torch.rl import td3
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
OBS, ACT = 3, 1


def _jax_actors(n, seed=0):
    pop = jax_population_init(
        lambda k: jnets.actor_init(k, OBS, ACT), jax.random.PRNGKey(seed), n)
    return jax.tree.map(np.asarray, pop)


def _obs(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)


@pytest.mark.parametrize("jax_fused", [True, False])
def test_pop_actor_apply_matches_jax(jax_fused):
    n, b = 3, 5
    actors = _jax_actors(n)
    obs = _obs(n, b, OBS)
    want = np.asarray(jnets.pop_actor_apply(actors, obs, fused=jax_fused))
    params = from_jax_params(actors)
    for fused in (None, False):
        got = nets.pop_actor_apply(params, torch.from_numpy(obs),
                                   fused=fused)
        assert got.shape == (n, b, ACT)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pop_actor_apply_equals_per_member_actor():
    """The population-level forward is the per-member actor, member by
    member, on the JAX package's numbers too."""
    n, b = 4, 6
    actors = _jax_actors(n, seed=1)
    obs = _obs(n, b, OBS, seed=1)
    params = from_jax_params(actors)
    pop = nets.pop_actor_apply(params, torch.from_numpy(obs)).numpy()
    for i in range(n):
        member = jax.tree.map(lambda x: x[i], actors)
        want = np.asarray(jnets.actor_apply(member, obs[i]))
        got = nets.actor_apply(from_jax_params(member),
                               torch.from_numpy(obs[i])).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(pop[i], want, **TOL)


def test_td3_policy_matches_jax_deterministic_head():
    actors = _jax_actors(1)
    member = jax.tree.map(lambda x: x[0], actors)
    obs = _obs(7, OBS, seed=2)
    want = np.asarray(jtd3.policy(member, obs))
    got = td3.policy(from_jax_params(member), torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    noisy = td3.policy(from_jax_params(member), torch.from_numpy(obs),
                       torch.Generator().manual_seed(0),
                       exploration_noise=0.5)
    assert noisy.abs().max() <= 1.0 and not torch.equal(noisy, got)


def test_broadcast_requests_match_materialized():
    actors = from_jax_params(_jax_actors(4, seed=3))
    obs = torch.from_numpy(_obs(9, OBS, seed=3))
    bx = obs.unsqueeze(0).expand(4, 9, OBS)
    torch.testing.assert_close(nets.pop_actor_apply(actors, bx),
                               nets.pop_actor_apply(actors, bx.contiguous()),
                               rtol=0, atol=0)


def test_pop_linear_apply_rejects_unknown_activation():
    p = {"w": torch.zeros((2, 3, 4)), "b": torch.zeros((2, 4))}
    with pytest.raises(ValueError, match="unsupported activation"):
        nets.pop_linear_apply(p, torch.zeros((2, 5, 3)), activation="gelu")


def test_actor_init_layout_and_distribution():
    """Same names and shapes as the JAX actor; weights are a normal
    truncated at 2 sigma, scaled by 1/sqrt(fan_in); biases zero; a seed
    gives the same parameters every time."""
    p = nets.actor_init(torch.Generator().manual_seed(0), OBS, ACT)
    jp = jax.tree.map(np.asarray, jnets.actor_init(jax.random.PRNGKey(0),
                                                   OBS, ACT))
    assert sorted(p) == sorted(jp)
    for name in p:
        for leaf in ("w", "b"):
            assert tuple(p[name][leaf].shape) == jp[name][leaf].shape
            assert p[name][leaf].dtype == torch.float32
        assert torch.count_nonzero(p[name]["b"]) == 0
    again = nets.actor_init(torch.Generator().manual_seed(0), OBS, ACT)
    for a, b in zip(to_numpy(p).values(), to_numpy(again).values()):
        np.testing.assert_array_equal(a["w"], b["w"])

    w = lecun_normal(torch.Generator().manual_seed(0), (256, 4096))
    scaled = w.numpy() * np.sqrt(256)
    assert np.abs(scaled).max() <= 2.0
    # std of a standard normal truncated at +-2: 0.8796
    assert abs(scaled.std() - 0.8796) < 0.01
    jw = np.asarray(jax.nn.initializers.truncated_normal(1.0)(
        jax.random.PRNGKey(0), (256, 4096)))
    assert abs(jw.std() - scaled.std()) < 0.01


def test_mlp_apply_matches_jax():
    from repro.nn.basic import mlp_apply as jmlp_apply, mlp_init as jmlp_init
    jp = jax.tree.map(np.asarray,
                      jmlp_init(jax.random.PRNGKey(4), [5, 16, 16, 2]))
    x = _obs(3, 5, seed=4)
    for act, final in (("relu", None), ("tanh", "tanh")):
        want = np.asarray(jmlp_apply(jp, x, activation=act,
                                     final_activation=final))
        got = mlp_apply(from_jax_params(jp), torch.from_numpy(x),
                        activation=act, final_activation=final)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert sorted(mlp_init(torch.Generator(), [5, 16, 16, 2])) == sorted(jp)
