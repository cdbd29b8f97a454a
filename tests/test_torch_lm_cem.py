"""CEM over a language model's parameters against the JAX package's CEM,
on the CPU.

``LMAgent`` keeps the population's parameters in one flat ``(N, P)``
buffer whose columns are ``ravel_pytree``'s order, so CEM reads the buffer
as its samples, refits the distribution a column chunk at a time
(``cem_update_chunked``) and redraws every member into the buffer in
place (``cem_sample_into``). ``rwkv6-test`` (174,016 parameters a member),
N = 4; fitness from numpy, with a tie. The JAX functions' normal draws
are the ``jax.random.normal(key, (N, P))`` they make, handed to the port
as ``eps``. Tolerances:

  * the refit distribution and the redrawn parameters against JAX's,
    leaf by leaf: rtol 1e-6, atol 3e-7 (float32 weighted sums of two
    elites and ``mean + sqrt(.) * eps``, which XLA may contract into
    FMAs; where two terms cancel the relative error of one rounding
    grows, and a bind, a refit and a redraw stack theirs, so an atol of
    5 ulp of the parameters' largest values, about 0.5);
  * the chunked forms against the whole-matrix ``cem_update`` and
    ``cem_sample``: bit for bit, at chunks of 37 and 4,096 columns (a
    ragged last chunk) and one chunk of the whole row.

The file also runs ``repro_torch.examples.population_lm``, PBT over an
LM population, the JAX package's example on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.configs.base import PopulationConfig as JaxPopulationConfig
from repro.core import cem as jax_cem
from repro.pop.agent import LMAgent as JaxLMAgent
from repro.pop.agent import LMState as JaxLMState
from repro.pop.strategy import CEM as JaxCEM
from repro_torch.configs import PopulationConfig, TrainConfig, get_config
from repro_torch.core import cem
from repro_torch.launch.train import main as train_main
from repro_torch.pop import CEM, LMAgent, make_strategy
from repro_torch.pop import strategy as strategy_mod
from repro_torch.tree import flat_buffer, leaves, tree_map
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

ARCH, N = "rwkv6-test", 4
TOL = dict(rtol=1e-6, atol=3e-7)
FITNESS = np.asarray([2.0, -1.0, 2.0, 0.5], np.float32)   # a tie
SIGMA, NOISE, DECAY = 0.02, 0.01, 0.9


def _population():
    agent = LMAgent(get_config(ARCH), TrainConfig(), device="cpu")
    return agent, agent.population_init(torch.Generator().manual_seed(0), N)


def _jax_tree(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _assert_leaves_close(got_tree, want_tree):
    got, want = leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_cem_over_the_lm_buffer_matches_jax():
    """``cem_update`` then ``cem_sample`` over the members' raveled
    parameters (JAX) equals the chunked forms over ``LMAgent``'s buffer,
    whose rows are JAX's ravel of each member bit for bit."""
    agent, state = _population()
    buffer = agent.evolvable_buffer(state)
    jparams = _jax_tree(state.params)
    jflat = jax.vmap(lambda p: ravel_pytree(p)[0])(jparams)
    np.testing.assert_array_equal(buffer.numpy(), np.asarray(jflat))
    jstate, unravel = jax_cem.cem_init(
        jax.tree.map(lambda x: x[0], jparams), sigma_init=SIGMA,
        noise_init=NOISE)
    key = jax.random.PRNGKey(3)
    jnew = jax_cem.cem_update(jstate, jflat, jnp.asarray(FITNESS),
                              noise_decay=DECAY)
    jdrawn = jax.vmap(unravel)(jax_cem.cem_sample(key, jnew, N))
    eps = torch.from_numpy(np.array(
        jax.random.normal(key, (N, buffer.shape[1]))))

    new = cem.cem_update_chunked(
        cem.cem_centre(buffer[0].clone(), SIGMA, NOISE), buffer,
        torch.from_numpy(FITNESS), noise_decay=DECAY, chunk=4096)
    for got, want in zip(new, jnew):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ptr = buffer.data_ptr()
    cem.cem_sample_into(buffer, None, new, eps=eps, chunk=4096)
    assert buffer.data_ptr() == ptr
    assert flat_buffer(state.params) is not None
    _assert_leaves_close(state.params, jdrawn)


@pytest.mark.parametrize("chunk", [37, 4096, None])
def test_chunked_forms_equal_the_whole_forms_bit_for_bit(chunk):
    """The chunked refit and redraw against ``cem_update`` and
    ``cem_sample`` on the same samples, fitness and draw; with one chunk of
    the whole row the generator's draw is the whole form's too."""
    rng = np.random.default_rng(0)
    p = 10_007
    samples = torch.from_numpy(rng.standard_normal((N, p)).astype(np.float32))
    mean = torch.from_numpy(rng.standard_normal(p).astype(np.float32))
    state = cem.CEMState(mean, torch.from_numpy(
        rng.uniform(0.01, 0.1, p).astype(np.float32)), torch.tensor(NOISE))
    fitness = torch.from_numpy(FITNESS)
    whole = cem.cem_update(state, samples, fitness, noise_decay=DECAY)
    chunked = cem.cem_update_chunked(
        cem.CEMState(*(t.clone() for t in state)), samples, fitness,
        noise_decay=DECAY, chunk=chunk)
    for got, want in zip(chunked, whole):
        assert torch.equal(got, want)
    eps = torch.randn((N, p), generator=torch.Generator().manual_seed(1))
    out = torch.empty((N, p))
    cem.cem_sample_into(out, None, whole, eps=eps, chunk=chunk)
    assert torch.equal(out, cem.cem_sample(None, whole, N, eps=eps))
    if chunk is None:
        cem.cem_sample_into(out, torch.Generator().manual_seed(2), whole)
        assert torch.equal(out, cem.cem_sample(
            torch.Generator().manual_seed(2), whole, N))


def test_strategy_redraws_the_buffer_in_place_and_matches_jax(monkeypatch):
    """``CEM.bind`` and ``evolve`` over ``LMAgent`` against the JAX
    strategy over its ``LMAgent``, with JAX's draws patched into the
    port's sampler: the parameters after each, the strategy state
    ((P,) float32 mean and variance) and lineage all -1. The leaves stay
    views of the same buffer; the Adam moments and steps are left as they
    were (a population update ran first, so they are not zero)."""
    agent, state = _population()
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, agent.cfg.vocab_size, (N, 1, 8)))
    state, _ = agent.fused_update()(state, {"tokens": tokens})
    kept = tree_map(torch.clone, (state.opt_state, state.step))
    buffer = agent.evolvable_buffer(state)
    ptr = buffer.data_ptr()

    jcfg = JaxPopulationConfig(size=N, strategy="cem", sigma_init=SIGMA,
                               cem_noise_init=NOISE, cem_noise_decay=DECAY)
    jstrat = JaxCEM(jcfg)
    jagent = JaxLMAgent(jax_get_config(ARCH), JaxTrainConfig())
    jstate = JaxLMState(params=_jax_tree(state.params), opt_state=None,
                        step=jnp.asarray(state.step.numpy()))
    k_bind, k_evolve = jax.random.split(jax.random.PRNGKey(5))
    jbound = jstrat.bind(k_bind, jagent, jstate)
    jnew, _, jlineage = jstrat.evolve(k_evolve, jbound, None,
                                      jnp.asarray(FITNESS))
    p = buffer.shape[1]
    draws = iter([torch.from_numpy(np.array(jax.random.normal(k, (N, p))))
                  for k in (k_bind, k_evolve)])
    real = strategy_mod.cem_sample_into
    monkeypatch.setattr(strategy_mod, "cem_sample_into",
                        lambda out, g, s: real(out, g, s, eps=next(draws)))

    strat = make_strategy(PopulationConfig(
        size=N, strategy="cem", sigma_init=SIGMA, cem_noise_init=NOISE,
        cem_noise_decay=DECAY))
    assert isinstance(strat, CEM)
    bound = strat.bind(None, agent, state)
    _assert_leaves_close(bound.params, jbound.params)
    new, hypers, lineage = strat.evolve(None, bound, None,
                                        torch.from_numpy(FITNESS))
    assert hypers is None
    assert lineage.tolist() == np.asarray(jlineage).tolist() == [-1] * N
    _assert_leaves_close(new.params, jnew.params)
    exported = strat.export_state()
    for got, want in zip(exported, jstrat.export_state()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert exported.mean.shape == exported.var.shape == (p,)
    assert exported.mean.dtype == exported.var.dtype == torch.float32

    assert flat_buffer(new.params).data_ptr() == ptr
    assert all(a.data_ptr() == b.data_ptr()
               for a, b in zip(leaves(new.params), leaves(state.params)))
    for got, want in zip(leaves((new.opt_state, new.step)), leaves(kept)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("backend", ["vectorized", "sequential"])
def test_train_cli_runs_cem_over_an_lm(backend, tmp_path):
    """``--arch rwkv6-test --smoke --strategy cem --device cpu`` on both
    backends: two evolves, lineage all -1, the members' parameters still
    views of one buffer that the distribution's (P,) vectors span."""
    report = train_main(["--arch", ARCH, "--smoke", "--population", "3",
                         "--steps", "4", "--pbt-interval", "2", "--batch",
                         "2", "--seq-len", "16", "--strategy", "cem",
                         "--backend", backend, "--ckpt-dir", str(tmp_path),
                         "--device", "cpu"])
    assert report.evolutions == [(2, [-1] * 3), (4, [-1] * 3)]
    assert np.isfinite(report.final_loss)
    trainer = report.trainer
    buffer = trainer.agent.evolvable_buffer(trainer.state)
    assert buffer.shape[0] == 3
    assert trainer.strategy.cem_state.mean.shape == (buffer.shape[1],)
    assert float(trainer.strategy.cem_state.noise) == pytest.approx(
        1e-2 * 0.999 ** 2, rel=1e-6)


def test_population_lm_example_trains_with_pbt(tmp_path, capsys):
    """``repro_torch.examples.population_lm``, the JAX package's
    ``examples/population_lm.py`` with its ``--resume none``: PBT over 4
    qwen2-0.5b members at ``.smoke()`` width, an evolve at step 20, the
    checkpoint at the last step. Its ``--resume auto`` (refused as a flag
    of the train CLI before resume was ported) continues that run: steps
    21-22 from step 19's checkpoint."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.examples import population_lm

    report = population_lm.run(tmp_path, steps=20, device="cpu")
    assert [s for s, _ in report.evolutions] == [20]
    assert all(-1 < p < 4 for p in report.evolutions[0][1])
    assert np.isfinite(report.final_loss)
    assert CheckpointManager(tmp_path).latest() == 19
    again = population_lm.main(["--ckpt-dir", str(tmp_path), "--steps",
                                "22", "--resume", "auto", "--device",
                                "cpu"])
    assert "resumed from step 19" in capsys.readouterr().out
    assert again.trainer.step_count == 22 and again.evolutions == []
    assert CheckpointManager(tmp_path).latest() == 21
