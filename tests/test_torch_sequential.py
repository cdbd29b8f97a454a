"""The ``sequential`` backend: the paper's Sequential baseline (one
member's update looped over the population) against the ``vectorized``
one, for the LM and for TD3, on the CPU; and ``PopTrainer`` driving an
``LMAgent`` with PBT, through the train CLI too.

As in the JAX package's ``test_vectorized_matches_sequential``, both
backends start from the same population: the vectorized arm runs one
population update (member gradients, one ``population_adam`` step; for
TD3 every linear through ``pop_matmul``'s plain version), the sequential
arm each member's stock-Adam step. The LM's tolerances are the JAX
test's: the losses at rtol 2e-5, the parameters at atol 2e-5, here after
3 steps (the first step's learning rate is 0 under warmup). TD3 takes the
same injected smoothing noise on both arms; its test says what it holds
and why. No JAX program runs here.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import (HyperSpace, PopulationConfig, TrainConfig,
                                 get_config)
from repro_torch.core.hyperparams import sample_hypers
from repro_torch.envs import make
from repro_torch.launch.train import main as train_main
from repro_torch.pop import LMAgent, PopTrainer, make_update
from repro_torch.rl import get_algo, make_agent
from repro_torch.tree import flat_buffer, leaves, tree_map

torch.set_num_threads(1)

N = 3
SEQ = 32
TCFG = TrainConfig(total_steps=50, warmup_steps=5, lr=1e-3,
                   weight_decay=0.1)
LM_SPACE = HyperSpace(log_uniform=(("lr_scale", 0.1, 10.0),
                                   ("weight_decay", 1e-3, 0.3)),
                      uniform=(("warmup_frac", 0.01, 0.25),))


def _lm_hypers():
    return {"lr_scale": torch.linspace(0.5, 2.0, N),
            "weight_decay": torch.linspace(0.01, 0.2, N),
            "warmup_frac": torch.tensor([0.01, 0.05, 0.2])}


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, shape, dtype=np.int32))}


@pytest.mark.parametrize("hypers", [None, "pbt"], ids=["plain", "hypers"])
@pytest.mark.parametrize("arch", ["rwkv6-test", "qwen2-0.5b"])
def test_lm_sequential_matches_vectorized(arch, hypers):
    cfg = get_config(arch)
    cfg = cfg if arch == "rwkv6-test" else cfg.smoke()
    agent = LMAgent(cfg, TCFG, device="cpu")
    h = _lm_hypers() if hypers else None
    vec = make_update(agent, "vectorized")
    seq = make_update(agent, "sequential")
    # the same population twice, each in flat buffers of its own
    sv = agent.population_init(torch.Generator().manual_seed(0), N)
    ss = agent.population_init(torch.Generator().manual_seed(0), N)
    trees = lambda s: (s.params, s.opt_state.mu, s.opt_state.nu)
    bases = [flat_buffer(t).data_ptr() for t in trees(ss)]
    vbases = [flat_buffer(t).data_ptr() for t in trees(sv)]
    for k in range(3):
        batch = _tokens(cfg, (N, 2, SEQ), seed=k)
        sv, mv = vec(sv, batch, h)
        ss, ms = seq(ss, batch, h)
        np.testing.assert_allclose(mv["loss"].numpy(), ms["loss"].numpy(),
                                   rtol=2e-5)
        assert torch.equal(mv["step"], ms["step"])
    assert ss.step.tolist() == sv.step.tolist() == [3] * N
    for a, b in zip(leaves(sv.params), leaves(ss.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
    # the sequential arm wrote each member into the population's own flat
    # buffers, as the vectorized arm's pop_adam step did
    assert [flat_buffer(t).data_ptr() for t in trees(ss)] == bases
    assert [flat_buffer(t).data_ptr() for t in trees(sv)] == vbases


def _td3_batch(shape, seed):
    rng = np.random.default_rng(seed)
    batch = {"obs": rng.standard_normal(shape + (3,)),
             "action": rng.uniform(-1, 1, shape + (1,)),
             "reward": rng.standard_normal(shape),
             "next_obs": rng.standard_normal(shape + (3,)),
             "done": (rng.random(shape) < 0.1).astype(np.float64)}
    noise = rng.standard_normal(shape + (1,))
    as_t = lambda a: torch.from_numpy(a.astype(np.float32))
    return {k: as_t(v) for k, v in batch.items()}, as_t(noise)


def _grads_close(got, want):
    """The gradients' tolerance of ``tests/test_torch_autograd.py``: rtol
    1e-4 and an atol of 5e-5 times the leaf's largest value."""
    for g, w in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=5e-5 * w.abs().max().item())


@pytest.mark.parametrize("num_steps", [1, 3])
def test_td3_sequential_matches_vectorized(num_steps):
    """Per-member ``td3.update`` (plain dense layers, stock Adam) looped
    over the members against the population update (``pop_matmul`` and
    ``pop_adam``'s plain versions), chained ``num_steps`` times per call,
    2 calls, sampled per-member hypers (the delayed actor's gate fires for
    some members and not others).

    Held: the losses of every call (rtol 2e-5); every step counter,
    exactly; after the first single step, the Adam moments (mu and
    sqrt(nu): the gradients and their squares, scaled) at the gradients'
    tolerance; and each parameter leaf's whole update, ``||d_seq - d_vec||
    / ||d_vec||`` under 1e-3. Not each element: Adam divides a gradient
    by its own RMS, so an element whose gradient is at float32's rounding
    level (the arms sum in other orders: dense products against batched
    ones) takes a step of up to its learning rate from that rounding,
    whichever arm computes it."""
    agent = make_agent("td3", make("pendulum").spec, device="cpu")
    gen = torch.Generator().manual_seed(1)
    hypers = sample_hypers(gen, get_algo("td3").hyper_space, N)
    vec = make_update(agent, "vectorized", num_steps=num_steps)
    seq = make_update(agent, "sequential", num_steps=num_steps)
    sv = agent.population_init(torch.Generator().manual_seed(2), N)
    ss = tree_map(torch.clone, sv)
    start = tree_map(torch.clone, sv)
    lead = (N, 32) if num_steps == 1 else (num_steps, N, 32)
    for call in range(2):
        batch, noise = _td3_batch(lead, seed=call)
        sv, mv = vec(sv, batch, hypers, noise=noise)
        ss, ms = seq(ss, batch, hypers, noise=noise)
        for name in ("critic_loss", "actor_loss"):
            assert mv[name].shape == ms[name].shape == (N,)
            np.testing.assert_allclose(mv[name].numpy(), ms[name].numpy(),
                                       rtol=2e-5, atol=1e-6)
        if call == 0 and num_steps == 1:
            for opt in ("critic_opt", "actor_opt"):
                _grads_close(getattr(ss, opt).mu, getattr(sv, opt).mu)
                _grads_close(tree_map(torch.sqrt, getattr(ss, opt).nu),
                             tree_map(torch.sqrt, getattr(sv, opt).nu))
    assert ss.step.tolist() == sv.step.tolist() == [2 * num_steps] * N
    for opt in ("critic_opt", "actor_opt"):
        assert torch.equal(getattr(ss, opt).step, getattr(sv, opt).step)
    assert not torch.equal(ss.actor_opt.step, ss.critic_opt.step)
    for tree in ("actor", "critic", "target_actor", "target_critic"):
        for a, b, s0 in zip(leaves(getattr(sv, tree)),
                            leaves(getattr(ss, tree)),
                            leaves(getattr(start, tree))):
            dv, ds = a - s0, b - s0
            assert dv.norm() > 0
            assert ((ds - dv).norm() / dv.norm()).item() < 1e-3, tree


def test_sequential_update_writes_the_population_in_place():
    """The Sequential arm never copies the population: it returns the
    tensors it was given, member i's slot written with member i's step."""
    agent = make_agent("td3", make("pendulum").spec, device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(2), N)
    ptrs = [x.data_ptr() for x in leaves(state)]
    before = tree_map(torch.clone, state)
    batch, noise = _td3_batch((N, 16), seed=0)
    out, metrics = make_update(agent, "sequential")(state, batch, None,
                                                    noise=noise)
    assert out is state and [x.data_ptr() for x in leaves(out)] == ptrs
    assert not torch.equal(out.critic["q1"]["layer_0"]["w"],
                           before.critic["q1"]["layer_0"]["w"])
    assert metrics["critic_loss"].shape == (N,)


@pytest.mark.parametrize("backend", ["sharded", "islands"])
def test_make_update_refuses_unported_backends(backend):
    """The sharded and islands backends are ported (a rank's rows of the
    population, ``test_torch_islands*.py``): on a world of one they build
    the vectorized update, and they refuse a population-level agent as
    the JAX package's do; an unknown name stays refused."""
    from repro_torch.pop import SharedCriticAgent
    agent = make_agent("td3", make("pendulum").spec, device="cpu")
    assert callable(make_update(agent, backend))
    with pytest.raises(ValueError, match="requires per-member agents"):
        make_update(SharedCriticAgent(3, 1, device="cpu"), backend)
    with pytest.raises(ValueError, match="unknown backend"):
        make_update(agent, "bogus")


def test_td3_env_loop_with_the_sequential_backend():
    """The acting engine's chained updates through the Sequential arm."""
    agent = make_agent("td3", make("pendulum").spec, device="cpu")
    pcfg = PopulationConfig(size=N, backend="sequential", num_steps=2,
                            pbt_interval=2,
                            hyper_space=get_algo("td3").hyper_space)
    trainer = PopTrainer(agent, pcfg, seed=1)
    trainer.attach_rollout(make("pendulum"), num_envs=2, collect_steps=8,
                           batch_size=16, buffer_capacity=128, eval_envs=2)
    lineages = []
    trainer.run_env_loop(4, eval_every=1, on_iter=lambda it, m, s, f, lin:
                         lineages.append(lin))
    assert trainer.state.critic_opt.step.tolist() == [8] * N
    assert [lin is not None for lin in lineages] == [False, True] * 2


@pytest.mark.parametrize("backend", ["vectorized", "sequential"])
def test_pop_trainer_trains_and_evolves_an_lm_population(backend):
    """``PopTrainer(LMAgent)``: fitness is -loss from the update's metrics,
    PBT evolves every 2 steps and gathers into the flat buffers (whose
    views the state keeps), the hypers are the LM space's."""
    cfg = get_config("rwkv6-test")
    pcfg = PopulationConfig(size=4, backend=backend, pbt_interval=2,
                            fitness_window=2, hyper_space=LM_SPACE)
    trainer = PopTrainer(LMAgent(cfg, TCFG, device="cpu"), pcfg, seed=0)
    assert set(trainer.hypers) == set(LM_SPACE.names)
    base = flat_buffer(trainer.state.params)
    seen = []
    trainer.run(4, lambda step: _tokens(cfg, (4, 2, SEQ), seed=step),
                on_step=lambda step, m, lin: seen.append((m, lin)))
    assert [lin is not None for _, lin in seen] == [False, True] * 2
    for m, _ in seen:
        assert m["loss"].shape == (4,) and torch.isfinite(m["loss"]).all()
    assert flat_buffer(trainer.state.params).data_ptr() == base.data_ptr()
    assert trainer.last_fitness.shape == (4,)


@pytest.mark.parametrize("backend", ["vectorized", "sequential"])
def test_train_cli_arch_on_cpu_writes_a_checkpoint(tmp_path, capsys,
                                                   backend):
    """``--arch`` with either backend: the header, an evolve line at each
    PBT step, ``final loss``; the checkpoint's parameters read back bit for
    bit."""
    ckpt = tmp_path / "ck"
    report = train_main(["--arch", "rwkv6-test", "--smoke", "--population",
                         "2", "--steps", "4", "--pbt-interval", "2",
                         "--batch", "2", "--seq-len", "32", "--ckpt-dir",
                         str(ckpt), "--backend", backend, "--device",
                         "cpu"])
    out = capsys.readouterr().out
    assert (f"[train] arch=rwkv6-test pop=2 strategy=pbt backend={backend}"
            in out)
    assert out.count("[train] evolve at step") == 2
    assert "final loss" in out and np.isfinite(report.final_loss)
    assert [s for s, _ in report.evolutions] == [2, 4]
    mgr = CheckpointManager(ckpt)
    assert mgr.latest() == 3
    assert mgr.peek_extra()["loss"] == report.final_loss
    params = report.trainer.state.params
    saved = mgr.restore_aux("actors", params)
    for got, want in zip(leaves(saved), leaves(params)):
        np.testing.assert_array_equal(got, want.numpy())


def test_train_cli_arch_refusals(tmp_path):
    """The frontend archs, once refused, train on the sequential backend;
    the CUDA requirement, a pixtral sequence shorter than its patch
    prefix and the acting engine's flags beside ``--arch`` are still
    refused."""
    base = ["--population", "2", "--steps", "2", "--ckpt-dir",
            str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_main(["--arch", "rwkv6-test"] + base)
    small = ["--smoke", "--device", "cpu", "--backend", "sequential",
             "--pbt-interval", "1", "--batch", "1", "--seq-len", "8"]
    for arch in ("musicgen-medium", "pixtral-12b"):
        report = train_main(["--arch", arch, *small, "--population", "2",
                             "--steps", "2", "--ckpt-dir",
                             str(tmp_path / arch)])
        assert [s for s, _ in report.evolutions] == [1, 2]
        assert np.isfinite(report.final_loss)
    with pytest.raises(ValueError, match="patch positions"):
        train_main(["--arch", "pixtral-12b", *small[:-1], "4"] + base)
    with pytest.raises(ValueError, match="acting engine"):
        train_main(["--arch", "rwkv6-test", "--fused-epoch", "--device",
                    "cpu"] + base)
    with pytest.raises(ValueError, match="--arch only"):
        train_main(["--algo", "td3", "--num-layers", "1", "--device",
                    "cpu"] + base)
