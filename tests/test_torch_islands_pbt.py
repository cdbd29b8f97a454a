"""PBT, the acting engine, checkpoints and elastic restore over gloo ranks
against one rank.

The member exchange (``MemberExchange``, PBT's ``gather`` over islands)
on 2 and 4 ranks must give each rank the rows a one-rank ``pbt_step``
gives those members, bit for bit, with the JAX package's PBT draws
injected, and move only the rows PBT copies. A trainer on 2 ranks runs 3
env iterations with an evolve whose parents cross ranks and writes a
checkpoint: states, buffers, env states, hypers, lineage and every file
of the checkpoint equal the one-rank run's bit for bit. The JAX package's
``ROUNDTRIP`` (``tests/test_elastic.py``) is mirrored: 4 members saved on
2 ranks with fitness [3, 1, 4, 2], 2 restored on 1 rank, lineage [0, 2],
the survivors' digests equal and training going on; 2 ranks resume the
2-rank checkpoint by rows as 1 rank resumes the 1-rank one. An LM
population
(``rwkv6-test``, smoke widths) whose evolve copies a member across ranks
keeps its flat buffers and equals the one-rank run bit for bit. Ranks are
spawned by ``run_ranks`` (``test_torch_islands``).
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import HyperSpace, PopulationConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.distributed import MemberExchange, take_rows
from repro_torch.core.pbt import exploit_count, pbt_step
from repro_torch.elastic import plan_layout, restore_elastic
from repro_torch.envs import make
from repro_torch.pop import LMAgent, PopTrainer
from repro_torch.tree import leaves, tree_map
from test_torch_islands import agent_td3, run_ranks
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401
from test_torch_pbt import JSPACE, SPACE, _jax_perturb_draws, _t

torch.set_num_threads(1)

RL_SPACE = HyperSpace(log_uniform=(("actor_lr", 3e-5, 3e-3),),
                      uniform=(("explore_noise", 0.0, 0.5),))


# --------------------------------------------------------- the exchange
def _pbt_case(n, seed):
    from repro.core.hyperparams import sample_hypers as jax_sample_hypers
    pcfg = PopulationConfig(size=n, hyper_space=SPACE, exploit_frac=0.25)
    rng = np.random.default_rng(seed)
    fitness = rng.permutation(n).astype(np.float32)
    state = {"w": rng.standard_normal((n, 4, 2)).astype(np.float32),
             "step": np.arange(n, dtype=np.int32)}
    hypers = jax_sample_hypers(jax.random.PRNGKey(50 + seed), JSPACE, n)
    kp, kh = jax.random.split(jax.random.PRNGKey(seed))
    k = exploit_count(n, pcfg.exploit_frac)
    draws = {"parent": torch.from_numpy(np.array(
                 jax.random.randint(kp, (k,), 0, k))),
             "perturb": _jax_perturb_draws(kh, hypers, n,
                                           pcfg.perturb_prob)}
    return pcfg, fitness, state, _t(hypers), draws


def _pbt(state, hypers, fitness, pcfg, draws, gather):
    return pbt_step(None, state, hypers, torch.from_numpy(fitness), pcfg,
                    gather=gather, draws=draws)


def _exchange_rank(rank, world, case):
    pcfg, fitness, state, hypers, draws = case
    n = fitness.shape[0]
    layout = plan_layout(world, n)
    gather = MemberExchange(lambda s, p: tree_map(lambda x: x[p], s), layout)
    new, new_hypers, parents = _pbt(take_rows(_t(state), layout.rows()),
                                    hypers, fitness, pcfg, draws, gather)
    return {"rows": tuple(layout.rows()), "state": new,
            "hypers": new_hypers, "parents": parents, "last": gather.last}


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_on_ranks_equals_the_one_rank_evolve(tmp_path, world):
    n = 8
    case = _pbt_case(n, seed=3)
    want, want_h, want_p = _pbt(_t(case[2]), case[3], case[1],
                                case[0], case[4], None)
    outs = run_ranks(_exchange_rank, world, tmp_path, case)
    per = n // world
    p = want_p.tolist()
    crossing = [i for i in range(n) if p[i] // per != i // per]
    assert crossing                      # the case copies across ranks
    row_bytes = 4 * 2 * 4 + 4            # one member's w and step
    # source island -> (the members it sends, the islands taking them)
    plan = {}
    for i in crossing:
        sent, takers = plan.setdefault(p[i] // per, (set(), set()))
        sent.add(p[i])
        takers.add(i // per)
    for out in outs:
        lo, hi, _ = out["rows"]
        assert torch.equal(out["parents"], want_p)
        for key in want:
            assert torch.equal(out["state"][key], want[key][lo:hi])
        for key in want_h:
            assert torch.equal(out["hypers"][key], want_h[key])
        # only the copied parents' rows cross, to the ranks taking them
        moved = sum(len(sent) for j, (sent, takers) in plan.items()
                    if lo // per == j or lo // per in takers)
        assert out["last"]["members"] == moved
        assert out["last"]["bytes"] == moved * row_bytes


# -------------------------------------------- the trainer and checkpoints
def _trainer(n, ckpt, pbt_interval=2, world_layout=None):
    pcfg = PopulationConfig(size=n, strategy="pbt", backend="islands",
                            num_steps=2, pbt_interval=pbt_interval,
                            hyper_space=RL_SPACE, exploit_frac=0.25)
    tr = PopTrainer(agent_td3(), pcfg, seed=0, checkpoint_dir=ckpt,
                    layout=world_layout)
    tr.attach_rollout(make("pendulum"), num_envs=2, collect_steps=8,
                      batch_size=16, buffer_capacity=256, eval_envs=1)
    return tr


def _host(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def _train_rank(rank, world, n, ckpt):
    tr = _trainer(n, ckpt)
    lineages = []
    tr.run_env_loop(3, eval_every=1, on_iter=lambda it, m, s, f, lin: (
        lineages.append(None if lin is None else lin.tolist())))
    tr.save(blocking=True)
    return {"rows": tuple(tr.rows), "islands": tr.layout.islands,
            "state": _host(tr.state), "rollout": _host(
                tr.rollout.export_state()),
            "hypers": _host(tr.hypers), "lineages": lineages,
            "gen": tr.generator.get_state()}


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    base = tmp_path_factory.mktemp("islands_pbt")
    one = _train_rank(0, 1, 4, base / "one")
    two = run_ranks(_train_rank, 2, base, 4, base / "two")
    return base, one, two


def test_env_iterations_on_two_ranks_equal_one_rank(two_rank_run):
    _, one, two = two_rank_run
    assert one["islands"] == 1 and [o["islands"] for o in two] == [2, 2]
    # the evolve at iteration 2 copies a member across the two ranks
    lineage = one["lineages"][1]
    assert any(p // 2 != i // 2 for i, p in enumerate(lineage))
    for out in two:
        lo, hi, _ = out["rows"]
        assert out["lineages"] == one["lineages"]
        assert torch.equal(out["gen"], one["gen"])
        for a, b in zip(leaves((out["state"], out["rollout"])),
                        leaves((one["state"], one["rollout"]))):
            assert torch.equal(a, b[lo:hi])
        for a, b in zip(leaves(out["hypers"]), leaves(one["hypers"])):
            assert torch.equal(a, b)


def test_checkpoint_from_two_ranks_equals_one_rank(two_rank_run):
    """Rank 0 writes every island's rows: the same files, bit for bit."""
    base, _, _ = two_rank_run
    steps = sorted(p.name for p in (base / "one").iterdir())
    assert steps == sorted(p.name for p in (base / "two").iterdir())
    for step in steps:
        files = sorted(p.name for p in (base / "one" / step).iterdir())
        assert files == sorted(p.name for p in (base / "two" / step).iterdir())
        for name in files:
            if name.endswith(".npz"):
                a = np.load(base / "one" / step / name)
                b = np.load(base / "two" / step / name)
                assert a.files == b.files
                for key in a.files:
                    np.testing.assert_array_equal(a[key], b[key])


def _resume_rank(rank, world, ckpt):
    tr = _trainer(4, ckpt)
    step = tr.resume()
    tr.run_env_loop(2, eval_every=1)
    return {"rows": tuple(tr.rows), "step": step, "state": _host(tr.state),
            "rollout": _host(tr.rollout.export_state())}


def test_resume_on_two_ranks_takes_rows(two_rank_run, tmp_path):
    """Every rank reads the checkpoint and takes its rows: 2 ranks resume
    the 2-rank run's checkpoint and train on (an evolve at iteration 4)
    as one rank resumed from the 1-rank run's, bit for bit."""
    base, _, _ = two_rank_run
    one = _resume_rank(0, 1, base / "one")
    two = run_ranks(_resume_rank, 2, tmp_path, base / "two")
    assert one["step"] == 2
    for out in two:
        lo, hi, _ = out["rows"]
        assert out["step"] == 2
        for a, b in zip(leaves((out["state"], out["rollout"])),
                        leaves((one["state"], one["rollout"]))):
            assert torch.equal(a, b[lo:hi])


def _digest(tree):
    return [np.asarray(x).astype(np.float64).sum().item()
            for x in leaves(tree)]


def _roundtrip_save_rank(rank, world, ckpt):
    tr = _trainer(4, ckpt, pbt_interval=0)
    for _ in range(3):
        tr.env_iteration()
    tr.report_fitness(np.array([3.0, 1.0, 4.0, 2.0], np.float32))
    tr.save(blocking=True)
    keep = [0, 2]
    rows = tr.rows
    mine = [m - rows.lo for m in keep if rows.lo <= m < rows.hi]
    pick = lambda t: tree_map(lambda x: x[mine], t)
    return {"keep": [m for m in keep if rows.lo <= m < rows.hi],
            "actors": pick(tr.actors),
            "buf_total": pick(tr.rollout.bufs.total),
            "buf_obs": pick(tr.rollout.bufs.data["obs"]),
            "ep_return": pick(tr.rollout.vstate.completed_return_sum)}


def test_roundtrip_saved_on_two_ranks_restores_two_on_one(tmp_path):
    """The JAX ``ROUNDTRIP`` mirrored: save 4 members on 2 ranks, restore
    2 on 1 rank; fitness [3, 1, 4, 2] keeps members 0 and 2, whose
    parameters, replay buffers and episode stats are intact, and the next
    iteration trains."""
    outs = run_ranks(_roundtrip_save_rank, 2, tmp_path, tmp_path / "ck")
    saved = {}
    for out in outs:
        for j, m in enumerate(out["keep"]):
            saved[m] = {k: tree_map(lambda x: x[j], out[k])
                        for k in ("actors", "buf_total", "buf_obs",
                                  "ep_return")}
    tr = _trainer(2, tmp_path / "ck", pbt_interval=0)
    step, lineage = restore_elastic(tr)
    assert step == 2 and lineage.tolist() == [0, 2]
    got = {"actors": tr.actors, "buf_total": tr.rollout.bufs.total,
           "buf_obs": tr.rollout.bufs.data["obs"],
           "ep_return": tr.rollout.vstate.completed_return_sum}
    for k in got:
        want = tree_map(lambda *xs: torch.stack(xs),
                        *(saved[m][k] for m in (0, 2)))
        assert _digest(got[k]) == _digest(want), k
    _, _, did = tr.env_iteration()
    assert did


# ------------------------------------------------------------- the LM
def _lm_rank(rank, world, steps):
    cfg = get_config("rwkv6-test").smoke()
    pcfg = PopulationConfig(
        size=4, strategy="pbt", backend="islands", pbt_interval=2,
        exploit_frac=0.25,
        hyper_space=HyperSpace(log_uniform=(("lr_scale", 0.1, 10.0),)))
    tr = PopTrainer(LMAgent(cfg, TrainConfig(total_steps=steps),
                            device="cpu"), pcfg, seed=0)
    rng = np.random.default_rng(0)
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2, 16)))
              for _ in range(steps)]
    lineages = []
    tr.run(steps, lambda s: {"tokens": tokens[s]},
           on_step=lambda s, m, lin: lineages.append(
               None if lin is None else lin.tolist()))
    base = leaves(tr.state.params)[0]._base
    return {"rows": tuple(tr.rows), "state": _host(tr.state),
            "lineages": lineages, "flat": base is not None
            and all(x._base is base for x in leaves(tr.state.params)),
            "bytes": getattr(tr.strategy.gather, "last", {}).get("bytes")}


def test_lm_member_copied_across_ranks(tmp_path):
    one = _lm_rank(0, 1, 4)
    two = run_ranks(_lm_rank, 2, tmp_path, 4)
    crossed = [lin for lin in one["lineages"] if lin is not None and any(
        p // 2 != i // 2 for i, p in enumerate(lin))]
    assert crossed
    for out in two:
        lo, hi, _ = out["rows"]
        assert out["lineages"] == one["lineages"] and out["flat"]
        assert out["bytes"] > 0
        for a, b in zip(leaves(out["state"]), leaves(one["state"])):
            assert torch.equal(a, b[lo:hi])
