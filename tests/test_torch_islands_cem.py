"""CEM and DvD over islands and over model-sharded members, on gloo ranks.

A population split over K ranks, and a member cut over an island's model
ranks, must evolve as the one-rank run does. Each spawn (``run_ranks`` of
``test_torch_islands``) runs several jobs, and several tests read its
results:

  * TD3 and PPO (CEM over PPO's whole ``{actor, critic, log_std}`` tree)
    on 2 and 4 islands: the actors after bind and after each of 2
    evolves, the CEM state, the lineage and the generator equal the
    one-rank trainer's bit for bit; DvD over islands is the identity; the
    train CLI with ``--strategy cem --backend islands`` under
    ``torch.distributed.run`` on 2 ranks writes the one-rank checkpoints;
  * ``rwkv6-test`` at islands 2 x model 1, 1 x 2 and 2 x 2 (4 ranks), at
    a CEM chunk of 1,009 columns (it cuts through leaves and parts): every
    rank's rows and columns after bind and each evolve equal the one-rank
    run's bit for bit, and rank 0's checkpointed CEM state is the whole
    one-rank state;
  * a CEM checkpoint written over ranks resumes on one rank (model 2 ->
    1), at model 2 from a model-1 checkpoint, and through
    ``restore_elastic`` on 4 ranks at 8 members, each then evolving as the
    one-rank run does;
  * the JAX package's ``PopTrainer(backend="islands", strategy="cem")``
    (8 host devices in one subprocess: TD3 on 8 islands, ``rwkv6-test``
    at islands 4 x model 2), fed the same population and fitness: its
    refitted ``(mean, var, noise)`` against the port's over 2 and 4 ranks
    at rtol 1e-6 (atol 1e-7), its redraws at the CEM tolerance of
    ``test_torch_cem_dvd.py`` with its normal draws passed across.

The JAX subprocess, the spawns and the CLI runs go at once.
"""
import contextlib
import io
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import PopulationConfig
from repro_torch.core import cem as cem_mod
from repro_torch.elastic import IslandLayout, plan_layout, restore_elastic
from repro_torch.launch.train import main as train_main
from repro_torch.models.sharding import ModelShard, PartMap
from repro_torch.pop import LMAgent, PopTrainer, SharedCriticAgent
from repro_torch.pop import strategy as strategy_mod
from repro_torch.pop.agent import PPOAgent
from repro_torch.tree import copy_into, leaves
from test_torch_islands import agent_td3, run_ranks
from test_torch_islands_cli import RL, _same_checkpoints
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401
from test_torch_td3_update import _port_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, LM_N, OBS, ACT = 8, 4, 3, 1
CHUNK = 1009                      # cuts through rwkv6-test's leaves
FIT = ([3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0],
       [0.5, 2.0, -1.0, 2.0, 7.0, 0.0, 1.5, -3.0])
LM_FIT = ([0.5, 2.0, -1.0, 2.0], [1.0, -2.0, 3.0, 0.25])
CEM_TOL = dict(rtol=1e-5, atol=1e-6)
REFIT_TOL = dict(rtol=1e-6, atol=1e-7)
LM_LAYOUTS = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
CEM_CLI = RL + ["--strategy", "cem", "--backend", "islands"]


def _lm_agent():
    return LMAgent(get_config("rwkv6-test"), TrainConfig(), device="cpu")


def _ppo_agent():
    return PPOAgent(OBS, ACT, device="cpu", hidden=(32, 32))


def _numpy(tree):
    return [x.detach().clone().numpy() for x in leaves(tree)]


def _cem(state):
    return [np.asarray(x).copy() for x in state]


# --------------------------------------------------------- the RL runs
def _rl_run(agent, strategy, layout, n=N):
    """Bind, then 2 evolves on FIT: the actors after each, the CEM state,
    the lineages and the generator state."""
    tr = PopTrainer(agent, PopulationConfig(size=n, strategy=strategy,
                                            backend="islands"),
                    seed=0, layout=layout)
    out = {"rows": tuple(tr.rows), "actors": [_numpy(tr.actors)],
           "lineage": []}
    for fit in FIT:
        tr.report_fitness(torch.tensor(fit[:n]))
        out["lineage"].append(tr.evolve().tolist())
        out["actors"].append(_numpy(tr.actors))
    state = tr.strategy.checkpoint_state()
    out["cem"] = None if state is None else _cem(state)
    out["gen"] = tr.generator.get_state()
    return out


def _rl_rank(rank, world):
    layout = plan_layout(world, N)
    return {"td3": _rl_run(agent_td3(), "cem", layout),
            "ppo": _rl_run(_ppo_agent(), "cem", layout),
            "dvd": _rl_run(agent_td3(), "dvd", layout)}


# --------------------------------------------------------- the LM runs
def _lm_trainer(layout, ckpt=None, n=LM_N):
    return PopTrainer(_lm_agent(), PopulationConfig(
        size=n, strategy="cem", backend="islands"), seed=0, layout=layout,
        checkpoint_dir=ckpt)


def _params(tr):
    return tr.agent.evolvable_buffer(tr.state).clone().numpy()


def _lm_run(islands, model, ckpt):
    """Bind, evolve on LM_FIT[0] and checkpoint, evolve on LM_FIT[1]: this
    rank's parameter buffer after each, the rank's place, and the whole
    CEM state after each evolve (rank 0's, with model parts)."""
    layout = IslandLayout(devices=islands * model, islands=islands, data=1,
                          model=model, population=LM_N)
    tr = _lm_trainer(layout, ckpt)
    out = {"rows": tuple(tr.rows), "coord": layout.model_coord(),
           "params": [_params(tr)]}
    out["cem"] = []
    for fit in LM_FIT:
        tr.report_fitness(torch.tensor(fit))
        tr.evolve()
        out["params"].append(_params(tr))
        state = tr.strategy.checkpoint_state()
        out["cem"].append(None if state is None else _cem(state))
        if ckpt is not None and len(out["cem"]) == 1:
            tr.save(blocking=True)
    return out


def _resume_run(tr, fit=LM_FIT[1]):
    """One evolve of a restored trainer: its rows and columns after it."""
    tr.report_fitness(torch.tensor(fit))
    tr.evolve()
    return {"rows": tuple(tr.rows), "coord": tr.layout.model_coord()
            if tr.layout is not None else 0, "params": _params(tr),
            "cem": _cem(tr.strategy.export_state())}


def _wait_for(ready, what, timeout=300):
    """Poll ``ready()`` until it is true (another spawn's checkpoint, the
    JAX reference), for at most ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not ready():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {what} after {timeout} s")
        time.sleep(0.2)


def _rank(rank, world, jobs, ref_path):
    """Every job of a spawn on this rank: the RL runs, the LM runs at the
    layouts listed (each checkpointing), a resume at 1 x 2, an elastic
    restore at 8 members over 2 x 2 (of the other spawn's checkpoint,
    once written), and the JAX reference's case (once the subprocess has
    written it)."""
    from repro_torch.checkpoint import CheckpointManager
    cem_mod.CHUNK = CHUNK
    out = {"rl": _rl_rank(rank, world)}
    for name, job in jobs:
        if name == "run":
            for key, ckpt in job:
                out[key] = _lm_run(*LM_LAYOUTS[key], ckpt)
        elif name == "resume":          # at model 2 on one island
            tr = _lm_trainer(IslandLayout(devices=2, islands=1, data=1,
                                          model=2, population=LM_N), job)
            out["resume"] = {"step": tr.resume(), **_resume_run(tr)}
        elif name == "elastic":         # 8 members over 2 x 2 ranks
            _wait_for(lambda: Path(job).is_dir() and CheckpointManager(
                job).latest() is not None, f"checkpoint in {job}")
            tr = _lm_trainer(IslandLayout(devices=4, islands=2, data=1,
                                          model=2, population=8), n=8)
            with pytest.warns(UserWarning, match="by member index"):
                step, lineage = restore_elastic(tr, job)
            out["elastic"] = {"step": step, "lineage": lineage.tolist(),
                              **_resume_run(tr, LM_FIT[1] * 2)}
    ref = Path(ref_path)
    _wait_for(lambda: ref.exists() or Path(ref_path + ".err").exists(),
              "JAX reference")
    if ref.exists():
        with open(ref, "rb") as f:
            out["jax"] = _jax_rank(rank, world, pickle.load(f))
    return out


# ---------------------------------------------- the one-rank references
@pytest.fixture(scope="module")
def one_rank():
    cem_mod.CHUNK, saved = CHUNK, cem_mod.CHUNK
    try:
        return {"td3": _rl_run(agent_td3(), "cem", None),
                "ppo": _rl_run(_ppo_agent(), "cem", None),
                "dvd": _rl_run(agent_td3(), "dvd", None),
                "lm": _lm_run(1, 1, None)}
    finally:
        cem_mod.CHUNK = saved


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX reference subprocess and two spawns, all at once. On 2
    ranks: the RL runs, the LM runs at 2 x 1 and 1 x 2 (each
    checkpointing), the 2 x 1 checkpoint resumed at 1 x 2, and the JAX
    case at islands 1 x model 2. On 4: the RL runs, the LM run at 2 x 2,
    the 1 x 2 checkpoint restored at 8 members, and the JAX case at
    2 x 2."""
    tmp = tmp_path_factory.mktemp("ranks")
    ck = {k: tmp / k for k in LM_LAYOUTS}
    ref_path = tmp / "jax.pkl"
    jax_proc = _start_jax_reference(ref_path)
    # the train CLI under torch.distributed.run on 2 gloo ranks
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *CEM_CLI, "--ckpt-dir", str(tmp / "cli_two")],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jobs = {2: [("run", [("2x1", ck["2x1"]), ("1x2", ck["1x2"])]),
                ("resume", ck["2x1"])],
            4: [("run", [("2x2", ck["2x2"])]), ("elastic", ck["1x2"])]}
    results, errors = {}, []

    def spawn(world):
        try:
            results[world] = run_ranks(_rank, world, tmp, jobs[world],
                                       str(ref_path), timeout=420)
        except BaseException as e:          # raised below
            errors.append(e)
    threads = [threading.Thread(target=spawn, args=(w,)) for w in jobs]
    for t in threads:
        t.start()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        train_main(CEM_CLI + ["--ckpt-dir", str(tmp / "cli_one")])
    printed, cli_err = torchrun.communicate(timeout=600)
    _, stderr = jax_proc.communicate(timeout=600)
    if jax_proc.returncode:
        Path(str(ref_path) + ".err").write_text(stderr)
    for t in threads:
        t.join()
    assert jax_proc.returncode == 0, stderr[-3000:]
    if errors:
        raise errors[0]
    assert torchrun.returncode == 0, printed[-2000:] + cli_err[-3000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    two, four = results[2], results[4]
    pick = lambda outs, key: [r[key] for r in outs]
    return {2: pick(two, "rl"), 4: pick(four, "rl"), "ref": ref,
            "jax": {2: pick(two, "jax"), 4: pick(four, "jax")},
            "lm": {"2x1": pick(two, "2x1"), "1x2": pick(two, "1x2"),
                   "2x2": pick(four, "2x2"), "resume": pick(two, "resume"),
                   "elastic": pick(four, "elastic")},
            "ckpt": ck, "cli": {"one": said.getvalue(), "two": printed,
                                "dirs": (tmp / "cli_one", tmp / "cli_two")}}


# ------------------------------------------------------------ the tests
def test_part_map_cuts_through_leaves():
    """A model rank's PartMap of rwkv6-test against its parts narrowed by
    the rules: the whole member's columns, in chunks of 1,009 (which cut
    through leaves and parts), land where the rank's flat buffer holds
    them, and the parts put back give the whole vector."""
    agent = _lm_agent()
    shapes = agent._lm.param_shapes(agent.cfg)
    rng = np.random.default_rng(0)
    whole = [torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(
        np.float32)) for x in leaves(shapes)]
    vector = torch.cat([x.reshape(-1) for x in whole])
    parts = []
    for coord in range(2):
        shard = ModelShard(coord, 2)
        pm = agent.part_map(shard)
        dims = agent.shard_dims(shapes, shard, lead=0)
        want = torch.cat([
            (x if d is None else x.narrow(d, *(lambda lo, hi: (lo, hi - lo))(
                *shard.bounds(x.shape[d])))).reshape(-1)
            for x, d in zip(whole, dims)])
        assert (pm.whole, pm.local) == (vector.numel(), want.numel())
        assert pm.local < pm.whole and any(d is not None for d in dims)
        assert torch.equal(pm.local_of(vector), want)
        got = torch.full((2, pm.local), float("nan"))
        block = torch.stack([vector, -vector])
        for c in range(0, pm.whole, CHUNK):
            c1 = min(c + CHUNK, pm.whole)
            for (lo, hi), select in pm.pieces(c, c1):
                got[:, lo:hi] = select(block[:, c:c1])
        assert torch.equal(got, torch.stack([want, -want]))
        parts.append(want)
    assert torch.equal(pm.whole_of(parts), vector)
    assert isinstance(pm, PartMap) and agent.part_map(None) is None


@pytest.mark.parametrize("world", [2, 4])
def test_rl_cem_and_dvd_on_ranks_are_one_rank(ranks, one_rank, world):
    """TD3 and PPO under CEM on ``world`` islands: each rank's actors after
    bind and after each evolve are its rows of the one-rank run's, bit for
    bit; the CEM state, the lineage (all -1) and the generator are the
    one-rank run's. DvD over islands is the identity (lineage 0..N-1, the
    actors untouched), as the JAX package's. The train CLI with
    ``--strategy cem --backend islands`` under ``torch.distributed.run``
    on 2 gloo ranks prints the layout and the evolves once (rank 0) and
    writes the one-rank run's checkpoints bit for bit."""
    if world == 2:
        cli = ranks["cli"]
        assert "2 islands, rank 0 holds members 0..1" in cli["two"]
        assert "1 island," in cli["one"]
        evolves = lambda out: [line for line in out.splitlines()
                               if line.startswith("[train] evolve")]
        assert evolves(cli["one"]) == evolves(cli["two"]) == [
            f"[train] evolve at iter {i}: lineage=[-1, -1, -1, -1] "
            f"strategy=CEM" for i in (2, 4)]
        _same_checkpoints(*cli["dirs"])
    for out in ranks[world]:
        for algo in ("td3", "ppo", "dvd"):
            got, want = out[algo], one_rank[algo]
            lo, hi, n = got["rows"]
            assert (hi - lo, n) == (N // world, N)
            for g_stage, w_stage in zip(got["actors"], want["actors"]):
                for g, w in zip(g_stage, w_stage):
                    np.testing.assert_array_equal(g, w[lo:hi])
            assert got["lineage"] == want["lineage"]
            assert torch.equal(got["gen"], want["gen"])
            if algo == "dvd":
                assert got["lineage"] == [list(range(N))] * 2
                for g, w in zip(got["actors"][-1], got["actors"][0]):
                    np.testing.assert_array_equal(g, w)
                continue
            assert got["lineage"] == [[-1] * N] * 2
            for g, w in zip(got["cem"], want["cem"]):
                np.testing.assert_array_equal(g, w)


def _lm_parts(whole, coord, model):
    """The columns of a whole ``(n, P)`` buffer model rank ``coord`` holds
    (its rows taken by the caller)."""
    if model == 1:
        return whole
    pm = _lm_agent().part_map(ModelShard(coord, model))
    return torch.stack([pm.local_of(torch.from_numpy(row))
                        for row in whole]).numpy()


@pytest.mark.parametrize("key", list(LM_LAYOUTS))
def test_lm_cem_on_ranks_is_one_rank(ranks, one_rank, key):
    """rwkv6-test under CEM at islands x model ranks: every rank's rows and
    columns after bind and after each evolve equal the one-rank run's bit
    for bit (the draws at the whole population's and the whole member's
    shape, the refit on the elites broadcast by their owners), and rank
    0's checkpoint state is the whole one-rank state."""
    islands, model = LM_LAYOUTS[key]
    want = one_rank["lm"]
    for rank, out in enumerate(ranks["lm"][key]):
        lo, hi, _ = out["rows"]
        assert (hi - lo) == LM_N // islands
        assert out["coord"] == rank % model
        for got, ref in zip(out["params"], want["params"]):
            np.testing.assert_array_equal(
                got, _lm_parts(ref[lo:hi], out["coord"], model))
        for got, ref in zip(out["cem"], want["cem"]):
            if rank == 0 or model == 1:
                for g, w in zip(got, ref):
                    np.testing.assert_array_equal(g, w)
            else:
                assert got is None


def test_cem_checkpoint_over_ranks_resumes(ranks, one_rank):
    """The 1 x 2 run's checkpoint (model 2) resumes on one rank; the 2 x 1
    run's (model 1) at 1 x 2 over 2 ranks; each then evolves on
    LM_FIT[1] as the uninterrupted one-rank run did, bit for bit, CEM
    state included. ``restore_elastic`` takes the 1 x 2 checkpoint to 8
    members over 2 x 2 ranks (4 -> 8, by member index: a checkpoint made
    after an evolve has no fitness), and its evolve equals the same
    restore and evolve on one rank."""
    cem_mod.CHUNK, saved = CHUNK, cem_mod.CHUNK
    try:
        tr = _lm_trainer(None, ranks["ckpt"]["1x2"])
        assert tr.resume() == -1      # saved before any update step
        one = _resume_run(tr)
        tr8 = _lm_trainer(None, n=8)
        with pytest.warns(UserWarning, match="by member index"):
            _, lineage8 = restore_elastic(tr8, ranks["ckpt"]["1x2"])
        one8 = _resume_run(tr8, LM_FIT[1] * 2)
    finally:
        cem_mod.CHUNK = saved
    want = one_rank["lm"]
    np.testing.assert_array_equal(one["params"], want["params"][-1])
    for g, w in zip(one["cem"], want["cem"][-1]):
        np.testing.assert_array_equal(g, w)
    for out in ranks["lm"]["resume"]:
        assert out["step"] == -1
        np.testing.assert_array_equal(
            out["params"], _lm_parts(want["params"][-1], out["coord"], 2))
    for out in ranks["lm"]["elastic"]:
        lo, hi, _ = out["rows"]
        assert out["lineage"] == lineage8.tolist()
        np.testing.assert_array_equal(
            out["params"], _lm_parts(one8["params"][lo:hi], out["coord"],
                                     2))


def test_dvd_and_cem_refusals_left():
    """The shared critic over islands raises the JAX package's
    ``ValueError`` (a shared critic is replicated, not split), before any
    state is made; CEM and DvD over islands are no longer refused."""
    for strategy in ("dvd", "cem"):
        pcfg = PopulationConfig(size=4, strategy=strategy, backend="islands")
        with pytest.raises(ValueError,
                           match="islands backend requires per-member"):
            PopTrainer(SharedCriticAgent(OBS, ACT, device="cpu"), pcfg)
        tr = PopTrainer(agent_td3(), pcfg)
        assert tr.layout.islands == 1


# ------------------------------------------------- the JAX reference
JAX_CEM = """
import os, pickle, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree
from repro.configs import TrainConfig, get_config
from repro.configs.base import PopulationConfig
from repro.core.population import population_init
from repro.elastic import IslandLayout, plan_layout
from repro.pop import LMAgent, ModuleAgent, PopTrainer
from repro.rl import td3

OBS, ACT = %(obs)d, %(act)d
out = {}
cases = {
    "td3": (ModuleAgent(td3, OBS, ACT), %(n)d, plan_layout(8, %(n)d),
            %(fit)r),
    "lm": (LMAgent(get_config("rwkv6-test"), TrainConfig()), %(lm_n)d,
           IslandLayout(devices=8, islands=4, data=1, model=2,
                        population=%(lm_n)d), %(lm_fit)r)}
for name, (agent, n, layout, fit) in cases.items():
    tr = PopTrainer(agent, PopulationConfig(size=n, strategy="cem",
                                            backend="islands"),
                    seed=1, layout=layout)
    if name == "td3":
        init = population_init(
            lambda k: td3.init(k, OBS, ACT, hidden=(32, 32)),
            jax.random.PRNGKey(3), n)
    else:
        init = jax.vmap(agent.init)(jax.random.split(jax.random.PRNGKey(0),
                                                     n))
    tr.state = layout.place(init, model_rules=name == "lm")
    evolvable = lambda s: agent.evolvable_params(s)
    p = ravel_pytree(jax.tree.map(lambda x: x[0], evolvable(init)))[0].size
    k_bind = jax.random.PRNGKey(7)
    tr.state = tr.strategy.bind(k_bind, agent, tr.state)
    bound = jax.device_get(evolvable(tr.state))
    _, k_evolve = jax.random.split(tr.key)
    tr.report_fitness(jnp.asarray(fit, jnp.float32))
    lineage = tr.evolve()
    out[name] = {
        "init": jax.device_get(init), "bound": bound,
        "new": jax.device_get(evolvable(tr.state)),
        "cem": [np.asarray(x) for x in tr.strategy.cem_state],
        "eps": [np.asarray(jax.random.normal(k, (n, p)))
                for k in (k_bind, k_evolve)],
        "lineage": np.asarray(lineage).tolist(),
        "islands": layout.islands, "model": layout.model,
        "devices": len(jax.devices())}
with open(sys.argv[1] + ".tmp", "wb") as f:
    pickle.dump(out, f)
os.replace(sys.argv[1] + ".tmp", sys.argv[1])
"""


def _start_jax_reference(path):
    """The JAX reference in a subprocess of 8 host devices, writing
    ``path`` when done (renamed into place, so a reader never sees it
    half written)."""
    script = JAX_CEM % dict(obs=OBS, act=ACT, n=N, lm_n=LM_N, fit=FIT[0],
                            lm_fit=LM_FIT[0])
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen([sys.executable, "-c", script, str(path)],
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def _inject(eps, rows):
    """The strategy's samplers fed this rank's rows of JAX's draws, in
    order; returns the undo."""
    draws = iter(torch.from_numpy(e[rows.lo:rows.hi]) for e in eps)
    sample, sample_into = strategy_mod.cem_sample, strategy_mod.cem_sample_into
    strategy_mod.cem_sample = lambda g, s, n: sample(g, s, n,
                                                     eps=next(draws))
    strategy_mod.cem_sample_into = lambda out, g, s, **kw: sample_into(
        out, g, s, eps=next(draws), **kw)

    def undo():
        strategy_mod.cem_sample = sample
        strategy_mod.cem_sample_into = sample_into
    return undo


def _jax_rank(rank, world, ref):
    """The JAX trainer's population and fitness on this rank's islands:
    TD3 on ``world`` islands, rwkv6-test at islands world/2 x model 2;
    rebound and evolved with JAX's draws. Returns the bound and evolved
    rows and columns and the whole CEM state."""
    out = {}
    for name in ("td3", "lm"):
        r = ref[name]
        if name == "td3":
            layout = plan_layout(world, N)
            tr = PopTrainer(agent_td3(), PopulationConfig(
                size=N, strategy="cem", backend="islands"), layout=layout)
            copy_into(tr.state, layout.place(_port_state(r["init"])))
        else:
            layout = IslandLayout(devices=world, islands=world // 2, data=1,
                                  model=2, population=LM_N)
            tr = _lm_trainer(layout)
            whole = _lm_agent().population_init(
                torch.Generator().manual_seed(0), LM_N)
            import jax
            copy_into(whole, [np.asarray(x)
                              for x in jax.tree.leaves(r["init"])])
            copy_into(tr.state, layout.place(whole, model_rules=True))
        undo = _inject(r["eps"], tr.rows)
        tr.state = tr.strategy.bind(tr.generator, tr.agent, tr.state,
                                    over=tr._spread())
        bound = _numpy(tr.agent.evolvable_params(tr.state))
        tr.report_fitness(torch.tensor(FIT[0] if name == "td3"
                                       else LM_FIT[0]))
        lineage = tr.evolve().tolist()
        undo()
        state = tr.strategy.checkpoint_state()
        out[name] = {"rows": tuple(tr.rows), "coord": layout.model_coord(),
                     "bound": bound, "lineage": lineage,
                     "new": _numpy(tr.agent.evolvable_params(tr.state)),
                     "cem": None if state is None else _cem(state),
                     "dims": tr.agent.shard_dims(
                         tr.agent.evolvable_params(tr.state),
                         layout.model_shard()) if name == "lm" else None}
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_refit_matches_jax_islands_trainer(ranks, world):
    """The JAX islands trainer's CEM (TD3 on 8 islands of one member,
    rwkv6-test at islands 4 x model 2) against the port's on ``world``
    gloo ranks (TD3 on ``world`` islands, rwkv6-test at islands world/2 x
    model 2), from the same population, fitness and normal draws: the
    refitted mean, variance and noise at rtol 1e-6, the bound and redrawn
    members at the CEM tolerance, the lineage all -1 on both."""
    import jax
    ref = ranks["ref"]
    assert (ref["td3"]["devices"], ref["td3"]["islands"]) == (8, 8)
    assert (ref["lm"]["islands"], ref["lm"]["model"]) == (4, 2)
    for out in ranks["jax"][world]:
        for name in ("td3", "lm"):
            got, r = out[name], ref[name]
            lo, hi, _ = got["rows"]
            assert got["lineage"] == r["lineage"] == [-1] * len(
                r["lineage"])
            for stage in ("bound", "new"):
                for g, w, d in zip(got[stage], jax.tree.leaves(r[stage]),
                                   got["dims"] or [None] * len(got[stage])):
                    w = np.asarray(w)[lo:hi]
                    if d is not None:
                        per = w.shape[d] // 2
                        w = np.take(w, range(got["coord"] * per,
                                             (got["coord"] + 1) * per),
                                    axis=d)
                    np.testing.assert_allclose(g, w, **CEM_TOL)
            if got["cem"] is not None:
                for g, w in zip(got["cem"], r["cem"]):
                    np.testing.assert_allclose(g, w, **REFIT_TOL)
