"""The RL ensemble served over ranks: ``BatchServer``'s islands path and
``serve --islands``, on gloo ranks.

The JAX package's ``BatchServer`` over an islands mesh (8 host devices in
one subprocess, as ``tests/test_serve.py``'s islands test: TD3 on
pendulum, 8 members over 8 islands, modes ``mean`` and ``best``; DQN on
cartpole, 4 members over 4 islands of 2 data devices, mode ``vote``) is
held against the port's over 2 and 4 gloo ranks (spawned by
``run_ranks`` of ``test_torch_islands``) on the same members and
requests: ``mean`` and ``best`` at rtol = atol = 1e-5 (fp32 sums and
activations in another library), ``vote`` exactly; ``best`` and ``vote``
also exactly against the port's one-rank server. ``install`` refuses a
set the islands do not tile, with "does not split". Rank 0 is the one
ingress: the others pass no requests and get its answers. A promotion
polled together installs the same set on every rank, re-split over the
islands. The serve CLI with ``--islands`` answers on 2 ranks (inside the
spawn, and under ``torch.distributed.run`` with ``--device cpu``) what a
world of one answers, and rank 0 alone prints. The JAX subprocess, the
spawns and the CLI run go at once.
"""
import json
import os
import pickle
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import from_jax_params
from repro_torch.elastic import plan_layout
from repro_torch.envs import make
from repro_torch.launch.serve import main as serve_main
from repro_torch.rl import make_agent
from repro_torch.serve import (BatchServer, ContinuousEvaluator,
                               PolicyForward, make_serving_set)
from test_torch_islands import run_ranks
from test_torch_islands_cem import _wait_for
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
B, TD3_E, DQN_E = 16, 8, 4
CLI = ["--algo", "td3", "--fused-linear", "--batch", str(B), "--requests",
       "3", "--poll-every", "0", "--ensemble", "4", "--probe", "8",
       "--device", "cpu"]

JAX_SERVE = """
import os, pickle, sys
import jax
import numpy as np
from repro.elastic import plan_layout
from repro.envs import make
from repro.rl import make_agent
from repro.serve import BatchServer, PolicyForward, make_serving_set

out = {"devices": len(jax.devices())}
rng = np.random.default_rng(0)
for algo, env_name, n, modes in (("td3", "pendulum", %(td3)d,
                                  ("mean", "best")),
                                 ("dqn", "cartpole", %(dqn)d, ("vote",))):
    env = make(env_name)
    agent = make_agent(algo, env.spec)
    actors = agent.actor_params(agent.population_init(
        jax.random.PRNGKey(1), n))
    fitness = rng.standard_normal(n)
    sset = make_serving_set(actors, np.arange(n), step=0, fitness=fitness)
    obs = rng.standard_normal((%(b)d, env.spec.obs_dim)).astype(np.float32)
    layout = plan_layout(len(jax.devices()), n)
    case = {"actors": jax.device_get(actors), "fitness": fitness,
            "obs": obs, "islands": layout.islands}
    for mode in modes:
        server = BatchServer(PolicyForward.for_agent(agent), env.spec, sset,
                             max_batch=%(b)d, mode=mode, mesh=layout.mesh)
        case[mode] = np.asarray(server.serve(obs))
    out[algo] = case
with open(sys.argv[1] + ".tmp", "wb") as f:
    pickle.dump(out, f)
os.replace(sys.argv[1] + ".tmp", sys.argv[1])
"""

CASES = (("td3", "pendulum", "mean"), ("td3", "pendulum", "best"),
         ("dqn", "cartpole", "vote"))


def _server(algo, env_name, case, mode, layout=None):
    env = make(env_name)
    agent = make_agent(algo, env.spec, device="cpu")
    sset = make_serving_set(from_jax_params(case["actors"]),
                            np.arange(len(case["fitness"])), step=0,
                            fitness=case["fitness"])
    return BatchServer(PolicyForward.fused_for_agent(agent), env.spec, sset,
                       max_batch=B, mode=mode, layout=layout)


def write_population(ckpt, step, fitness, seed=0):
    """A TD3 population checkpoint as a trainer's save writes it: the
    state, the stacked actors as the "actors" aux tree, size and
    fitness."""
    agent = make_agent("td3", make("pendulum").spec, device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(seed),
                                  len(fitness))
    CheckpointManager(ckpt).save(step, (state, {}),
                                 {"size": len(fitness),
                                  "fitness": list(fitness)},
                                 aux={"actors": agent.actor_params(state)})


def _promote(ckpt, layout):
    """Poll, serve, rank 0 writes a newer checkpoint, poll again, serve:
    the sets installed (members, this rank's slots) and the answers."""
    import torch.distributed as dist
    agent = make_agent("td3", make("pendulum").spec, device="cpu")
    watcher = ContinuousEvaluator(CheckpointManager(ckpt), agent, size=4,
                                  forward=PolicyForward.fused_for_agent(
                                      agent), collective=layout is not None)
    server = BatchServer(watcher.forward, make("pendulum").spec,
                         watcher.poll(), max_batch=B, layout=layout)
    obs = np.random.default_rng(3).standard_normal((B, 3)).astype(
        np.float32)
    rank = dist.get_rank() if layout is not None else 0
    out = {"sets": [(server.set.members.tolist(), server.rows)],
           "answers": [server.serve(obs if rank == 0 else None)]}
    if rank == 0:
        write_population(ckpt, 2, [5.0, -1.0, 0.0, 9.0, 2.0, 8.0, 1.0,
                                   7.0], seed=1)
    if layout is not None:
        dist.barrier()
    newer = watcher.poll(server)
    out["sets"].append((newer.members.tolist(), server.rows))
    out["answers"].append(server.serve(obs if rank == 0 else None))
    out["flush"] = server.flush()
    return out


def _rank(rank, world, ref_path, ckpts):
    """On this rank: the JAX cases over ``plan_layout(world, E)``, the
    refusal of an untileable set, the CLI's run with ``--islands``, and a
    promotion."""
    out = {}
    out["cli"] = serve_main(CLI + ["--islands", "--ckpt-dir",
                                   str(ckpts["cli"])]).batches
    out["promote"] = _promote(ckpts[f"promote{world}"], plan_layout(world,
                                                                    4))
    _wait_for(lambda: Path(ref_path).exists()
              or Path(ref_path + ".err").exists(), "JAX reference")
    if not Path(ref_path).exists():
        return out
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    for algo, env_name, mode in CASES:
        case = ref[algo]
        server = _server(algo, env_name, case, mode,
                         plan_layout(world, len(case["fitness"])))
        out[mode] = {"answers": server.serve(case["obs"] if rank == 0
                                             else None),
                     "rows": server.rows, "islands": server.islands}
    try:
        server.install(make_serving_set(server.set.params, [0, 1, 2]))
    except ValueError as e:
        out["refused"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    fitness = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    ckpts = {k: tmp / k for k in ("cli", "torchrun", "promote2",
                                  "promote4", "promote1")}
    for ckpt in ckpts.values():
        write_population(ckpt, 1, fitness)
    ref_path = tmp / "jax.pkl"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SERVE % dict(td3=TD3_E, dqn=DQN_E, b=B),
         str(ref_path)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node", "2", "-m", "repro_torch.launch.serve"]
    cli_env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   OMP_NUM_THREADS="1")
    torchrun = subprocess.Popen(
        launch + CLI + ["--islands", "--ckpt-dir", str(ckpts["torchrun"])],
        env=cli_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    results, errors = {}, []

    def spawn(world):
        try:
            results[world] = run_ranks(_rank, world, tmp, str(ref_path),
                                       ckpts, timeout=420)
        except BaseException as e:          # raised below
            errors.append(e)
    threads = [threading.Thread(target=spawn, args=(w,)) for w in (2, 4)]
    for t in threads:
        t.start()
    _, stderr = jax_proc.communicate(timeout=600)
    if jax_proc.returncode:
        Path(str(ref_path) + ".err").write_text(stderr)
    for t in threads:
        t.join()
    printed, cli_err = torchrun.communicate(timeout=600)
    assert jax_proc.returncode == 0, stderr[-3000:]
    if errors:
        raise errors[0]
    assert torchrun.returncode == 0, printed[-2000:] + cli_err[-3000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return {"ref": ref, "ranks": results, "printed": printed,
            "ckpts": ckpts, "promote": _promote(ckpts["promote1"], None)}


@pytest.mark.parametrize("world", [2, 4])
def test_served_over_ranks_matches_jax_islands_server(runs, world):
    """Each mode over ``world`` gloo ranks against the JAX package's
    ``BatchServer`` over its islands mesh: ``mean`` and ``best`` at
    rtol = atol = 1e-5, ``vote`` exactly; ``best`` and ``vote`` exactly
    the port's one-rank server's; every rank returns the answer; each rank
    holds its island's block of the set."""
    ref = runs["ref"]
    assert ref["devices"] == 8
    assert (ref["td3"]["islands"], ref["dqn"]["islands"]) == (8, 4)
    for algo, env_name, mode in CASES:
        case = ref[algo]
        one = _server(algo, env_name, case, mode).serve(case["obs"])
        n = len(case["fitness"])
        for rank, out in enumerate(runs["ranks"][world]):
            got = out[mode]
            islands = plan_layout(world, n).islands
            per = n // islands
            island = rank // (world // islands)
            assert got["islands"] == islands
            assert got["rows"] == (island * per, (island + 1) * per)
            if mode == "mean":
                np.testing.assert_allclose(got["answers"], case[mode],
                                           **TOL)
                np.testing.assert_allclose(got["answers"], one, **TOL)
            elif mode == "best":
                np.testing.assert_allclose(got["answers"], case[mode],
                                           **TOL)
                np.testing.assert_array_equal(got["answers"], one)
            else:
                np.testing.assert_array_equal(got["answers"], case[mode])
                np.testing.assert_array_equal(got["answers"], one)


def test_install_refuses_a_set_the_islands_do_not_tile(runs):
    """A serving set of 3 over 2 and 4 islands is refused at install,
    with the JAX package's words."""
    for world in (2, 4):
        for out in runs["ranks"][world]:
            assert re.search(rf"serving set of 3 members does not split "
                             rf"over {world} islands", out["refused"])


@pytest.mark.parametrize("world", [2, 4])
def test_promotion_resplits_the_set_on_every_rank(runs, world):
    """Polled together, both promotions install rank 0's selection on
    every rank, each rank its island's slots of it, and the answers equal
    the same polls and serves on one rank; a flush with nothing queued
    returns nothing on every rank."""
    one = runs["promote"]
    per = 4 // world
    for rank, out in enumerate(runs["ranks"][world]):
        promoted = out["promote"]
        for (members, rows), (want, _) in zip(promoted["sets"],
                                              one["sets"]):
            assert members == want
            assert rows == (rank * per, (rank + 1) * per)
        assert one["sets"][0][0] != one["sets"][1][0]
        for got, want in zip(promoted["answers"], one["answers"]):
            np.testing.assert_allclose(got, want, **TOL)
        assert promoted["flush"].shape == (0,)


def test_serve_cli_islands_in_ranks_answers_as_one_rank(runs):
    """``repro_torch.launch.serve.main(... --islands)`` on 2 and 4 ranks
    (the spawn's group) answers rank 0's requests with what a world of
    one answers on the same checkpoint, on every rank."""
    want = serve_main(CLI + ["--islands", "--ckpt-dir",
                             str(runs["ckpts"]["cli"])]).batches
    for world in (2, 4):
        for rank, out in enumerate(runs["ranks"][world]):
            assert len(out["cli"]) == len(want) == 3
            for (obs, got), (w_obs, w_got) in zip(out["cli"], want):
                if rank == 0:
                    np.testing.assert_array_equal(obs, w_obs)
                else:
                    assert obs is None
                np.testing.assert_allclose(got, w_got, **TOL)


def test_serve_cli_islands_under_torch_distributed_run(runs, capsys):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.serve --algo td3 --islands --device cpu``: rank 0
    alone prints the layout (2 islands over a gloo group), the set and
    the report, and its last actions are a world of one's; a plain run
    with ``--islands`` is one island."""
    printed = runs["printed"]
    assert printed.count("[serve] algo=td3") == 1
    assert ("IslandLayout(devices=2, islands=2, data=1, model=1, "
            "population=4" in printed)
    assert "process group gloo over 2 ranks" in printed
    assert printed.count("requests in") == 1
    serve_main(CLI + ["--islands", "--ckpt-dir",
                      str(runs["ckpts"]["torchrun"])])
    alone = capsys.readouterr().out
    assert "1 island, rank 0 serves slots 0..3" in alone
    assert "no process group" in alone
    last = lambda text: re.search(r"last actions\[:2\] = (.*)", text)[1]
    np.testing.assert_allclose(np.array(json.loads(last(printed))),
                               np.array(json.loads(last(alone))), **TOL)
