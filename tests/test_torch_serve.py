"""The port's serving layer against the JAX package's ``repro.serve``.

Selection (``select_members``, ``rbf_kernel``) must pick exactly the JAX
members; ``ContinuousEvaluator`` must emit the same promote/demote events
from the same checkpoints; ``BatchServer`` answers must match JAX's on
the same serving set and requests (rtol = atol = 1e-5, fp32 sums in
another order); and the CLI entry point serves a JAX-written checkpoint
end to end on the CPU when asked to, and refuses to run without CUDA when
it is not.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import PopulationConfig
from repro.core.dvd import rbf_kernel as jax_rbf_kernel
from repro.envs import make as jax_make
from repro.pop import PopTrainer
from repro.rl import make_agent as jax_make_agent
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import ContinuousEvaluator as JaxEvaluator
from repro.serve import PolicyForward as JaxForward
from repro.serve import make_serving_set as jax_make_serving_set
from repro.serve import probe_observations as jax_probe_observations
from repro.serve import select_members as jax_select_members
from repro.telemetry import LatencyWindow as JaxLatencyWindow
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import from_jax_params
from repro_torch.core.dvd import rbf_kernel
from repro_torch.device import resolve_device
from repro_torch.envs import EnvSpec, make
from repro_torch.launch.serve import main as serve_main
from repro_torch.rl import make_agent
from repro_torch.serve import (BatchServer, ContinuousEvaluator,
                               PolicyForward, make_serving_set,
                               probe_observations, select_members)
from repro_torch.telemetry import LatencyWindow
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _agent():
    return make_agent("td3", make("pendulum").spec, device="cpu")


def _jax_actors(n, key=KEY):
    agent = jax_make_agent("td3", jax_make("pendulum").spec)
    return agent, agent.actor_params(agent.population_init(key, n))


def _obs(b, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 3)).astype(np.float32)


# ------------------------------------------------------------ selection
def test_rbf_kernel_matches_jax():
    emb = np.random.default_rng(1).standard_normal((6, 20)).astype(
        np.float32)
    for scale in (0.5, 1.0, 3.0):
        got = rbf_kernel(torch.from_numpy(emb), length_scale=scale).numpy()
        want = np.asarray(jax_rbf_kernel(emb, length_scale=scale))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weight", [0.0, 1.0, 5.0])
def test_select_members_matches_jax(weight):
    rng = np.random.default_rng(int(weight * 10))
    fitness = rng.standard_normal(8) * 30.0
    emb = rng.standard_normal((8, 32))
    for k in (1, 3, 5, 8):
        for fit, e in ((fitness, emb), (None, emb), (fitness, None)):
            got = select_members(fit, e, k, diversity_weight=weight)
            want = jax_select_members(fit, e, k, diversity_weight=weight)
            np.testing.assert_array_equal(got, want)


def test_select_members_contract():
    assert select_members(np.array([0.0, 5.0, 1.0, 2.0]), np.eye(4),
                          2)[0] == 1
    assert select_members(np.array([0.0, 5.0, 1.0, 2.0]), None,
                          3).tolist() == [1, 3, 2]
    fitness = np.array([1.0, 0.99, 0.5])
    emb = np.array([[0.0, 0.0], [0.01, 0.0], [3.0, 3.0]])
    assert select_members(fitness, emb, 2,
                          diversity_weight=5.0).tolist() == [0, 2]
    assert select_members(fitness, emb, 2,
                          diversity_weight=0.0).tolist() == [0, 1]
    assert select_members(np.array([1.0, 2.0]), None, 10).tolist() == [1, 0]
    with pytest.raises(ValueError):
        select_members(None, None, 2)


def test_make_serving_set_gathers_and_ranks():
    _, actors = _jax_actors(4)
    sset = make_serving_set(from_jax_params(actors), [2, 0], step=7,
                            fitness=np.array([1.0, 9.0, 3.0, 0.0]))
    assert sset.size == 2 and sset.step == 7 and sset.best == 0
    assert sset.fitness.tolist() == [3.0, 1.0]
    np.testing.assert_array_equal(
        sset.params["layer_1"]["w"].numpy(),
        np.asarray(actors["layer_1"]["w"])[[2, 0]])
    assert "step=7" in sset.describe()


# ------------------------------------------------------------ promotion
def _jax_trainer(path, n):
    agent = jax_make_agent("td3", jax_make("pendulum").spec)
    return agent, PopTrainer(agent, PopulationConfig(size=n, strategy="none",
                                                     donate=False),
                             seed=0, checkpoint_dir=str(path))


def test_continuous_evaluator_events_match_jax(tmp_path):
    """The same checkpoints and probes promote the same members in both
    packages, with diversity on, and the same events follow a newer
    checkpoint that reorders fitness."""
    jagent, trainer = _jax_trainer(tmp_path, 6)
    trainer.step_count = 1
    trainer.report_fitness(np.array([9.0, 8.0, 0.0, 1.0, 4.0, 2.5]))
    trainer.save(blocking=True)
    probes = np.asarray(jax_probe_observations(jax_make("pendulum"), KEY, 8))

    theirs = JaxEvaluator(trainer._mgr, jagent, size=3, probe_obs=probes)
    ours = ContinuousEvaluator(CheckpointManager(tmp_path), _agent(),
                               size=3,
                               probe_obs=torch.from_numpy(probes.copy()))
    np.testing.assert_array_equal(ours.poll().members,
                                  theirs.poll().members)
    assert ours.poll() is None                     # unchanged checkpoint

    trainer.step_count = 11
    trainer.report_fitness(np.array([0.0, 1.0, 99.0, 88.0, -5.0, 40.0]))
    trainer.save(blocking=True)
    server = BatchServer(ours.forward, make("pendulum").spec, max_batch=4)
    newer = ours.poll(server)
    theirs.poll()
    assert newer.step == 10 and server.set is newer
    assert ours.events == theirs.events
    assert ours.events[-1]["promoted"] and ours.events[-1]["demoted"]
    server.serve(np.zeros((4, 3), np.float32))


def test_promotion_without_fitness_uses_probes(tmp_path):
    agent = _agent()
    state = agent.population_init(torch.Generator().manual_seed(0), 4)
    CheckpointManager(tmp_path).save(0, (state, {}),
                                     {"size": 4, "fitness": None},
                                     aux={"actors": agent.actor_params(state)})
    probes = probe_observations(make("pendulum"),
                                torch.Generator().manual_seed(0), 8)
    sset = ContinuousEvaluator(CheckpointManager(tmp_path), agent, size=2,
                               probe_obs=probes).poll()
    assert sset.size == 2 and sset.fitness is None
    blind = ContinuousEvaluator(CheckpointManager(tmp_path), agent, size=2)
    with pytest.warns(UserWarning, match="promoting by member index"):
        assert blind.poll().members.tolist() == [0, 1]


# --------------------------------------------------------------- server
def _servers(mode, n=4, max_batch=8, fused=True):
    jagent, actors = _jax_actors(n)
    fitness = np.linspace(0.0, 1.0, n)
    theirs = JaxBatchServer(
        JaxForward.for_agent(jagent), jax_make("pendulum").spec,
        jax_make_serving_set(actors, np.arange(n), step=0, fitness=fitness),
        max_batch=max_batch, mode=mode)
    agent = _agent()
    fwd = (PolicyForward.fused_for_agent(agent) if fused
           else PolicyForward.for_agent(agent))
    ours = BatchServer(fwd, make("pendulum").spec,
                       make_serving_set(from_jax_params(actors),
                                        np.arange(n), step=0,
                                        fitness=fitness),
                       max_batch=max_batch, mode=mode)
    return theirs, ours


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", ["mean", "best"])
def test_batch_server_matches_jax(mode, fused):
    theirs, ours = _servers(mode, fused=fused)
    assert ours.set.best == theirs.set.best == 3
    obs = _obs(8)
    np.testing.assert_allclose(ours.serve(obs), theirs.serve(obs), **TOL)
    long = _obs(19, seed=1)                       # tiled + padded
    np.testing.assert_allclose(ours.serve(long), theirs.serve(long), **TOL)


def test_serve_padding_and_tiling_invariant():
    _, server = _servers("mean", n=2, max_batch=4)
    obs = _obs(10, seed=2)
    full = server.serve(obs)                      # 4 + 4 + 2 (padded)
    assert full.shape == (10, 1)
    np.testing.assert_allclose(server.serve(obs[:3]), full[:3],
                               rtol=1e-6, atol=1e-6)
    one = server.serve(obs[0])
    assert one.shape == (1,)
    np.testing.assert_allclose(one, full[0], rtol=1e-6, atol=1e-6)
    assert server.requests_served == 10 + 3 + 1
    assert server.window.count == 3


def test_submit_flush_warmup_and_modes():
    _, server = _servers("mean", n=2, max_batch=3)
    server.warmup()
    assert server.window.count == 0               # warm-up is no sample
    obs = _obs(3, seed=3)
    assert [server.submit(o) for o in obs] == [0, 1, 2]
    with pytest.raises(ValueError, match="queue full"):
        server.submit(obs[0])
    np.testing.assert_allclose(server.flush(), server.serve(obs),
                               rtol=1e-6, atol=1e-6)
    assert server.flush().shape == (0,)
    assert server.window.summary()["queue_depth_max"] == 3
    spec = make("pendulum").spec
    with pytest.raises(ValueError, match="discrete"):
        BatchServer(server.forward, spec, mode="vote")
    with pytest.raises(ValueError, match="unknown reduction"):
        BatchServer(server.forward, spec, mode="median")
    with pytest.raises(ValueError, match="no ServingSet"):
        BatchServer(server.forward, spec, max_batch=3).serve(obs)


def test_vote_reduction_is_member_plurality():
    """On a discrete action space mean and vote both serve the plurality
    of the members' greedy actions (ties to the lowest action)."""
    votes = torch.tensor([[0, 2, 1, 1], [2, 2, 1, 0], [0, 1, 1, 0]])
    fwd = PolicyForward(None, members_fn=lambda actors, obs: votes)
    spec = EnvSpec("three_actions", 3, 3, True, 10)
    sset = make_serving_set({"w": torch.zeros((3, 1))}, [0, 1, 2])
    for mode in ("vote", "mean"):
        server = BatchServer(fwd, spec, sset, max_batch=4, mode=mode)
        np.testing.assert_array_equal(server.serve(_obs(4)), [0, 2, 1, 0])


def test_latency_window_summary_matches_jax():
    ours, theirs = LatencyWindow(), JaxLatencyWindow()
    for w in (ours, theirs):
        for i, s in enumerate((0.002, 0.001, 0.004, 0.0035)):
            w.add(s, fill=0.25 * (i + 1), requests=i + 1)
        w.observe_queue(5)
    assert ours.summary() == theirs.summary()
    ours.reset()
    assert ours.summary()["p50_ms"] is None


# ------------------------------------------------------------------ CLI
def test_cli_serves_a_jax_checkpoint_on_cpu(tmp_path, capsys):
    """The port's entry point serves a JAX trainer's checkpoint end to
    end on the CPU; its answers equal the JAX ensemble on the same
    serving set and requests."""
    jagent, trainer = _jax_trainer(tmp_path, 6)
    trainer.step_count = 1
    trainer.report_fitness(np.array([3.0, 8.0, 0.0, 1.0, 5.0, 2.0]))
    trainer.save(blocking=True)
    report = serve_main(["--algo", "td3", "--env", "pendulum",
                         "--ckpt-dir", str(tmp_path), "--ensemble", "3",
                         "--mode", "mean", "--fused-linear", "--batch", "16",
                         "--requests", "3", "--poll-every", "2",
                         "--device", "cpu"])
    assert report.requests == 48 and report.req_per_s > 0
    assert report.p99_ms >= report.p50_ms > 0
    assert "req/s" in capsys.readouterr().out
    members = report.server.set.members
    assert members[0] == 1                        # the fittest comes first
    jax_server = JaxBatchServer(
        JaxForward.for_agent(jagent), jax_make("pendulum").spec,
        jax_make_serving_set(trainer.actors, members, step=0),
        max_batch=16, mode="mean")
    assert len(report.batches) == 3
    for obs, actions in report.batches:
        assert actions.shape == (16, 1) and np.isfinite(actions).all()
        assert np.abs(actions).max() <= 1.0
        np.testing.assert_allclose(actions, jax_server.serve(obs), **TOL)


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the refusal cannot show here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main(["--algo", "td3", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_agent("td3", make("pendulum").spec)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_cli_refuses_what_is_not_ported(tmp_path, capsys):
    """musicgen, once refused by name, is served (on the CPU when asked;
    without CUDA the entry point still refuses the default device); the
    refusals of what is not ported stand, and ``--islands`` beside
    ``--arch`` is refused by name."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_main(["--arch", "musicgen_medium", "--ckpt-dir",
                        str(tmp_path)])
    report = serve_main(["--arch", "musicgen_medium", "--smoke", "--device",
                         "cpu", "--batch", "1", "--prompt-len", "4",
                         "--tokens", "2"])
    assert report.tokens.shape == (1, 3)
    with pytest.raises(SystemExit):
        serve_main(["--algo", "td3", "--arch", "x",
                    "--ckpt-dir", str(tmp_path)])
    # --islands serves an --algo ensemble over ranks; beside --arch, whose
    # branch has no islands path, it is refused by name, not a no-op
    with pytest.raises(SystemExit):
        serve_main(["--arch", "rwkv6-test", "--smoke", "--islands",
                    "--device", "cpu"])
    assert "--islands serves an --algo ensemble" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        serve_main(["--algo", "td3", "--ckpt-dir", str(tmp_path),
                    "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown algorithm"):
        make_agent("a2c", make("pendulum").spec, device="cpu")
