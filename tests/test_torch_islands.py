"""The ``islands`` backend over several gloo ranks against the port's
vectorized update and the JAX package's ``islands`` backend.

Each multi-rank case spawns gloo ranks with ``torch.multiprocessing``
(``run_ranks``, which the other island test files import): the ranks meet
through a ``FileStore`` under the test's ``tmp_path`` (no TCP port, so
parallel workers never collide) and every spawn has a join deadline, so
a hang fails the test instead of eating the suite's clock. A rank holds
its island's rows; its generator is the trainer's ``member_generator``,
whose member-axis draws are made at the whole population's shape, so the
update on K ranks is the one-rank update of those members: compared at
rtol = atol = 1e-6 (and bit for bit where seen). The JAX reference with 8
devices runs in a subprocess with ``XLA_FLAGS`` forcing 8 host devices,
as ``tests/test_elastic.py`` does; its state crosses through
``repro_torch.convert`` and its noise is injected, at the JAX test's 1e-5
(``ISLANDS_NUMERICS``). Small widths: hidden (32, 32), N = 8, B = 16.
"""
import os
import pickle
import subprocess
import sys
import time
import traceback
import uuid
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import PopulationConfig
from repro_torch.core.distributed import member_generator, take_rows
from repro_torch.core.hyperparams import sample_hypers
from repro_torch.elastic import plan_layout
from repro_torch.launch.mesh import leave_distributed
from repro_torch.pop import ModuleAgent, PopTrainer
from repro_torch.pop.backend import make_update
from repro_torch.rl import get_algo, td3
from repro_torch.tree import leaves
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401
from test_torch_td3_update import _port_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, B, OBS, ACT, HIDDEN = 8, 16, 3, 1, (32, 32)
SPACE = get_algo("td3").hyper_space
TOL = dict(rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- the ranks
def _rank_main(fn, rank, world, store, out, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=120))
        result = fn(rank, world, *args)
        leave_distributed()
        torch.save(result, out)
    except BaseException:
        Path(out + ".err").write_text(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, world, tmp_path, *args, timeout=240):
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks; their
    results in rank order. A rank that raises fails the call with its
    traceback; ranks still alive at ``timeout`` seconds are killed and
    fail it too."""
    ctx = mp.get_context("spawn")
    tag = uuid.uuid4().hex[:8]
    store = str(tmp_path / f"store-{tag}")
    outs = [str(tmp_path / f"rank{r}-{tag}.pt") for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, outs[r], args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [Path(o + ".err").read_text() for o in outs
              if Path(o + ".err").exists()]
    assert not errors, errors[0]
    assert not hung, f"ranks {hung} still running after {timeout} s"
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(o, weights_only=False) for o in outs]


def agent_td3():
    return ModuleAgent(td3, OBS, ACT, device="cpu", hidden=HIDDEN)


def td3_batches(steps, n=N, seed=0):
    rng = np.random.default_rng(seed)
    shape = (steps, n, B)
    return {"obs": rng.standard_normal(shape + (OBS,)).astype(np.float32),
            "action": rng.uniform(-1, 1, shape + (ACT,)).astype(np.float32),
            "reward": rng.standard_normal(shape).astype(np.float32),
            "next_obs": rng.standard_normal(shape + (OBS,)).astype(
                np.float32),
            "done": (rng.random(shape) < 0.2).astype(np.float32)}


def _numpy(tree):
    return [x.detach().numpy() for x in leaves(tree)]


def _update_rank(rank, world, steps):
    layout = plan_layout(world, N)
    rows = layout.rows()
    agent = agent_td3()
    state = agent.population_init(torch.Generator().manual_seed(0), N,
                                  rows=rows)
    batches = {k: torch.from_numpy(v[:, rows.lo:rows.hi])
               for k, v in td3_batches(steps).items()}
    hypers = take_rows(sample_hypers(torch.Generator().manual_seed(2),
                                     SPACE, N), rows)
    gen = member_generator("cpu", rows).manual_seed(1)
    update = make_update(agent, "islands", num_steps=steps,
                         mesh=layout.mesh)
    new, metrics = update(state, batches, hypers, gen)
    return {"rows": tuple(rows), "islands": layout.islands,
            "state": _numpy(new), "metrics": _numpy(metrics),
            "gen": gen.get_state()}


def _vectorized(steps):
    agent = agent_td3()
    state = agent.population_init(torch.Generator().manual_seed(0), N)
    batches = {k: torch.from_numpy(v if steps > 1 else v[0])
               for k, v in td3_batches(steps).items()}
    hypers = sample_hypers(torch.Generator().manual_seed(2), SPACE, N)
    gen = torch.Generator().manual_seed(1)
    new, metrics = make_update(agent, "vectorized", num_steps=steps)(
        state, batches, hypers, gen)
    return _numpy(new), _numpy(metrics), gen.get_state()


@pytest.mark.parametrize("world", [2, 4])
def test_td3_update_on_ranks_matches_vectorized(tmp_path, world):
    """Two chained steps (each draws its target-smoothing noise) on 2 and 4
    islands equal the vectorized update of the same members; the
    generators end in the same state."""
    want, want_m, want_gen = _vectorized(2)
    outs = run_ranks(_update_rank, world, tmp_path, 2)
    exact = True
    for out in outs:
        lo, hi, _ = out["rows"]
        assert out["islands"] == world and hi - lo == N // world
        for got, ref in zip(out["state"] + out["metrics"], want + want_m):
            np.testing.assert_allclose(got, ref[lo:hi], **TOL)
            exact &= np.array_equal(got, ref[lo:hi])
        assert torch.equal(out["gen"], want_gen)
    assert exact     # on the CPU every island is the vectorized run's


ISLANDS_STEPS = """
import pickle, sys
import jax, jax.numpy as jnp
import numpy as np
from repro.configs.base import HyperSpace
from repro.core.hyperparams import sample_hypers
from repro.core.population import population_init
from repro.elastic import plan_layout
from repro.pop import ModuleAgent
from repro.pop.backend import make_update
from repro.rl import td3

N, B, OBS, ACT = 8, 16, 3, 1
space = HyperSpace(log_uniform=(("actor_lr", 3e-5, 3e-3),
                                ("critic_lr", 3e-5, 3e-3)),
                   uniform=(("noise", 0.0, 0.5),))
state = population_init(lambda k: td3.init(k, OBS, ACT, hidden=(32, 32)),
                        jax.random.PRNGKey(3), N)
hypers = sample_hypers(jax.random.PRNGKey(5), space, N)
ks = jax.random.split(jax.random.PRNGKey(1), 5)
batch = {"obs": jax.random.normal(ks[0], (N, B, OBS)),
         "action": jax.random.uniform(ks[1], (N, B, ACT), minval=-1,
                                      maxval=1),
         "reward": jax.random.normal(ks[2], (N, B)),
         "next_obs": jax.random.normal(ks[3], (N, B, OBS)),
         "done": jnp.zeros((N, B))}
layout = plan_layout(len(jax.devices()), N)
update = make_update(ModuleAgent(td3, OBS, ACT), "islands", donate=False,
                     mesh=layout.mesh)
out = {"init": jax.device_get(state), "hypers": jax.device_get(hypers),
       "batch": jax.device_get(batch), "devices": len(jax.devices()),
       "islands": layout.islands}
for _ in range(2):
    state, _ = update(state, batch, hypers)
out["final"] = jax.device_get(state)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _jax_islands(path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", ISLANDS_STEPS, str(path)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _jax_rank(rank, world, ref, noise):
    layout = plan_layout(world, N)
    rows = layout.rows()
    state = take_rows(_port_state(ref["init"]), rows)
    hypers = {k: torch.from_numpy(np.asarray(v)[rows.lo:rows.hi])
              for k, v in ref["hypers"].items()}
    batch = {k: torch.from_numpy(np.asarray(v)[rows.lo:rows.hi])
             for k, v in ref["batch"].items()}
    update = make_update(agent_td3(), "islands", mesh=layout.mesh)
    gen = member_generator("cpu", rows).manual_seed(0)
    for k in range(2):
        state, _ = update(state, batch, hypers, gen, noise=torch.from_numpy(
            noise[k][rows.lo:rows.hi]))
    return {"rows": tuple(rows), "state": state}


def _jax_noise(key, steps):
    """The target-smoothing draws of ``steps`` JAX updates from the
    members' keys (the per-member update's in-step split)."""
    import jax
    from repro.rl.fused import pop_split
    out = []
    for _ in range(steps):
        key, kc = pop_split(key)
        out.append(np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (B, ACT)))(kc)))
    return np.stack(out)


def test_islands_update_matches_jax_islands(tmp_path):
    """The port on 2 ranks against JAX's ``islands`` backend on 8 fake
    devices (8 islands of one member): the JAX state converted, the same
    batch and the target-smoothing noise JAX draws, 2 steps, at 1e-5."""
    import jax
    ref = _jax_islands(tmp_path / "jax.pkl")
    assert (ref["devices"], ref["islands"]) == (8, 8)
    noise = _jax_noise(jax.numpy.asarray(ref["init"].key), 2)
    outs = run_ranks(_jax_rank, 2, tmp_path, ref, noise)
    want = _port_state(ref["final"])
    for out in outs:
        lo, hi, _ = out["rows"]
        for got, w in zip(leaves(out["state"]), leaves(want)):
            np.testing.assert_allclose(got.numpy(), w.numpy()[lo:hi],
                                       rtol=1e-5, atol=1e-5)


def test_islands_in_process_is_one_island(tmp_path):
    """Without a process group the islands backend plans one island over
    the world of one, as JAX's one-device run does, and its update is the
    vectorized one bit for bit; the sharded backend likewise."""
    want, want_m, _ = _vectorized(1)
    for backend in ("islands", "sharded"):
        pcfg = PopulationConfig(size=N, backend=backend, hyper_space=SPACE)
        tr = PopTrainer(agent_td3(), pcfg, seed=0)
        assert tr.layout.islands == 1 and tr.mesh is None
        assert not tr.split and type(tr.generator) is torch.Generator
        assert tuple(tr.rows) == (0, N, N)
        update = make_update(agent_td3(), backend)
        state = agent_td3().population_init(
            torch.Generator().manual_seed(0), N)
        batch = {k: torch.from_numpy(v[0])
                 for k, v in td3_batches(1).items()}
        hypers = sample_hypers(torch.Generator().manual_seed(2), SPACE, N)
        new, metrics = update(state, batch, hypers,
                              torch.Generator().manual_seed(1))
        for got, ref in zip(_numpy(new) + _numpy(metrics), want + want_m):
            np.testing.assert_array_equal(got, ref)


def _plain_generator_rank(rank, world):
    layout = plan_layout(world, N)
    update = make_update(agent_td3(), "islands", mesh=layout.mesh)
    rows = layout.rows()
    state = agent_td3().population_init(torch.Generator().manual_seed(0), N,
                                        rows=rows)
    batch = {k: torch.from_numpy(v[0, rows.lo:rows.hi])
             for k, v in td3_batches(1).items()}
    try:
        update(state, batch, None, torch.Generator())
    except ValueError as e:
        return str(e)
    return None


def test_population_level_agents_and_plain_generators_refused(tmp_path):
    """A shared critic is replicated, not split over islands: the islands
    and sharded backends refuse it, as the JAX package's do; an island's
    update on a mesh of 2 refuses a generator that does not carry its
    rows (its draws would not be the one-rank run's)."""
    from repro_torch.pop import SharedCriticAgent
    agent = SharedCriticAgent(OBS, ACT, device="cpu")
    with pytest.raises(ValueError, match="requires per-member agents"):
        make_update(agent, "islands")
    with pytest.raises(ValueError, match="requires per-member agents"):
        make_update(agent, "sharded")
    said = run_ranks(_plain_generator_rank, 2, tmp_path)
    assert all("needs the generator of its rows" in s for s in said)
