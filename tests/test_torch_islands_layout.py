"""Island layouts, population placement and member-axis draws against the
JAX package.

``plan_grid`` and ``plan_layout`` are compared with the JAX package's on a
grid of (devices, population, preferred_model), warnings included; the
layout's validation errors word for word. ``population_sharding``'s
split/replicate decisions are compared with JAX's ``PartitionSpec`` on 8
fake devices (JAX in a subprocess with 8 forced host devices; the port's
meshes over a fake process group of 8 ranks, torn down after).
``make_production_mesh`` is refused below 256 ranks. A rank's rows,
owners and placement follow the layout, and ``member_draw`` keeps the
rows of the whole population's draw.
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.elastic import layout as jax_layout
from repro_torch.core.distributed import (Rows, member_draw,
                                          member_generator,
                                          population_rows,
                                          population_sharding)
from repro_torch.elastic import IslandLayout, layout as port_layout
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("devices", "islands", "data", "model", "population")


def _caught(fn, *args, **kw):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            out = fn(*args, **kw)
        except ValueError as e:
            out = ("raised", str(e))
    return out, [str(w.message) for w in seen]


def test_plan_layout_matches_jax_on_a_grid():
    cases = 0
    for devices in range(1, 13):
        for population in (1, 2, 3, 4, 6, 8, 12, 20, 80):
            for preferred in (1, 2, 3, 4, 16):
                got, got_w = _caught(port_layout.plan_layout, devices,
                                     population, preferred_model=preferred)
                want, want_w = _caught(jax_layout.plan_layout, devices,
                                       population, preferred_model=preferred)
                assert got_w == want_w
                assert tuple(getattr(got, f) for f in FIELDS) == \
                    tuple(getattr(want, f) for f in FIELDS)
                assert got.members_per_island == want.members_per_island
                cases += 1
    assert cases == 12 * 9 * 5
    # the paper's setup: 80 agents on 4 accelerators, 20 a member group
    paper = port_layout.plan_layout(4, 80)
    assert (paper.islands, paper.members_per_island) == (4, 20)


def test_plan_grid_matches_jax_with_its_warnings():
    for devices in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 256, 512):
        for preferred in (1, 2, 4, 8, 16, 32):
            for multi_pod in (False, True):
                kw = dict(preferred_model=preferred, multi_pod=multi_pod)
                assert _caught(port_layout.plan_grid, devices, **kw) == \
                    _caught(jax_layout.plan_grid, devices, **kw)


def test_layout_validation_errors_match_jax():
    bad = (dict(devices=4, islands=2, data=1, model=1, population=4),
           dict(devices=4, islands=4, data=1, model=1, population=6),
           dict(devices=2, islands=2, data=1, model=1, population=2,
                device_ids=(0, 1, 2)),
           dict(devices=2, islands=2, data=1, model=1, population=2,
                device_ids=(1, 1)))
    for kw in bad:
        got, _ = _caught(IslandLayout, **kw)
        want, _ = _caught(jax_layout.IslandLayout, **kw)
        assert got[0] == want[0] == "raised"
        # the port's repr names device_ids as the JAX one does
        assert got[1] == want[1]
    for args, kw in (((0, 4), {}), ((2, 0), {}),
                     ((3, 4), {"devices": [0, 1]})):
        got, _ = _caught(port_layout.plan_layout, *args, **kw)
        want, _ = _caught(jax_layout.plan_layout, *args, **kw)
        assert got == want and got[0] == "raised"


JAX_SPECS = """
import json
import jax
import numpy as np
from repro import compat
from repro.core.distributed import population_sharding

meshes = {"data8": ((8, 1), ("data", "model")),
          "data4": ((4, 2), ("data", "model")),
          "pod": ((2, 2, 2), ("pod", "data", "model"))}
trees = {"n8": [(8, 3), (8,), (6, 2), (), (16, 4)],
         "n6": [(6, 3), (6,), (8, 2)],
         "n16": [(16, 2), (16,), (8, 2)]}
out = {}
for m, (shape, axes) in meshes.items():
    mesh = compat.make_mesh(shape, axes)
    for t, shapes in trees.items():
        tree = [np.zeros(s, np.float32) for s in shapes]
        specs = population_sharding(tree, mesh)
        # the axes each leaf's population axis splits over, flattened
        out[m + "/" + t] = [[a for e in s.spec
                             for a in (e if isinstance(e, tuple) else (e,))]
                            for s in specs]
print(json.dumps(out))
"""

_MESHES = {"data8": ((8, 1), ("data", "model")),
           "data4": ((4, 2), ("data", "model")),
           "pod": ((2, 2, 2), ("pod", "data", "model"))}
_TREES = {"n8": [(8, 3), (8,), (6, 2), (), (16, 4)],
          "n6": [(6, 3), (6,), (8, 2)],
          "n16": [(16, 2), (16,), (8, 2)]}


@pytest.fixture
def fake_world_of_8():
    """A fake process group of 8 ranks (this process rank 0), torn down
    after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def test_population_sharding_matches_jax_specs(fake_world_of_8):
    from torch.distributed.tensor import Shard
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", JAX_SPECS], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    from repro_torch.launch.mesh import build_mesh
    for m, (shape, axes) in _MESHES.items():
        mesh = build_mesh(shape, axes)
        split_axes = [a for a in ("pod", "data") if a in axes]
        for t, shapes in _TREES.items():
            tree = [torch.zeros(s) for s in shapes]
            got = [split_axes if p == Shard(0) else []
                   for p in population_sharding(tree, mesh)]
            assert got == want[m + "/" + t], (m, t)
        # rank 0 holds the first block of a split population
        size = int(np.prod([shape[axes.index(a)] for a in split_axes]))
        assert population_rows(mesh, 16) == Rows(0, 16 // size, 16)
        assert population_rows(mesh, 6) == (Rows(0, 6, 6) if 6 % size
                                            else Rows(0, 6 // size, 6))


def test_production_mesh_refused_below_256_and_host_meshes(
        fake_world_of_8):
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs a world of {need} "
                           f"ranks; this one has 8"):
            make_production_mesh(multi_pod=multi_pod)
    mesh = make_host_mesh(model=2)
    assert (mesh.mesh_dim_names, tuple(mesh.shape)) == (("data", "model"),
                                                        (4, 2))
    mesh = make_host_mesh(model=2, pod=2)
    assert (mesh.mesh_dim_names, tuple(mesh.shape)) == (
        ("pod", "data", "model"), (2, 2, 2))
    lay = port_layout.plan_layout(8, 4)
    assert (lay.islands, lay.data) == (4, 2)
    assert lay.mesh.mesh_dim_names == ("pop", "data", "model")
    assert tuple(lay.mesh.shape) == (4, 2, 1) and lay.mesh is lay.mesh
    with pytest.raises(ValueError, match=r"plan_layout\(8, 4\)"):
        _ = port_layout.plan_layout(4, 4).mesh


def test_rows_owners_and_placement():
    lay = port_layout.plan_layout(4, 6)          # gcd: 2 islands x 2 data
    assert (lay.islands, lay.data, lay.members_per_island) == (2, 2, 3)
    assert [lay.rows(r) for r in range(4)] == [
        Rows(0, 3, 6), Rows(0, 3, 6), Rows(3, 6, 6), Rows(3, 6, 6)]
    assert [lay.owner(m) for m in range(6)] == [0, 0, 0, 1, 1, 1]
    assert (lay.rank_of(1), lay.rank_of(1, 1)) == (2, 3)
    pinned = port_layout.plan_layout(0, 4, devices=[3, 1, 0, 2])
    assert [pinned.island_of(r) for r in (3, 1, 0, 2)] == [0, 1, 2, 3]
    assert pinned.rows(0) == Rows(2, 3, 4) and pinned.rank_of(3) == 2
    tree = {"w": torch.arange(24.0).reshape(6, 4), "c": torch.ones(3),
            "s": torch.tensor(2.0)}
    placed = lay.place(tree, rank=2)
    assert torch.equal(placed["w"], tree["w"][3:])
    assert placed["c"] is tree["c"] and placed["s"] is tree["s"]
    assert placed["w"]._base is None            # its own tensor
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sharded_model = port_layout.plan_layout(4, 4, preferred_model=2)
    # a model axis of 2: without the rules (RL) both model ranks of an
    # island hold its members whole; with them a ruled leaf is cut
    assert sharded_model.model == 2 and sharded_model.islands == 2
    four = {"w": torch.arange(16.0).reshape(4, 4)}
    for r in (2, 3):
        assert torch.equal(sharded_model.place(four, rank=r)["w"],
                           four["w"][2:])
    ruled = {"wq": {"w": torch.arange(4 * 3 * 8.0).reshape(4, 3, 8)},
             "bonus": torch.ones(4, 2, 5)}
    for r, cols in ((2, slice(0, 4)), (3, slice(4, 8))):
        cut = sharded_model.place(ruled, rank=r, model_rules=True)
        assert torch.equal(cut["wq"]["w"], ruled["wq"]["w"][2:, :, cols])
        assert cut["wq"]["w"].is_contiguous()
        assert torch.equal(cut["bonus"], ruled["bonus"][2:])


def test_member_draw_keeps_the_rows_of_the_whole_draw():
    rows = Rows(4, 6, 8)
    full = torch.Generator().manual_seed(7)
    mine = member_generator("cpu", rows).manual_seed(7)
    assert type(member_generator("cpu", Rows(0, 8, 8))) is torch.Generator
    # members first, a steps axis first, and an env axis of 3 a member
    for shape, axis, take in (((2, 5), 0, (slice(4, 6),)),
                              ((3, 2, 4), 1, (slice(None), slice(4, 6))),
                              ((6, 2), 0, (slice(12, 18),))):
        whole = list(shape)
        whole[axis] = whole[axis] // rows.count * rows.n
        want = torch.rand(whole, generator=full)[take]
        assert torch.equal(member_draw(torch.rand, shape, mine, axis=axis),
                           want)
    assert torch.equal(mine.get_state(), full.get_state())
    with pytest.raises(ValueError, match="does not split"):
        member_draw(torch.rand, (3, 2), mine)
