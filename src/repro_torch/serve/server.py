"""``BatchServer`` — population-as-ensemble inference
(``repro.serve.server``).

Requests are padded to a fixed batch, every ensemble member's
deterministic forward runs on them, and the reduction across members
follows on the device, so an ensemble answer is one forward over the
stacked members, not ``k`` (with ``PolicyForward.fused_for_agent``: one
``pop_matmul`` launch per layer):

  * ``mean`` — average the member actions (continuous); for discrete
    action spaces this is plurality weight, i.e. identical to ``vote``.
  * ``vote`` — majority vote over the members' greedy actions (discrete).
  * ``best`` — the single fittest member's action.

Fixed padding keeps every launch at one shape whatever the load, as the
JAX package's one compiled executable does. Given ``telemetry``, the
latency window is summarized into one ``serve`` row every
``telemetry_every`` served batches (host bookkeeping around the call).

An ensemble too large for one card is served over ranks, one process a
GPU under ``torch.distributed.run`` (the JAX package ``shard_map``s the
member axis over an islands mesh's ``"pop"`` axis): given ``layout``, an
:class:`~repro_torch.elastic.IslandLayout` over the world's ranks, each
rank holds its island's block of the serving set's members and runs their
forward (with the fused forward, one ``pop_matmul`` launch a layer at
``E / islands`` members). Rank 0 is the one ingress: ``place_request``
broadcasts its padded batch over the world. The reduction is the only
collective across islands, each exact but ``mean``'s float sum:

  * ``mean`` — each rank's sum over its members, all-reduced, over ``E``;
  * ``vote`` (and ``mean`` on a discrete space) — the per-action counts,
    all-reduced;
  * ``best`` — the owner of the fittest member contributes its answer and
    every other rank zeros, all-reduced.

Every rank returns the answer; ``serve``, ``infer_device``, ``flush`` and
``warmup`` are collective, so every rank calls them (the ranks other than
0 may pass ``None`` to ``serve``: rank 0's requests are served).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.distributed import all_reduce, broadcast, world
from repro_torch.serve.ensemble import ServingSet
from repro_torch.serve.forward import PolicyForward
from repro_torch.telemetry import LatencyWindow
from repro_torch.tree import leaves, tree_map

MODES = ("mean", "vote", "best")


class BatchServer:
    """Pads/batches observation requests and answers them with the
    ensemble.

    ``forward`` is the shared :class:`PolicyForward`; ``spec`` the env's
    ``EnvSpec`` (discrete-ness and action arity decide what the reductions
    mean); ``serving_set`` the initial :class:`ServingSet` (install more
    via :meth:`install` as the ``ContinuousEvaluator`` promotes). Requests
    run on the device the serving set's params live on. ``window`` holds
    the latency of every served batch (the warm-up excluded) since the
    last ``serve`` row. ``layout`` (an
    :class:`~repro_torch.elastic.IslandLayout` over the world's ranks)
    serves the set over ranks (module docstring); every set installed
    must then split over its islands.
    """

    def __init__(self, forward: PolicyForward, spec, serving_set=None, *,
                 max_batch: int = 256, mode: str = "mean", telemetry=None,
                 telemetry_every: int = 100, layout=None):
        if mode not in MODES:
            raise ValueError(f"unknown reduction mode {mode!r}; one of "
                             f"{MODES}")
        if mode == "vote" and not spec.discrete:
            raise ValueError(
                f"mode='vote' needs a discrete action space but env "
                f"{spec.name!r} is continuous; use 'mean' or 'best'")
        self.forward = forward
        self.spec = spec
        self.mode = mode
        self.max_batch = max_batch
        self.set: ServingSet | None = None
        self.device = None
        self._pending: list = []
        self.requests_served = 0
        self.window = LatencyWindow()
        self.telemetry = telemetry
        self.telemetry_every = max(1, telemetry_every)
        self._recording = True
        self.layout = layout
        # the ranks that answer together, and the islands the set splits
        # over (the pop group of this rank's column reduces across them)
        self.ranks = world()[1] if layout is not None else 1
        self.islands = layout.islands if layout is not None else 1
        self._group = (layout.mesh.get_group("pop") if self.islands > 1
                       else None)
        self.rows = None      # this rank's slots of the set, (lo, hi)
        if serving_set is not None:
            self.install(serving_set)

    # ---------------------------------------------------------- promotion
    def install(self, serving_set: ServingSet):
        """Swap the ensemble (a ``ContinuousEvaluator`` promotion). Over
        islands the set must tile them (the training backend's rule), and
        this rank keeps its island's block of the members."""
        size = serving_set.size
        if size % self.islands:
            raise ValueError(
                f"serving set of {size} members does not split over "
                f"{self.islands} islands; pick an ensemble size the mesh "
                f"tiles")
        per = size // self.islands
        lo = (self.layout.island_of() * per if self.islands > 1 else 0)
        self.set = serving_set
        self.rows = (lo, lo + per)
        self._params = serving_set.params if per == size else tree_map(
            lambda x: x[lo:lo + per], serving_set.params)
        self.device = leaves(serving_set.params)[0].device
        return self

    # ------------------------------------------------------------ serving
    def _infer(self, obs):
        acts = self.forward.members(self._params, obs)   # (M, B, ...)
        if self.islands > 1:
            return self._reduce_over_islands(acts)
        if self.mode == "best":
            return acts[self.set.best]
        if self.spec.discrete:
            votes = torch.nn.functional.one_hot(
                acts.long(), self.spec.act_dim).sum(0)
            return torch.argmax(votes, dim=-1).to(acts.dtype)
        return acts.mean(0)

    def _reduce_over_islands(self, acts):
        """The reduction of the rank's block ``acts`` (E/islands, B, ...)
        across the islands: the one collective of a served batch."""
        if self.mode == "best":
            lo, hi = self.rows
            best = self.set.best
            out = (acts[best - lo].clone() if lo <= best < hi
                   else torch.zeros_like(acts[0]))
            return all_reduce(out, self._group)
        if self.spec.discrete:
            votes = torch.nn.functional.one_hot(
                acts.long(), self.spec.act_dim).sum(0)
            all_reduce(votes, self._group)
            return torch.argmax(votes, dim=-1).to(acts.dtype)
        return all_reduce(acts.sum(0), self._group) / self.set.size

    def warmup(self):
        """One padded batch of zeros before the first real request (loads
        the kernel library, warms the allocator); not a latency sample."""
        self._recording = False
        try:
            self.serve(np.zeros((1, self.spec.obs_dim), np.float32))
        finally:
            self._recording = True
        return self

    def place_request(self, obs):
        """Explicit request ingress: the padded host batch onto the
        serving device; over ranks, rank 0's batch on every rank (a
        broadcast over the world)."""
        placed = torch.from_numpy(np.ascontiguousarray(obs)).to(self.device)
        if self.ranks > 1:
            broadcast(placed, 0)
        return placed

    def _agree(self, obs):
        """Over ranks: rank 0's request count and arity on every rank, and
        a host batch of that shape (rank 0's values arrive with
        ``place_request``)."""
        head = torch.zeros(2, dtype=torch.int64, device=self.device)
        if world()[0] == 0:
            head[0], head[1] = len(obs), obs.ndim == 1
        count, single = broadcast(head, 0).tolist()
        if world()[0] == 0:
            return obs
        return np.zeros((self.spec.obs_dim,) if single else
                        (count, self.spec.obs_dim), np.float32)

    def infer_device(self, obs):
        """The ensemble call on a device-resident padded batch."""
        if self.set is None:
            raise ValueError("no ServingSet installed: call "
                             "server.install(serving_set) first")
        with torch.inference_mode():
            return self._infer(obs)

    def serve(self, obs=None) -> np.ndarray:
        """Answer a batch of observation requests. ``obs`` is (B, obs_dim)
        (or a single (obs_dim,) request); B beyond ``max_batch`` is served
        in ``max_batch`` tiles, everything smaller is zero-padded up to
        the fixed shape. Over ranks every rank calls it and rank 0's
        ``obs`` is served (the others' is not read)."""
        if self.ranks > 1:
            obs = self._agree(None if obs is None
                              else np.asarray(obs, np.float32))
        obs = np.asarray(obs, np.float32)
        if obs.ndim == 2 and not len(obs):
            return np.zeros((0,))
        single = obs.ndim == 1
        if single:
            obs = obs[None]
        t0 = time.perf_counter()
        outs = []
        tiles = 0
        for i in range(0, len(obs), self.max_batch):
            chunk = obs[i:i + self.max_batch]
            padded = np.zeros((self.max_batch,) + obs.shape[1:], np.float32)
            padded[:len(chunk)] = chunk
            acts = self.infer_device(self.place_request(padded))
            outs.append(acts.cpu().numpy()[:len(chunk)])
            tiles += 1
        self.requests_served += len(obs)
        if self._recording:
            self.window.add(time.perf_counter() - t0,
                            fill=len(obs) / (tiles * self.max_batch),
                            requests=len(obs))
            if (self.telemetry is not None
                    and self.window.count >= self.telemetry_every):
                self.report_telemetry()
        out = np.concatenate(outs, axis=0)
        return out[0] if single else out

    def report_telemetry(self):
        """Emit the latency window as one ``serve`` row (p50/p99, fill,
        queue depth) and start a fresh window. Called every
        ``telemetry_every`` batches; call it once more at shutdown for the
        partial tail."""
        if self.telemetry is None or not self.window.count:
            return
        self.telemetry.record(
            "serve", mode=self.mode, ensemble=getattr(self.set, "size", 0),
            max_batch=self.max_batch, **self.window.summary())
        self.window.reset()

    # ------------------------------------------------- request accumulation
    def submit(self, obs) -> int:
        """Enqueue one observation request; returns its slot in the next
        :meth:`flush`. Refuses to grow past ``max_batch``."""
        if len(self._pending) >= self.max_batch:
            raise ValueError(f"request queue full ({self.max_batch}); "
                             f"flush() first")
        self._pending.append(np.asarray(obs, np.float32))
        self.window.observe_queue(len(self._pending))
        return len(self._pending) - 1

    def flush(self) -> np.ndarray:
        """Serve every queued request as one padded batch -> (queued, ...)
        actions in submission order (over ranks, rank 0's queue, and
        every rank calls it)."""
        if not self._pending:
            if self.ranks == 1:
                return np.zeros((0,))
            batch = np.zeros((0, self.spec.obs_dim), np.float32)
        else:
            batch = np.stack(self._pending)
        self._pending = []
        return self.serve(batch)
