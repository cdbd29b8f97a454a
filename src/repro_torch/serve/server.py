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
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.serve.ensemble import ServingSet
from repro_torch.serve.forward import PolicyForward
from repro_torch.telemetry import LatencyWindow
from repro_torch.tree import leaves

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
    last ``serve`` row.
    """

    def __init__(self, forward: PolicyForward, spec, serving_set=None, *,
                 max_batch: int = 256, mode: str = "mean", telemetry=None,
                 telemetry_every: int = 100):
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
        if serving_set is not None:
            self.install(serving_set)

    # ---------------------------------------------------------- promotion
    def install(self, serving_set: ServingSet):
        """Swap the ensemble (a ``ContinuousEvaluator`` promotion)."""
        self.set = serving_set
        self._params = serving_set.params
        self.device = leaves(serving_set.params)[0].device
        return self

    # ------------------------------------------------------------ serving
    def _infer(self, obs):
        acts = self.forward.members(self._params, obs)   # (M, B, ...)
        if self.mode == "best":
            return acts[self.set.best]
        if self.spec.discrete:
            votes = torch.nn.functional.one_hot(
                acts.long(), self.spec.act_dim).sum(0)
            return torch.argmax(votes, dim=-1).to(acts.dtype)
        return acts.mean(0)

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
        serving device."""
        return torch.from_numpy(np.ascontiguousarray(obs)).to(self.device)

    def infer_device(self, obs):
        """The ensemble call on a device-resident padded batch."""
        if self.set is None:
            raise ValueError("no ServingSet installed: call "
                             "server.install(serving_set) first")
        with torch.inference_mode():
            return self._infer(obs)

    def serve(self, obs) -> np.ndarray:
        """Answer a batch of observation requests. ``obs`` is (B, obs_dim)
        (or a single (obs_dim,) request); B beyond ``max_batch`` is served
        in ``max_batch`` tiles, everything smaller is zero-padded up to
        the fixed shape."""
        obs = np.asarray(obs, np.float32)
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
        actions in submission order."""
        if not self._pending:
            return np.zeros((0,))
        batch = np.stack(self._pending)
        self._pending = []
        return self.serve(batch)
