"""Overlapped acting (``repro.rollout.overlap``): the iteration split into a
collect half and an update half, pipelined across iterations.

    collect(actors, vstate, hypers) -> (vstate, slot, episode_stats)
    update(state, bufs, slot, hypers) -> (state, bufs, metrics, did)

The ``slot`` is one collect's experience in flight between the two.
``policy_lag`` sets the staleness:

  ``lag=0`` collect(t), then update(t) on its slot, one after the other:
      the serial engine's iteration itself, so the results equal it bit
      for bit.
  ``lag=1`` after a one-collect prologue, update(t) consumes the slot
      collected at t-1, and collect(t+1) acts with ``actors(state_t)``,
      taken before update(t) runs: acting is exactly one update behind
      the learner. For PPO the stored ``log_prob`` extras are the
      importance weights that correct for it.

On the card, at ``lag=1``, collect runs on a second CUDA stream: the host
enqueues update(t) on the current stream and collect(t+1) on the side
stream, which waits only for what update(t-1) wrote (an event recorded
before update(t) is enqueued), so the two run at once. update(t+1) waits
on the event recorded after collect(t+1). Every tensor one stream made
and the other reads is held with ``record_stream``, so the allocator does
not hand its memory out again before the reader is done. Both streams
draw from one generator; its offsets advance on the host in enqueue
order, so the draws do not depend on how the streams interleave.

``chunk_steps`` acts the lag-1 collect in chunks written into the slot
as they are made (the slot itself is in flight, so it is whole; the
results are unchanged), as the JAX engine's collect does.

``build_epoch`` at ``lag=1`` raises, as the JAX engine's does: a fused
epoch is one program, with nothing to overlap.
"""
from __future__ import annotations

import torch

from repro_torch.rollout.engine import RolloutEngine
from repro_torch.rollout.vecenv import episode_stats
from repro_torch.tree import leaves


def _hold(tree, stream):
    """Keep the tensors of ``tree`` from being reused before the work
    enqueued on ``stream`` so far is done."""
    for x in leaves(tree):
        x.record_stream(stream)


class OverlapEngine(RolloutEngine):
    """:class:`RolloutEngine` with the iteration split into pipelined
    collect and update halves and a ``policy_lag`` of 0 or 1."""

    def __init__(self, agent, pcfg, env, *, policy_lag: int = 1, **kwargs):
        if policy_lag not in (0, 1):
            raise ValueError(f"policy_lag must be 0 or 1, got {policy_lag}")
        self.policy_lag = policy_lag
        super().__init__(agent, pcfg, env, **kwargs)
        self._pending = None     # (slot, stats, event) in flight
        self._side = None

    # ---------------------------------------------------------- halves
    def collect(self, actors, vstate, hypers, generator):
        """Act one iteration's steps: ``(vstate, slot, episode_stats)``."""
        vstate, slot = self.collector.collect(
            actors, vstate, generator, self.collect_steps, hypers,
            flat=self.kind == "replay", chunk_steps=self.chunk_steps)
        return vstate, slot, episode_stats(vstate)

    def update_on(self, state, bufs, slot, hypers, generator, done: int):
        """Store ``slot``, then the update half: ``(state, bufs, metrics,
        did)``. The batches come from the current state, as in the serial
        iteration (PPO's GAE values and permutations)."""
        bufs = self.exp.add(bufs, slot)
        state, metrics, did = self.update_from(
            state, bufs, self.agent.actor_params(state), hypers, generator,
            done)
        return state, bufs, metrics, did

    # ---------------------------------------------------------- stepping
    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream()
        return self._side

    def _ready(self):
        """An event on the current stream marking what is enqueued so far
        (None on the CPU)."""
        if self.vstate.obs.device.type != "cuda":
            return None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream())
        return ready

    def _collect_async(self, actors, hypers, generator, ready):
        """Enqueue collect on the side stream after ``ready`` (the card) or
        run it (the CPU); the slot it fills is pending until the next
        update."""
        if ready is None:
            self.vstate, slot, stats = self.collect(actors, self.vstate,
                                                    hypers, generator)
            self._pending = (slot, stats, None)
            return
        side = self._side_stream()
        side.wait_event(ready)
        _hold((actors, hypers), side)
        with torch.cuda.stream(side):
            self.vstate, slot, stats = self.collect(actors, self.vstate,
                                                    hypers, generator)
            done = torch.cuda.Event()
            done.record(side)
        self._pending = (slot, stats, done)

    def _take_pending(self):
        slot, stats, done = self._pending
        self._pending = None
        if done is not None:
            main = torch.cuda.current_stream()
            main.wait_event(done)
            _hold((slot, stats, self.vstate), main)
        return slot, stats

    def iterate(self, state, hypers, generator):
        """One overlapped iteration. ``lag=0``: the serial iteration.
        ``lag=1``: update(t) on the pending slot, then collect(t+1) with the
        pre-update actors; the ``(metrics, stats, did)`` returned belong to
        the consumed slot."""
        if self.policy_lag == 0:
            return super().iterate(state, hypers, generator)
        actors = self.agent.actor_params(state)     # pre-update params
        if self._pending is None:       # prologue: fill the first slot
            self._collect_async(actors, hypers, generator, self._ready())
        slot, stats = self._take_pending()
        # collect(t+1) needs state_t and the hypers, all enqueued by now;
        # it must not wait for update(t), which is enqueued next
        ready = self._ready()
        new_state, self.bufs, metrics, did = self.update_on(
            state, self.bufs, slot, hypers, generator, self.iterations + 1)
        self.iterations += 1
        self._collect_async(actors, hypers, generator, ready)
        return new_state, metrics, stats, did

    def export_state(self):
        """:meth:`RolloutEngine.export_state` once the collect in flight
        has written the env states: at lag 1 on the card the current stream
        waits for that collect, so a copy enqueued on it (a checkpoint's)
        reads them whole."""
        if self._pending is not None and self._pending[2] is not None:
            main = torch.cuda.current_stream()
            main.wait_event(self._pending[2])
            _hold(self.vstate, main)
        return super().export_state()

    def import_state(self, state):
        """:meth:`RolloutEngine.import_state` (a state of this engine's
        size: ``restore_elastic`` resizes it first), then no collect in
        flight."""
        super().import_state(state)
        self._pending = None     # a restored run acts its prologue again

    def build_epoch(self, **kwargs):
        if self.policy_lag == 0:
            return super().build_epoch(**kwargs)
        raise NotImplementedError(
            "fused train-evolve epochs are one program, with nothing to "
            "overlap; use the serial engine (policy_lag=None) or "
            "policy_lag=0 for fused epochs")
