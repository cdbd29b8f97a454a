"""Atomic checkpoints in the JAX package's on-disk layout
(``repro.checkpoint.manager``), so each package reads the other's:

    <dir>/step_##########/arrays.npz      main tree, leaf_<i>
                         /aux_<name>.npz  side trees, leaf_<i>
                         /meta.json       num_leaves, extra, treedef, aux

``leaf_<i>`` follows the JAX flatten order (sorted dict keys), which
:mod:`repro_torch.tree` reproduces. Writes go to ``<path>.tmp`` and are
renamed into place, so a reader sees the whole checkpoint or none of it.
Leaves are saved from tensors on any device (copied to the host) or numpy
arrays, and load back as numpy arrays in the template's structure.

:meth:`CheckpointManager.save_async` copies every leaf to the host on the
caller's thread and returns once the copies are done, then writes on a
daemon thread: the caller's next launch may write the same tensors in
place (the population update does), so nothing the writer reads may still
be in flight on the device. A write that fails raises from the next
:meth:`CheckpointManager.wait`. ``SignalHandler`` writes an emergency
checkpoint on SIGTERM.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.device import to_host
from repro_torch.tree import flatten, num_leaves, unflatten


def _host_numpy(tree):
    """``tree`` copied to the host (:func:`repro_torch.device.to_host`),
    as numpy leaves (a numpy leaf copied too), and the host tensors whose
    memory those leaves share."""
    host = to_host(tree)
    flat, treedef = flatten(host)
    arrays = [x.numpy() if isinstance(x, torch.Tensor) else np.array(x)
              for x in flat]
    return unflatten(treedef, arrays), host


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _dump_tree(directory: Path, name: str, tree: Any) -> int:
    leaves, _ = flatten(tree)
    np.savez(directory / f"{name}.npz",
             **{f"leaf_{i}": _to_numpy(l) for i, l in enumerate(leaves)})
    return len(leaves)


def save_pytree(path: str | Path, tree: Any, extra: dict | None = None,
                aux: dict[str, Any] | None = None):
    """Atomic save of ``tree`` plus independently restorable ``aux`` side
    trees, in one rename."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    num = _dump_tree(tmp, "arrays", tree)
    _, treedef = flatten(tree)
    aux_meta = {name: _dump_tree(tmp, f"aux_{name}", t)
                for name, t in (aux or {}).items()}
    meta = {"num_leaves": num, "extra": extra or {},
            "treedef": str(treedef), "aux": aux_meta}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def _load_tree(file: Path, template: Any):
    with np.load(file) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    _, treedef = flatten(template)
    want = num_leaves(treedef)
    if want != len(leaves):
        raise ValueError(
            f"{file} holds {len(leaves)} leaves but the restore template "
            f"has {want}: the checkpoint was written with a different "
            f"structure — restore with a matching template or start fresh")
    return unflatten(treedef, leaves)


def load_pytree(path: str | Path, template: Any):
    """The main tree of the checkpoint at ``path``: numpy leaves in the
    structure of ``template`` (only its structure is read)."""
    return _load_tree(Path(path) / "arrays.npz", template)


def load_aux(path: str | Path, name: str, template: Any):
    """Restore the named aux tree, or None when this checkpoint has none."""
    file = Path(path) / f"aux_{name}.npz"
    if not file.exists():
        return None
    return _load_tree(file, template)


def load_extra(path: str | Path) -> dict:
    return json.loads((Path(path) / "meta.json").read_text())["extra"]


class CheckpointManager:
    """Numbered checkpoints in one directory with a retention policy."""

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 run_meta: dict | None = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        # merged into every checkpoint's extras under "run" (the telemetry
        # run id), so a checkpoint joins back to the log that recorded it
        self.run_meta = dict(run_meta) if run_meta else None
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        # the pinned host tensors of the write in flight: released by wait()
        # on the caller's thread, not by the writer, so that their memory
        # goes back to the allocator while no CUDA graph is being captured
        self._pinned = None

    def _ckpt_path(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def all_steps(self) -> list[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.name.endswith(".tmp"):
                continue
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(steps)

    def latest(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, extra: dict | None = None,
             aux: dict[str, Any] | None = None):
        extra = dict(extra or {}, step=step)
        if self.run_meta is not None:
            extra.setdefault("run", self.run_meta)
        save_pytree(self._ckpt_path(step), tree, extra, aux=aux)
        self._gc()

    def _write(self, *args):
        try:
            self.save(*args)
        except Exception as e:          # raised again by wait()
            self._error = e

    def save_async(self, step: int, tree: Any, extra: dict | None = None,
                   aux: dict[str, Any] | None = None):
        """Non-blocking save: waits for the save in flight, copies every
        leaf to the host here (:func:`repro_torch.device.to_host`), then
        writes on a daemon thread."""
        self.wait()
        (host_tree, host_aux), self._pinned = _host_numpy((tree, aux))
        self._thread = threading.Thread(
            target=self._write, args=(step, host_tree, extra, host_aux),
            daemon=True)
        self._thread.start()

    def wait(self):
        """Wait for the save in flight, and raise what its write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._pinned = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("the asynchronous checkpoint write "
                               "failed") from error

    def restore(self, template: Any, step: int | None = None):
        """``(tree, extras)`` of checkpoint ``step`` (default: the latest),
        numpy leaves in ``template``'s structure; ``(None, None)`` when the
        directory holds no checkpoint."""
        step = self.latest() if step is None else step
        if step is None:
            return None, None
        path = self._ckpt_path(step)
        return load_pytree(path, template), load_extra(path)

    def restore_aux(self, name: str, template: Any,
                    step: int | None = None):
        """Restore a named aux tree, or None when the checkpoint has none."""
        step = self.latest() if step is None else step
        if step is None:
            return None
        return load_aux(self._ckpt_path(step), name, template)

    def peek_extra(self, step: int | None = None,
                   require: tuple = ("step", "size", "fitness")
                   ) -> dict | None:
        """The JSON extras of a checkpoint without loading any arrays; None
        when the directory holds no checkpoint. Raises KeyError when a
        required key is absent (``fitness`` may be recorded as None — the
        key must be present). ``require=()`` reads raw extras."""
        step = self.latest() if step is None else step
        if step is None:
            return None
        extra = load_extra(self._ckpt_path(step))
        missing = [k for k in require if k not in extra]
        if missing:
            raise KeyError(
                f"checkpoint {self._ckpt_path(step)} lacks extras "
                f"{missing} (has {sorted(extra)}): it was not written by a "
                f"population trainer's save — read raw extras with "
                f"peek_extra(require=())")
        return extra

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._ckpt_path(s), ignore_errors=True)


class SignalHandler:
    """SIGTERM -> an emergency checkpoint before exit (preemption).
    ``get_state() -> (step, tree, extra)``."""

    def __init__(self, manager: CheckpointManager, get_state):
        self.manager = manager
        self.get_state = get_state
        self.triggered = False
        try:
            signal.signal(signal.SIGTERM, self._handle)
        except ValueError:      # not the main thread
            pass

    def _handle(self, signum, frame):
        self.triggered = True
        step, tree, extra = self.get_state()
        self.manager.wait()
        self.manager.save(step, tree, dict(extra, preempted=True))
