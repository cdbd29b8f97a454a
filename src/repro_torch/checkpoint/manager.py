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
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten, num_leaves, unflatten


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

    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

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
        save_pytree(self._ckpt_path(step), tree, extra, aux=aux)
        self._gc()

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
