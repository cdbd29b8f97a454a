"""Builds the port's CUDA sources into shared libraries with ``nvcc``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``_build/lib<name>-<digest>.so``, loaded with :mod:`ctypes`. The digest
covers the sources and the flags, so an edited source is rebuilt and a
stale library is never loaded. Building happens at first use (or ahead of
it through :func:`build`, which starts one ``nvcc`` per source, all at
once), never at import: the package imports on machines without a CUDA
toolkit, where only the kernels' plain versions run.

Each build is announced to the compile listeners
(:func:`add_compile_listener`: ``fn(event, secs)``, ``event`` the source's
name, ``secs`` from the start of the builds to its ``nvcc``'s end); the
captures of :mod:`repro_torch.rollout.graph` are announced through the
same registry, as ``"cuda_graph"``. Run telemetry subscribes to it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source beside NVCC_FLAGS: hopper2d's products and sums are
# not contracted into FMAs, so that it rounds as its plain version's
# separate PyTorch operations do
SOURCE_FLAGS = {"hopper2d": ("-fmad=false",)}


_compile_listeners: list = []


def add_compile_listener(fn):
    """Call ``fn(event, secs)`` at every kernel build and graph capture;
    returns the function that unsubscribes it."""
    _compile_listeners.append(fn)

    def unsubscribe():
        if fn in _compile_listeners:
            _compile_listeners.remove(fn)

    return unsubscribe


def notify_compile(event: str, secs: float):
    """Announce one build or capture to the listeners."""
    for fn in list(_compile_listeners):
        fn(event, secs)


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin "
                       "and /usr/local/cuda/bin): the CUDA kernels need the "
                       "CUDA toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built to, named by a digest of the
    source, the shared headers and the compiler flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, str]:
    """Build every named source that is not built yet, one ``nvcc`` process
    per source, all started together. Returns the compiler's report for
    each source it built (``-Xptxas -v``: registers, shared memory,
    spills); raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        running[name] = (out, tmp, subprocess.Popen(
            [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (out, tmp, proc) in running.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a loader sees all or none
            notify_compile(name, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if
    needed. Loaded once per process."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
