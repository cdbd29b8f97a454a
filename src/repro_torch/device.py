"""Device resolution for the port's entry points: the CUDA device unless the
caller asks for the CPU, and an error — never a silent CPU fallback — when
CUDA is asked for and absent."""
from __future__ import annotations

import torch

from repro_torch.tree import flatten, unflatten

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def device_tensor(value, dtype, device) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)`` that makes a
    Python number on the device by a fill, not by a copy from the host (a
    host copy inside a captured CUDA graph is refused). Same values."""
    if isinstance(value, torch.Tensor):
        return torch.as_tensor(value, dtype=dtype, device=device)
    return torch.full((), value, dtype=dtype, device=device)


def to_host(tree):
    """``tree`` with every tensor leaf copied to a CPU tensor that nothing
    else writes, returned once every copy is done. A CUDA tensor goes by a
    non-blocking copy into pinned memory on the current stream, and all of
    them are waited for through one event recorded after them: no stream
    sync, which ``torch.cuda.set_sync_debug_mode`` would flag. A CPU tensor
    is cloned; other leaves are kept as they are. The checkpoint manager
    and the telemetry writer both copy through this."""
    flat, treedef = flatten(tree)
    out, done = [], None
    for leaf in flat:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.is_cuda:
                leaf = leaf.to("cpu", non_blocking=True)
                done = done or torch.cuda.Event()
            else:
                leaf = leaf.clone()
        out.append(leaf)
    if done is not None:
        done.record(torch.cuda.current_stream())
        done.synchronize()
    return unflatten(treedef, out)
