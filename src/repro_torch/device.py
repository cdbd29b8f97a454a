"""Device resolution for the port's entry points: the CUDA device unless the
caller asks for the CPU, and an error — never a silent CPU fallback — when
CUDA is asked for and absent."""
from __future__ import annotations

import torch

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
