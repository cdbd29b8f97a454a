"""Rotary position embeddings (RoPE), ``repro.nn.rotary``."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0, *, device="cpu"):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, *, theta: float = 10000.0):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) integers.
    Rotates in float32 and returns x's type."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)     # (d/2,)
    angles = positions.float()[..., None] * freqs           # (..., S, d/2)
    if x.ndim == angles.ndim + 1:                           # head axis
        angles = angles[..., None, :]                       # (..., S, 1, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
