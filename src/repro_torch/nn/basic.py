"""Functional building blocks (``repro.nn.basic``): ``*_init`` returns a
nested dict of tensors with the JAX package's names and layouts (``w`` is
(in, out)), ``*_apply`` consumes it.

Initial values are drawn in float32 on the generator's device from an
explicit ``torch.Generator``, then moved to ``device`` (the MLPs: a CPU
generator gives the same parameters on every device) or cast to ``dtype``
(the LM blocks: a generator of the card draws on the card). They are not
the JAX package's values (threefry keys have no torch counterpart):
parity tests carry parameters across with :mod:`repro_torch.convert`.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def lecun_normal(generator: torch.Generator, shape, in_axis: int = -2,
                 *, device=None, dtype=torch.float32) -> torch.Tensor:
    """``std * N(0,1)`` truncated at +-2 (before scaling), std =
    1/sqrt(fan_in): the JAX package's ``lecun_normal``. Drawn on the
    generator's device, then moved to ``device`` (if given) as ``dtype``."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(1.0 / math.sqrt(fan_in)).to(device=device, dtype=dtype)


def normal_init(generator: torch.Generator, shape, std: float = 0.02, *,
                dtype=torch.float32) -> torch.Tensor:
    """``std * N(0,1)`` on the generator's device, as ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return t.normal_(0.0, 1.0, generator=generator).mul_(std).to(dtype)


def cast(tree, dtype):
    """Cast all floating leaves of a nested dict to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def linear_init(generator, in_features: int, out_features: int, *,
                device="cpu"):
    return {"w": lecun_normal(generator, (in_features, out_features),
                              device=device),
            "b": torch.zeros((out_features,), dtype=torch.float32,
                             device=device)}


def linear_apply(p, x):
    return x @ p["w"] + p["b"]


# jax.nn.gelu's default is the tanh approximation
_ACTS = {"relu": F.relu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "silu": F.silu, "tanh": torch.tanh}


def mlp_init(generator, sizes: Sequence[int], *, device="cpu"):
    """Plain MLP: sizes = [in, h1, ..., out] -> {"layer_i": {"w", "b"}}."""
    return {f"layer_{i}": linear_init(generator, sizes[i], sizes[i + 1],
                                      device=device)
            for i in range(len(sizes) - 1)}


def mlp_apply(p, x, *, activation: str = "relu",
              final_activation: str | None = None):
    n = len(p)
    act = _ACTS[activation]
    for i in range(n):
        x = linear_apply(p[f"layer_{i}"], x)
        if i < n - 1:
            x = act(x)
        elif final_activation is not None:
            x = _ACTS[final_activation](x)
    return x


# ---------------------------------------------------------------------------
# conv stack (DQN's Atari torso)
# ---------------------------------------------------------------------------

def conv_init(generator, in_ch: int, out_ch: int, kernel: int, *,
              device="cpu"):
    """``std * N(0,1)`` truncated at +-2, std = 1/sqrt(in_ch * kernel^2),
    and a zero bias. The weight is (out, in, kh, kw), torch's OIHW layout;
    the JAX package's is HWIO, and :mod:`repro_torch.convert` permutes
    between the two."""
    w = torch.empty((out_ch, in_ch, kernel, kernel), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.mul_(1.0 / math.sqrt(in_ch * kernel * kernel))
    return {"w": w.to(device),
            "b": torch.zeros((out_ch,), dtype=torch.float32, device=device)}


def _conv_nchw(p, x, stride: int):
    return F.conv2d(x, p["w"], p["b"], stride=stride)


def conv_apply(p, x, stride: int):
    """VALID convolution of an NHWC batch (the JAX package's layout), NHWC
    out."""
    return _conv_nchw(p, x.permute(0, 3, 1, 2), stride).permute(0, 2, 3, 1)


def dqn_torso_init(generator, in_ch: int = 4, *, device="cpu"):
    return {"conv_0": conv_init(generator, in_ch, 32, 8, device=device),
            "conv_1": conv_init(generator, 32, 64, 4, device=device),
            "conv_2": conv_init(generator, 64, 64, 3, device=device)}


def dqn_torso_apply(p, x):
    """(B, 84, 84, 4) NHWC frames -> (B, 3136) features, flattened in the
    JAX package's (H, W, C) order. The frames are permuted to NCHW once,
    and the features back to NHWC once before the flatten."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(_conv_nchw(p["conv_0"], x, 4))
    x = F.relu(_conv_nchw(p["conv_1"], x, 2))
    x = F.relu(_conv_nchw(p["conv_2"], x, 1))
    return x.permute(0, 2, 3, 1).flatten(1)


# ---------------------------------------------------------------------------
# the LM blocks' pieces
# ---------------------------------------------------------------------------

def glu_mlp_init(generator, d_model: int, d_ff: int, *, dtype=torch.float32):
    """Gated MLP (SwiGLU/GeGLU): gate/up/down projections."""
    def w(shape):
        return {"w": lecun_normal(generator, shape, dtype=dtype)}
    return {"w_gate": w((d_model, d_ff)), "w_up": w((d_model, d_ff)),
            "w_down": w((d_ff, d_model))}


def glu_mlp_apply(p, x, *, activation: str = "silu", d_ff: int | None = None):
    """Inside a model-parallel context, on this rank's columns of
    ``w_gate``/``w_up`` and rows of ``w_down`` when the rules shard them
    (``d_ff``, the whole width, tells), the partial sums reduced over the
    group."""
    from repro_torch.models.sharding import active
    shard = active()
    sharded = shard is not None and shard.is_part(
        p["w_gate"]["w"].shape[-1], d_ff)
    if sharded:
        from repro_torch.core.distributed import copy_to_region
        x = copy_to_region(x, shard)
    g = _ACTS[activation](x @ p["w_gate"]["w"])
    y = (g * (x @ p["w_up"]["w"])) @ p["w_down"]["w"]
    if sharded:
        from repro_torch.core.distributed import reduce_from_region
        y = reduce_from_region(y, shard)
    return y


def rmsnorm_init(dim: int, *, device="cpu", dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, *, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def layernorm_init(dim: int, *, device="cpu", dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm_apply(p, x, *, eps: float = 1e-5):
    """In float32; the scale and bias as they are (a bf16 scale times a
    float32 activation is float32), the result in ``x``'s type."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def embedding_init(generator, vocab: int, dim: int, std: float = 0.02, *,
                   dtype=torch.float32):
    return {"embedding": normal_init(generator, (vocab, dim), std=std,
                                     dtype=dtype)}
