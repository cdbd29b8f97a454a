"""Population Adam: one Adam step for every member of a population in one
pass, each member with its own learning rate and its own step count.

Replaces the Pallas TPU kernel ``src/repro/kernels/pop_adam.py:39``
(``pop_adam``, its ``pl.pallas_call`` at line 53); the oracle is
``repro.kernels.ref.pop_adam_ref``. Layout is the same: params, grads, mu,
nu ``(N, P)`` float32, lr ``(N,)`` float32, step ``(N,)`` int32 (1-based,
per member: TD3's gated actor lets members' optimizer clocks diverge)::

    mu' = b1 mu + (1 - b1) g
    nu' = b2 nu + (1 - b2) g^2
    p'  = p - lr (mu' / c1) / (sqrt(nu' / c2) + eps),   c = 1 - b^step

:func:`pop_adam` is the wrapper every caller uses. A CPU tensor goes to
:func:`pop_adam_plain` (the same expressions in torch); a CUDA tensor goes
to the Triton kernel below or raises, with no fallback.
``pop_adam.launches`` counts kernel launches.

What bounds it on an H100: it is one elementwise pass with one scalar pair
per row, no reuse and no product, so it is bound by bytes: 4 reads and 3
writes of fp32, 28 bytes per parameter. At the training path's shapes
(N=8) that is 15.0 MB (4.49 us at 3.35 TB/s) for the actor's 536,584
parameters and 30.2 MB (9.00 us) for the critic's 1,077,264. Shared memory
and tensor cores have nothing to give, which is why this kernel is Triton:
masked, coalesced block loads are all it needs.

Design. The TPU kernel's grid is (N, P/block) over a padded P, and reads
the member's lr and step from SMEM. Here the grid is (N, cdiv(P, BLOCK)),
each program loads its member's lr and step once, and the ragged tail is
masked, so nothing is padded. ``b^step`` is taken by repeated squaring on
the step's bits (exact for step 1, a few ulp otherwise): it needs no
version-specific math library and keeps ``1 - b2`` free of the
cancellation that ``exp(step * log b)`` would bring at step 1.

The Triton cache goes under the ignored ``kernels/_build/triton`` (unless
``TRITON_CACHE_DIR`` is set), so the kernel is compiled from this source
at first use. ``triton`` is imported only there, never at import.
"""
from __future__ import annotations

import functools
import os
from pathlib import Path

import torch

BLOCK = 4096
NUM_WARPS = 8
_MAX_GRID_Y = 65535
_BUILD_DIR = Path(__file__).parent / "_build"


def pop_adam_plain(params, grads, mu, nu, lr, step, *, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8):
    """The plain PyTorch version: the reference the kernel is held to."""
    mu2 = b1 * mu + (1 - b1) * grads
    nu2 = b2 * nu + (1 - b2) * grads * grads
    stepf = step.to(torch.float32)
    c1 = (1 - b1 ** stepf)[:, None]
    c2 = (1 - b2 ** stepf)[:, None]
    upd = lr[:, None] * (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
    return params - upd, mu2, nu2


def _check(params, grads, mu, nu, lr, step):
    rows = (params, grads, mu, nu)
    if any(t.dtype != torch.float32 for t in (*rows, lr)):
        raise TypeError("pop_adam takes float32 params, grads, mu, nu and lr")
    if step.dtype != torch.int32:
        raise TypeError(f"pop_adam takes an int32 step, got {step.dtype}")
    if params.ndim != 2 or any(t.shape != params.shape for t in rows):
        raise ValueError(f"pop_adam: params, grads, mu and nu must share one "
                         f"(N, P) shape, got {[tuple(t.shape) for t in rows]}")
    n = params.shape[0]
    if tuple(lr.shape) != (n,) or tuple(step.shape) != (n,):
        raise ValueError(f"pop_adam: lr and step must be ({n},), got "
                         f"{tuple(lr.shape)} and {tuple(step.shape)}")
    if any(t.device != params.device for t in (*rows, lr, step)):
        raise ValueError("pop_adam: tensors on different devices")


@functools.cache
def _kernel():
    os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def pop_adam_kernel(p_ptr, g_ptr, mu_ptr, nu_ptr, lr_ptr, step_ptr,
                        po_ptr, muo_ptr, nuo_ptr, P, b1, b2, eps,
                        BLOCK: tl.constexpr):
        row = tl.program_id(0)
        offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < P
        at = row.to(tl.int64) * P + offs
        lr = tl.load(lr_ptr + row)
        step = tl.load(step_ptr + row)
        # b^step by squaring over the step's bits
        p1 = 1.0
        p2 = 1.0
        s1 = b1
        s2 = b2
        e = step
        for _ in tl.static_range(31):
            odd = (e & 1) != 0
            p1 = tl.where(odd, p1 * s1, p1)
            p2 = tl.where(odd, p2 * s2, p2)
            s1 = s1 * s1
            s2 = s2 * s2
            e = e >> 1
        c1 = 1.0 - p1
        c2 = 1.0 - p2
        g = tl.load(g_ptr + at, mask=mask, other=0.0)
        mu = b1 * tl.load(mu_ptr + at, mask=mask, other=0.0) + (1.0 - b1) * g
        nu = b2 * tl.load(nu_ptr + at, mask=mask, other=0.0) \
            + (1.0 - b2) * g * g
        p = tl.load(p_ptr + at, mask=mask, other=0.0)
        upd = lr * (mu / c1) / (tl.sqrt(nu / c2) + eps)
        tl.store(po_ptr + at, p - upd, mask=mask)
        tl.store(muo_ptr + at, mu, mask=mask)
        tl.store(nuo_ptr + at, nu, mask=mask)

    return pop_adam_kernel


def _launch(params, grads, mu, nu, lr, step, b1, b2, eps):
    n, p = params.shape
    rows = (params, grads, mu, nu)
    if not all(t.is_contiguous() for t in (*rows, lr, step)):
        raise ValueError("pop_adam: the kernel takes contiguous tensors")
    if -(-p // BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"pop_adam: P={p} exceeds the grid")
    outs = [torch.empty_like(params) for _ in range(3)]
    if params.numel() == 0:
        return tuple(outs)
    kernel = _kernel()
    with torch.cuda.device(params.device):
        kernel[(n, -(-p // BLOCK))](*rows, lr, step, *outs, p, b1, b2, eps,
                                    BLOCK=BLOCK, num_warps=NUM_WARPS)
    pop_adam.launches += 1
    return tuple(outs)


def pop_adam(params, grads, mu, nu, lr, step, *, b1: float = 0.9,
             b2: float = 0.999, eps: float = 1e-8):
    """One Adam step per member -> ``(params', mu', nu')``, each (N, P):
    the Triton kernel for CUDA tensors, the plain version for CPU tensors,
    an error for anything else."""
    _check(params, grads, mu, nu, lr, step)
    if params.device.type == "cpu":
        return pop_adam_plain(params, grads, mu, nu, lr, step, b1=b1, b2=b2,
                              eps=eps)
    if params.device.type != "cuda":
        raise ValueError(f"pop_adam: no kernel for device {params.device}")
    return _launch(params, grads, mu, nu, lr, step, b1, b2, eps)


pop_adam.launches = 0
