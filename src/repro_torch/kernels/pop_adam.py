"""Population Adam: one Adam step for every member of a population in one
pass, each member with its own learning rate, step count, decoupled
weight decay and gradient scale.

Replaces the Pallas TPU kernel ``src/repro/kernels/pop_adam.py:39``
(``pop_adam``, its ``pl.pallas_call`` at line 53); the oracle is
``repro.kernels.ref.pop_adam_ref``. Layout is the same: params, grads, mu,
nu ``(N, P)`` float32, lr ``(N,)`` float32, step ``(N,)`` int32 (1-based,
per member: TD3's gated actor lets members' optimizer clocks diverge).
Two optional ``(N,)`` float32 vectors fold in what the JAX package does
around its kernel: ``wd``, the decoupled decay it post-applies
(``src/repro/optim/pop_adam.py:163-167``), and ``scale``, the per-member
global-norm clip factor it multiplies into the gradients first
(``_clip_stacked``)::

    g   = scale g
    mu' = b1 mu + (1 - b1) g
    nu' = b2 nu + (1 - b2) g^2
    p'  = p - lr (mu' / c1) / (sqrt(nu' / c2) + eps) - lr wd p,
          c = 1 - b^step

:func:`pop_adam` is the wrapper every caller uses. A CPU tensor goes to
:func:`pop_adam_plain` (the same expressions in torch); a CUDA tensor goes
to the Triton kernel below or raises, with no fallback. With
``inplace=True`` the results are written into ``params``, ``mu`` and
``nu`` themselves (on the card the kernel's outputs alias its inputs: each
element is read and then written by the same program), which is how the LM
population's flat buffers are updated without a copy.
``pop_adam.launches`` counts kernel launches.

What bounds it on an H100: it is one elementwise pass with a few scalars
per row, no reuse and no product, so it is bound by bytes: 4 reads and 3
writes of fp32, 28 bytes per parameter; the decay and the scale add no
pass over the parameters (done apart, the decay alone would read p and p'
and write p' again). At the TD3 path's shapes (N=8) that is 15.0 MB (4.49
us at 3.35 TB/s) for the actor's 536,584 parameters and 30.2 MB (9.00 us)
for the critic's 1,077,264; at qwen2-0.5b's LM population (N=4, P =
494,032,768) 55.3 GB, 16.5 ms. Shared memory and tensor cores have
nothing to give, which is why this kernel is Triton: masked, coalesced
block loads are all it needs.

Design. The TPU kernel's grid is (N, P/block) over a padded P, and reads
the member's lr and step from SMEM. Here the grid is (cdiv(P, BLOCK), N):
the P-blocks on axis 0, which takes up to 2^31 - 1 programs (qwen2-0.5b
needs 120,614, past axis 1's limit of 65,535), the member on axis 1. Each
program loads its member's scalars once, offsets are int64 (N P passes
2^31 at that size), and the ragged tail is masked, so nothing is padded.
The decay and the scale are compile-time flags (``HAS_WD``,
``HAS_SCALE``): a call without them (the TD3 path) launches the kernel
alone, with no fill of a zero decay or unit scale beside it. The betas,
``1 - b1``, ``1 - b2`` and eps are compile-time constants too (one
build per optimizer setting): read as run-time arguments, the accurate
``1 - b`` cost the TD3 shapes 4-7% on the H100.
``b^step`` is taken by repeated squaring on the step's bits (exact for
step 1, a few ulp otherwise): it needs no version-specific math library
and keeps ``1 - b2`` free of the cancellation that ``exp(step * log b)``
would bring at step 1. ``1 - b1`` and ``1 - b2`` come from the host,
taken in double as the plain version's are (1 - 0.999 in float32 is
1.3e-5 off 0.001, an error the update carries wherever nu is mostly
g^2). What still differs from the plain version is a few ulp of each
term: ``b^step`` by squaring, Triton's approximate division and square
root, and products and sums the compiler contracts. (The IEEE-rounded
``div_rn`` and ``sqrt_rn`` took the TD3 path's launches from 8.6 and
11.4 us to 15.5 each on the H100, and bought no accuracy the check
needs.)

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
_MAX_GRID_X = 2 ** 31 - 1
_MAX_GRID_Y = 65535
_BUILD_DIR = Path(__file__).parent / "_build"
PLAIN_CHUNK = 1 << 24   # columns the plain version steps at a time in place
PLAIN_CHUNK_HOST = 1 << 18   # at most this many on the CPU


def pop_adam_plain(params, grads, mu, nu, lr, step, *, wd=None, scale=None,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   inplace: bool = False):
    """The plain PyTorch version: the reference the kernel is held to.
    In place it steps ``PLAIN_CHUNK`` columns at a time, the same
    elementwise expressions, so that its temporaries stay a few chunks in
    size, not a few copies of the population (of 8 GB each for two
    members of a billion parameters). On the CPU a chunk is at most
    ``PLAIN_CHUNK_HOST`` columns, so that its temporaries are reused from
    the cache rather than mapped afresh for each expression."""
    chunk = (PLAIN_CHUNK if params.is_cuda
             else min(PLAIN_CHUNK, PLAIN_CHUNK_HOST))
    if inplace and params.shape[1] > chunk:
        for c in range(0, params.shape[1], chunk):
            cols = slice(c, c + chunk)
            pop_adam_plain(params[:, cols], grads[:, cols], mu[:, cols],
                           nu[:, cols], lr, step, wd=wd, scale=scale, b1=b1,
                           b2=b2, eps=eps, inplace=True)
        return params, mu, nu
    if scale is not None:
        grads = grads * scale[:, None]
    mu2 = b1 * mu + (1 - b1) * grads
    nu2 = b2 * nu + (1 - b2) * grads * grads
    stepf = step.to(torch.float32)
    c1 = (1 - b1 ** stepf)[:, None]
    c2 = (1 - b2 ** stepf)[:, None]
    upd = lr[:, None] * (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
    p2 = params - upd
    if wd is not None:
        p2 = p2 - (lr * wd)[:, None] * params
    if not inplace:
        return p2, mu2, nu2
    params.copy_(p2)
    mu.copy_(mu2)
    nu.copy_(nu2)
    return params, mu, nu


def _check(params, grads, mu, nu, lr, step, wd, scale):
    rows = (params, grads, mu, nu)
    vecs = tuple(v for v in (lr, wd, scale) if v is not None)
    if any(t.dtype != torch.float32 for t in (*rows, *vecs)):
        raise TypeError("pop_adam takes float32 params, grads, mu, nu, lr, "
                        "wd and scale")
    if step.dtype != torch.int32:
        raise TypeError(f"pop_adam takes an int32 step, got {step.dtype}")
    if params.ndim != 2 or any(t.shape != params.shape for t in rows):
        raise ValueError(f"pop_adam: params, grads, mu and nu must share one "
                         f"(N, P) shape, got {[tuple(t.shape) for t in rows]}")
    n = params.shape[0]
    if any(tuple(v.shape) != (n,) for v in (*vecs, step)):
        raise ValueError(f"pop_adam: lr and step must be ({n},), as must wd "
                         f"and scale, got "
                         f"{[tuple(v.shape) for v in (*vecs, step)]}")
    if any(t.device != params.device for t in (*rows, *vecs, step)):
        raise ValueError("pop_adam: tensors on different devices")


@functools.cache
def _kernel():
    os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def pop_adam_kernel(p_ptr, g_ptr, mu_ptr, nu_ptr, lr_ptr, step_ptr,
                        wd_ptr, scale_ptr, po_ptr, muo_ptr, nuo_ptr, P,
                        b1: tl.constexpr, b2: tl.constexpr,
                        omb1: tl.constexpr, omb2: tl.constexpr,
                        eps: tl.constexpr, HAS_WD: tl.constexpr,
                        HAS_SCALE: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(1)
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
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
        if HAS_SCALE:
            g = g * tl.load(scale_ptr + row)
        mu = b1 * tl.load(mu_ptr + at, mask=mask, other=0.0) + omb1 * g
        nu = b2 * tl.load(nu_ptr + at, mask=mask, other=0.0) \
            + omb2 * g * g
        p = tl.load(p_ptr + at, mask=mask, other=0.0)
        upd = lr * (mu / c1) / (tl.sqrt(nu / c2) + eps)
        p2 = p - upd
        if HAS_WD:
            p2 = p2 - lr * tl.load(wd_ptr + row) * p
        tl.store(po_ptr + at, p2, mask=mask)
        tl.store(muo_ptr + at, mu, mask=mask)
        tl.store(nuo_ptr + at, nu, mask=mask)

    return pop_adam_kernel


def _launch(params, grads, mu, nu, lr, step, wd, scale, b1, b2, eps,
            inplace):
    n, p = params.shape
    rows = (params, grads, mu, nu)
    vecs = tuple(v for v in (wd, scale) if v is not None)
    if not all(t.is_contiguous() for t in (*rows, lr, step, *vecs)):
        raise ValueError("pop_adam: the kernel takes contiguous tensors")
    blocks = -(-p // BLOCK)
    if blocks > _MAX_GRID_X or n > _MAX_GRID_Y:
        raise ValueError(f"pop_adam: (N, P)=({n}, {p}) exceeds the grid")
    outs = ((params, mu, nu) if inplace
            else tuple(torch.empty_like(params) for _ in range(3)))
    if params.numel() == 0:
        return outs
    kernel = _kernel()
    with torch.cuda.device(params.device):
        # 1 - b in double, rounded once, as the plain version's scalars;
        # an absent wd or scale is compiled out (lr stands in for its
        # pointer, never read)
        kernel[(blocks, n)](*rows, lr, step, lr if wd is None else wd,
                            lr if scale is None else scale, *outs, p,
                            b1=b1, b2=b2, omb1=1 - b1, omb2=1 - b2, eps=eps,
                            HAS_WD=wd is not None,
                            HAS_SCALE=scale is not None, BLOCK=BLOCK,
                            num_warps=NUM_WARPS)
    pop_adam.launches += 1
    return outs


def pop_adam(params, grads, mu, nu, lr, step, *, wd=None, scale=None,
             b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
             inplace: bool = False):
    """One Adam step per member -> ``(params', mu', nu')``, each (N, P):
    the Triton kernel for CUDA tensors, the plain version for CPU tensors,
    an error for anything else. ``wd`` and ``scale`` are optional (N,)
    vectors; ``inplace`` writes the results into params, mu and nu and
    returns them."""
    _check(params, grads, mu, nu, lr, step, wd, scale)
    if params.device.type == "cpu":
        return pop_adam_plain(params, grads, mu, nu, lr, step, wd=wd,
                              scale=scale, b1=b1, b2=b2, eps=eps,
                              inplace=inplace)
    if params.device.type != "cuda":
        raise ValueError(f"pop_adam: no kernel for device {params.device}")
    return _launch(params, grads, mu, nu, lr, step, wd, scale, b1, b2, eps,
                   inplace)


pop_adam.launches = 0
