"""Hand-written CUDA kernels of the port (``csrc/``), each beside its plain
PyTorch version. Sources are built with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`).

The rule for autograd lives here. The CUDA kernels have no backward, so a
call that autograd records never reaches one: ``kernels.ops`` routes it to
``nn``'s plain form, ``pop_matmul`` to its explicit ``PopMatmul``, and the
wrappers of the others refuse it.

The rule for the ``meta`` device lives here too. A wrapper given ``meta``
tensors inside the dry run's counter (:class:`meta_counting`, which
:class:`repro_torch.launch.hlo_analysis.OpCounter` enters) takes its meta
route, :func:`meta_call`: it returns ``meta`` outputs of the right
shapes, builds and launches nothing, does not count a launch, and reports
the call (its operands, outputs and matmul FLOPs) to the counter.
Outside a counter a ``meta`` tensor is refused as any device without a
kernel is. It is no fallback: a CPU tensor still takes the plain version
and a CUDA tensor the kernel."""
from __future__ import annotations

import contextlib

import torch


def differentiated(*tensors) -> bool:
    """Whether autograd records a call on these tensors: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors):
    """Raise when autograd would record ``name``'s kernel launch on these
    tensors: the kernel has no backward."""
    if differentiated(*tensors):
        raise ValueError(f"{name}: the kernel has no backward; a "
                         "differentiated forward goes through kernels.ops, "
                         "which routes it to nn's plain form")


_META_COUNTER = None


@contextlib.contextmanager
def meta_counting(counter):
    """Context: every :func:`meta_call` is reported as
    ``counter(name, inputs, outputs, flops)``."""
    global _META_COUNTER
    prev, _META_COUNTER = _META_COUNTER, counter
    try:
        yield
    finally:
        _META_COUNTER = prev


def meta_call(name: str, inputs, outputs, flops: float) -> list:
    """A kernel's call on ``meta`` tensors inside a counter: ``outputs``
    are ``(shape, dtype)`` pairs, returned as ``meta`` tensors; ``flops``
    its matmul FLOPs from the shapes (formulas in
    :mod:`repro_torch.launch.hlo_analysis`). Raises outside a counter."""
    if _META_COUNTER is None:
        raise ValueError(f"{name}: no kernel for device meta (a meta tensor "
                         f"takes the kernel's meta route inside the dry "
                         f"run's counter only)")
    outs = [torch.empty(shape, dtype=dtype, device="meta")
            for shape, dtype in outputs]
    _META_COUNTER(name, [t for t in inputs if t is not None], outs, flops)
    return outs


def launch_counts() -> dict:
    """Every kernel wrapper's launch count (``<wrapper>.launches``), by
    kernel name; ``hopper2d_vec`` the hopper2d launches that took the
    vector env's one-launch route."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hopper2d import hopper2d_step
    from repro_torch.kernels.pop_adam import pop_adam
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.wkv6 import wkv6
    return {"pop_matmul": pop_matmul.launches, "pop_adam": pop_adam.launches,
            "hopper2d": hopper2d_step.launches,
            "hopper2d_vec": hopper2d_step.launches_by_route["vec"],
            "wkv6": wkv6.launches,
            "ssd": ssd.launches, "flash_attention": flash_attention.launches}
