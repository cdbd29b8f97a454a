"""Hand-written CUDA kernels of the port (``csrc/``), each beside its plain
PyTorch version. Sources are built with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`).

The rule for autograd lives here. The CUDA kernels have no backward, so a
call that autograd records never reaches one: ``kernels.ops`` routes it to
``nn``'s plain form, ``pop_matmul`` to its explicit ``PopMatmul``, and the
wrappers of the others refuse it."""
from __future__ import annotations

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
