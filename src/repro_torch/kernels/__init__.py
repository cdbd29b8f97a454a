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
