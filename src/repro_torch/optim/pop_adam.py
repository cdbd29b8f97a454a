"""Population-level Adam (``repro.optim.pop_adam``): the ``pop_adam``
kernel as an optimizer over member-stacked parameter trees.

``apply_fn`` runs ONE Adam step for the whole population over ``(N, P)``
matrices with each member's own learning rate, and, like the JAX
package's kernel path, its own decoupled weight decay (``weight_decay``,
or ``wd_override`` per member) and global-norm clip (``max_grad_norm``:
one square-sum over each member's row, leaf by leaf as the JAX package's
``_clip_stacked`` takes it, folded into the kernel as a per-member
gradient scale, with no rewrite of the gradients).

Two storage forms, chosen by the caller (``flat``), with the same
results:

  * ``flat=True``: params, grads, mu and nu each live in one ``(N, P)``
    float32 buffer whose views are the tree's leaves (:func:`repro_torch.
    tree.flat_copy`; ``init_fn`` lays the moments out so). The step is
    written into those buffers in place: nothing is copied, and the views
    stay valid. A tree that is not so laid out raises. This is how the LM
    population trains: at qwen2-0.5b's size each such buffer is 7.9 GB.
  * ``flat=False`` (TD3's stacked leaves): the leaves are copied into
    ``(N, P)`` matrices, stepped, and rebuilt as contiguous leaves
    (``pop_matmul`` requires a contiguous ``w``).

The kernel masks its ragged tail, so nothing is padded. ``fused=None``
runs :func:`repro_torch.kernels.pop_adam.pop_adam`: the Triton kernel on
CUDA tensors, its plain version on CPU tensors. ``fused=False`` always
runs the plain version (the JAX package's ``fused=False``, where XLA runs
Adam). The optimizer state has the JAX package's structure:
``AdamState(step=(N,) int32, mu, nu)`` with mu and nu stacked like the
parameters.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import device_tensor
from repro_torch.kernels.pop_adam import pop_adam, pop_adam_plain
from repro_torch.optim.optimizers import AdamState
from repro_torch.tree import flat_buffer, flat_empty, flatten, unflatten


def _flatten(tree):
    """Stacked tree (leaves (N, ...)) -> ((N, P) float32 copy, rebuild fn)."""
    leaves, treedef = flatten(tree)
    n = leaves[0].shape[0]
    sizes = [math.prod(l.shape[1:]) for l in leaves]
    flat = torch.cat([l.reshape(n, -1).float() for l in leaves], dim=1)

    def rebuild(mat):
        outs, off = [], 0
        for leaf, size in zip(leaves, sizes):
            outs.append(mat[:, off:off + size].reshape(leaf.shape)
                        .to(leaf.dtype).contiguous())
            off += size
        return unflatten(treedef, outs)

    return flat, rebuild


def model_square_sums(sharded, shard):
    """The ``reduce_square_sums`` of a member sharded over ``shard``'s
    group: ``sharded[j]`` says whether gradient leaf ``j`` is this rank's
    part of the leaf (its square-sums are added over the group) or whole
    (the same on every rank: the first rank's are taken), so the sums are
    the whole members' and every rank gets them."""
    from repro_torch.core.distributed import all_reduce
    mask = torch.tensor([bool(x) for x in sharded])

    def reduce(sums):
        keep = mask.to(sums.device) | (shard.coord == 0)
        return all_reduce(torch.where(keep, sums, 0.0).contiguous(),
                          shard.group)
    return reduce


def population_adam(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, weight_decay: float = 0.0,
                    max_grad_norm=None, fused=None, flat: bool = False,
                    reduce_square_sums=None):
    """Build ``(init_fn, apply_fn)`` over population-stacked trees::

        state = init_fn(stacked_params)               # leaves (N, ...)
        params, state = apply_fn(params, grads, state, lr_override=lr_n,
                                 wd_override=wd_n)

    ``lr_override`` and ``wd_override`` are scalars or ``(N,)`` per-member
    vectors. Unlike the stock pair this applies the update itself (the
    kernel fuses moment update, bias correction, decay and apply in one
    pass). ``grads`` has the structure of ``params``; with ``flat=True``
    all four trees are views of flat buffers, stepped in place.

    ``reduce_square_sums`` (a member sharded over several ranks) takes the
    ``(N, leaves)`` square-sums of this rank's gradient leaves and returns
    the whole members' (a sum over the ranks that counts each whole leaf
    once), so every rank applies the same clip scale."""
    step_fn = pop_adam_plain if fused is False else pop_adam

    def init_fn(params):
        leaves, _ = flatten(params)
        step = torch.zeros((leaves[0].shape[0],), dtype=torch.int32,
                           device=leaves[0].device)
        if flat:
            def zeros():
                buffer, views = flat_empty(params)
                buffer.zero_()
                return views
        else:
            zeros = lambda: unflatten(flatten(params)[1], [
                torch.zeros_like(p, dtype=torch.float32) for p in leaves])
        return AdamState(step=step, mu=zeros(), nu=zeros())

    def apply_fn(params, grads, state, lr_override=None, wd_override=None):
        step = state.step + 1
        n = step.shape[0]
        vec = lambda v: device_tensor(
            v, torch.float32, step.device).expand(n).contiguous()
        lr_vec = vec(lr if lr_override is None else lr_override)
        decoupled = (wd_override is not None) or bool(weight_decay)
        wd_vec = None if not decoupled else vec(
            weight_decay if wd_override is None else wd_override)

        if flat:
            pf, gf, mf, nf = (flat_buffer(t) for t in (params, grads,
                                                       state.mu, state.nu))
        else:
            pf, rebuild = _flatten(params)
            gf, mf, nf = (_flatten(t)[0] for t in (grads, state.mu,
                                                   state.nu))
        scale = None
        if max_grad_norm is not None:
            # per-leaf square-sums over the member's row, summed in leaf
            # order, as the JAX package's _clip_stacked: a leaf at a time
            # (its square is the only copy), and summed by torch.sum, whose
            # cascade keeps float32 accurate over a row of 494M elements
            # (torch.linalg.vector_norm on the CPU does not: 0.5% off at
            # 60M)
            sums = torch.stack([
                torch.square(x.reshape(n, -1).float()).sum(1)
                for x in flatten(grads)[0]], dim=1)
            if reduce_square_sums is not None:
                sums = reduce_square_sums(sums)
            norm = torch.sqrt(sum(sums.unbind(1)))
            scale = torch.clamp(max_grad_norm / (norm + 1e-9), max=1.0)
        p2, m2, v2 = step_fn(pf, gf, mf, nf, lr_vec, step, wd=wd_vec,
                             scale=scale, b1=b1, b2=b2, eps=eps,
                             inplace=flat)
        if flat:
            return params, AdamState(step=step, mu=state.mu, nu=state.nu)
        return rebuild(p2), AdamState(step=step, mu=rebuild(m2),
                                      nu=rebuild(v2))

    return init_fn, apply_fn
