"""Mixture-of-experts layer (``repro.nn.moe``): GShard's capacity-based
dispatch, as einsums over a (batch, groups, tokens, experts, capacity)
one-hot tensor.

Tokens are grouped along the sequence only: groups of ``group_size``
tokens, shrunk until they divide S. Each token picks its top k experts;
an expert takes at most ``capacity = max(k, ceil(gs k cf / E))`` tokens of
a group, queued slot-major, then token-major; a token past its expert's
capacity is dropped from that expert (the layer's residual carries it).
Every expert runs on all its capacity slots, so a step reads every
expert's weights whatever the routing.

As in the JAX package, the router's logits are computed in the model's
type and the softmax in float32. The top k are taken by a stable
descending sort, so that among equal probabilities the lower expert index
comes first, as ``jax.lax.top_k`` puts it (``torch.topk`` leaves that
order unspecified). ``torch.einsum`` takes one dtype: the 0/1 dispatch
tensor (bf16 in the JAX package, which lets its einsum promote) is cast
to the activations' type, which is exact, and the combine weights are
rounded to it, as the JAX package rounds them.

The JAX package computes this layer outside any Pallas kernel; so does
the port, in plain PyTorch.

Inside a model-parallel context (:func:`repro_torch.models.sharding.
model_parallel`) the experts are cut over the model axis by the rules
(``experts.*`` on E): a rank holds E/M consecutive experts. The router is
whole, so every rank computes the same logits, the top k over all E
experts and the gates. A token's place in an expert's queue is a cumsum
down that expert's column, so a rank builds the dispatch and combine
tensors of its own experts' columns only, equal to those columns of the
whole ones; it runs its experts on their capacity slots, and the partial
outputs are summed over the group. The gates enter the region through
``copy_to_region``, so the router's gradient from the combine is summed
over the ranks, while the balancing loss, the same whole term on every
rank, adds its gradient once. The shared experts take the sharded
:func:`repro_torch.nn.basic.glu_mlp_apply`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import copy_to_region, reduce_from_region
from repro_torch.models.sharding import active
from repro_torch.nn.basic import (glu_mlp_apply, glu_mlp_init,
                                  lecun_normal)


def moe_init(generator, *, d_model: int, d_expert: int, num_experts: int,
             num_shared: int = 0, dtype=torch.float32):
    """The router (D, E), the experts' gated MLPs (E, D, F) / (E, F, D) in
    the ``x @ w`` layout, and with ``num_shared`` one gated MLP of width
    ``d_expert * num_shared``."""
    w = lambda shape, **kw: lecun_normal(generator, shape, dtype=dtype, **kw)
    p = {"router": {"w": w((d_model, num_experts))},
         "experts": {
             "w_gate": w((num_experts, d_model, d_expert), in_axis=-2),
             "w_up": w((num_experts, d_model, d_expert), in_axis=-2),
             "w_down": w((num_experts, d_expert, d_model), in_axis=-2)}}
    if num_shared:
        p["shared"] = glu_mlp_init(generator, d_model, d_expert * num_shared,
                                   dtype=dtype)
    return p


def _top_k_gating(router_logits, top_k: int, *, normalize: bool = True):
    """-> (probs (..., E) float32, gates (..., k), expert indices (..., k)),
    the largest probabilities first, the lower index first among equal
    ones."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :top_k], idx[..., :top_k]
    if normalize:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return probs, gates, idx


def _one_hot(idx, n: int):
    """float32 one-hot; an index outside [0, n) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _dispatch_combine(gates, idx, num_experts: int, capacity: int, *,
                      experts: tuple | None = None):
    """gates/idx: (B, G, T, k). Returns combine (B,G,T,E,C) float32 and
    dispatch, its nonzero pattern, in bf16. With ``experts`` (lo, hi) only
    those experts' columns, (B,G,T,hi-lo,C): each column's queue is its
    own cumsum, so they equal those columns of the whole tensors."""
    b, g, t, k = idx.shape
    lo, hi = (0, num_experts) if experts is None else experts
    e = hi - lo
    onehot = _one_hot(idx - lo, e)                             # (B,G,T,k,E)
    # position of each (token, slot) in its expert's queue, counting
    # slot-major then token-major (GShard's order)
    flat = onehot.transpose(2, 3).reshape(b, g, k * t, e)
    pos_flat = torch.cumsum(flat, dim=2) - flat                # (B,G,k*T,E)
    pos = pos_flat.reshape(b, g, k, t, e).transpose(2, 3)
    pos = (pos * onehot).sum(-1)                               # (B,G,T,k)
    keep = (pos < capacity).float()
    cap_onehot = _one_hot(pos.long(), capacity)
    combine = torch.einsum("bgtk,bgtke,bgtkc->bgtec", gates * keep, onehot,
                           cap_onehot)
    dispatch = (combine > 0).to(torch.bfloat16)
    return combine, dispatch


def load_balancing_loss(probs, idx, num_experts: int):
    """Switch/GShard aux loss: E * sum_e mean(prob_e) * mean(frac routed
    to e), averaged over the groups."""
    counts = F.one_hot(idx, num_experts).float().sum(dim=(-3, -2))
    frac = counts / torch.clamp(counts.sum(-1, keepdim=True), min=1.0)
    mean_prob = probs.mean(-2)
    return num_experts * (frac * mean_prob).sum(-1).mean()


def moe_apply(p, x, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 256,
              activation: str = "silu", d_shared: int | None = None):
    """x: (B, S, D) -> (out (B, S, D), aux loss, a float32 scalar). The
    experts' MLPs are SwiGLU; ``activation`` is the shared experts'.
    ``d_shared``, the shared experts' whole width (``d_expert *
    num_shared``), tells a model-sharded forward whether their columns
    are cut."""
    b, s, d = x.shape
    gs = min(group_size, s)
    while s % gs:                  # keep groups exact for any seq length
        gs -= 1
    g = s // gs
    xg = x.reshape(b, g, gs, d)

    probs, gates, idx = _top_k_gating(
        xg @ p["router"]["w"].to(x.dtype), top_k)
    capacity = max(top_k, int(math.ceil(gs * top_k * capacity_factor
                                        / num_experts)))
    we = p["experts"]
    shard = active()
    experts = None
    if shard is not None and shard.is_part(we["w_gate"].shape[0],
                                           num_experts):
        # this rank's experts: their columns, the router's gradient from
        # them summed over the group
        experts = shard.bounds(num_experts)
        gates = copy_to_region(gates, shard)
        xg = copy_to_region(xg, shard)
    combine, dispatch = _dispatch_combine(gates, idx, num_experts, capacity,
                                          experts=experts)

    xs = torch.einsum("bgtec,bgtd->bgecd", dispatch.to(x.dtype), xg)
    hg = F.silu(torch.einsum("bgecd,edf->bgecf", xs,
                             we["w_gate"].to(x.dtype)))
    hu = torch.einsum("bgecd,edf->bgecf", xs, we["w_up"].to(x.dtype))
    ye = torch.einsum("bgecf,efd->bgecd", hg * hu,
                      we["w_down"].to(x.dtype))
    out = torch.einsum("bgtec,bgecd->bgtd", combine.to(x.dtype), ye)
    out = out.reshape(b, s, d)
    if experts is not None:
        out = reduce_from_region(out, shard)

    if "shared" in p:
        out = out + glu_mlp_apply(p["shared"], x, activation=activation,
                                  d_ff=d_shared)
    return out, load_balancing_loss(probs, idx, num_experts)
