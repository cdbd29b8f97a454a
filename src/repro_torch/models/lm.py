"""Decoder LM (``repro.models.lm``): the dense attention transformers
(qwen2, qwen3, gemma), the mixture-of-experts ones (qwen3-moe with GQA,
deepseek-v2-lite with MLA, shared experts and a dense first layer), RWKV6
and the Zamba2 hybrid (Mamba2 with a shared attention block).

The model is organised, as in the JAX package, as *segments* of
homogeneous blocks whose parameters are stacked along a leading layer
axis (an MoE config: a ``dense`` segment of its ``first_dense_layers``,
then a ``moe`` segment); the port walks each segment's layers in a Python
loop where JAX scans. Decode state (WKV states, SSD and convolution
states, KV caches, MLA's compressed caches) is stacked the same way.

Public API:
    init_params(generator, cfg, dtype=torch.float32)
    cast_params(params, cfg)
    forward(params, cfg, batch, state=None, cache_index=None, *,
            train=False, return_hidden=False)
    lm_loss(params, cfg, batch)
    make_train_step(cfg, tcfg) / make_population_update(cfg, tcfg)
    make_serve_step(cfg)
    decode_state_shapes(cfg, batch, max_len) / init_decode_state(...)
    frontend_inputs(cfg, tokens, patches=True)

Differences from the JAX package, none of them in the numbers:

  * parameters are cast to ``cfg.dtype`` once (:func:`cast_params`, or
    ``init_params(dtype=...)``), not inside every step; ``final_norm``
    keeps its float32 scale, as JAX reads it uncast;
  * a step updates the decode state in place and returns it (the states
    are the largest tensors of a served batch after the weights);
  * the kernels run wherever the tensors are on the card (a stateless
    forward or a prefill: the CUDA ``flash_attention``, ``wkv6`` and
    ``ssd``; decode: attention over the cache and the literal scans), and
    their plain versions on the CPU. The JAX package's serve step takes
    the prompt's attention over the whole cache; the port's prefill
    (``cache_index`` 0) takes it over the prompt's own keys through the
    flash kernel, the same function (:mod:`repro_torch.nn.attention`).
    MLA and the MoE layers compute in plain PyTorch on either device, as
    the JAX package computes them outside its kernels;
  * ``forward`` returns (logits, state): the MoE auxiliary loss, summed
    over the layers as JAX's third output, reaches ``lm_loss`` through
    :func:`_forward`.

Training. ``lm_loss`` casts float32 master parameters to ``cfg.dtype``
inside the differentiated function, as the JAX package's forward does,
and with ``cfg.remat`` recomputes each layer (each Zamba2 super-block) in
the backward through ``torch.utils.checkpoint`` (non-reentrant), where
JAX checkpoints its scan body. A differentiated forward never launches a
kernel (:mod:`repro_torch.kernels.ops`). The JAX package computes the
members' gradients under ``vmap``; the port loops over the members:
``torch.func``'s transforms refuse the saved-tensor hooks that a
non-reentrant checkpoint is made of, and a full-width population needs
the checkpoint. The population update then steps every member at once
with ONE ``population_adam`` call over flat ``(N, P)`` buffers (the
``pop_adam`` kernel on the card, written in place).

Frontends, as in the JAX package: ``audio_frames`` (musicgen) has no
embedding table and takes ``batch["embeds"]`` (B,S,D) as the hidden
state, in every form; ``vision_patches`` (pixtral) splices
``batch["patch_embeds"]`` (B,P,D) over the first P positions of the
table's output in the stateless form only (the JAX package's
``cache_index is None``; the port's stateless form runs at cache index 0,
so it is told apart by having no state), and ``lm_loss`` masks the labels
of the first ``num_frontend_positions`` positions. The serve step, prefill
included, ignores the patches, as the JAX package's does.

Model-sharded members (the tensor parallelism inside an island that the
JAX package gets from GSPMD): inside :func:`repro_torch.models.sharding.
model_parallel` the stateless forward, ``lm_loss`` and the population
update run on this rank's parts of a member placed by the rules of
:mod:`repro_torch.models.sharding`: the dense attention blocks and RWKV6
(:mod:`repro_torch.nn.attention`, :mod:`repro_torch.nn.rwkv6`), the
embedding and the head vocab-parallel, the cross-entropy's log-sum-exp
and gold logit reduced over the group in float32; the MoE layers with
their experts over the model axis (:mod:`repro_torch.nn.moe`, the
balancing loss the same whole term on every rank), MLA with its latent
and heads split, and the Mamba2 blocks with their SSD heads split
(:mod:`repro_torch.nn.mamba2`; Zamba2's shared block, unstacked, takes
the rules as an unstacked leaf does: a bias under a 2-D rule stays
whole). The result is the one-rank one's up to rounding: sharding decides
where, never what. Every family shards, and so does its decode state:
``init_decode_state(shard=)`` allocates this rank's part of each leaf by
:func:`repro_torch.models.sharding.decode_state_dim` (heads where they
divide, else the cache's sequence), and the serve step of
``make_serve_step(cfg, shard)`` runs on it (the JAX package serves over a
model axis only in its dry run's decode cells). :func:`whole_decode_state`
puts the ranks' parts back together.

:func:`input_specs` gives a cell's inputs as ``meta`` tensors, the dry
run's (:mod:`repro_torch.launch.dryrun`). Not ported: a Mamba2 stack
without the shared attention (no config has one).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig, ShapeSpec, TrainConfig
from repro_torch.core.distributed import (all_gather, all_reduce,
                                          copy_to_region,
                                          gather_from_region,
                                          reduce_from_region)
from repro_torch.kernels.ops import attention
from repro_torch.models.sharding import (ModelShard, active,
                                         decode_state_dims, member_dims,
                                         model_parallel)
from repro_torch.nn.attention import (gqa_apply, gqa_init, mla_apply,
                                      mla_init)
from repro_torch.nn.basic import (cast, embedding_init, glu_mlp_apply,
                                  glu_mlp_init, layernorm_apply,
                                  layernorm_init, lecun_normal,
                                  rmsnorm_apply, rmsnorm_init)
from repro_torch.nn.mamba2 import mamba2_block_apply, mamba2_block_init
from repro_torch.nn.moe import moe_apply, moe_init
from repro_torch.nn.rwkv6 import (channel_mix_apply, rwkv6_block_init,
                                  time_mix_apply)
from repro_torch.optim.optimizers import (adam, apply_updates,
                                          dynamic_warmup_cosine,
                                          warmup_cosine)
from repro_torch.optim.pop_adam import model_square_sums, population_adam
from repro_torch.tree import flat_empty, flatten, stack, tree_map, unflatten

# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    name: str
    kind: str            # attn | rwkv | mamba
    count: int           # layers (or super-blocks) stacked
    inner: int = 1       # mamba layers per super-block
    moe: bool = False    # attention layers with a mixture of experts


def layout(cfg: LMConfig) -> list[Segment]:
    """Attention: a ``dense`` segment of the layers without experts (all of
    them, or an MoE config's ``first_dense_layers``), then a ``moe``
    segment of the rest. RWKV6: one segment of layers. Zamba2:
    super-blocks of ``shared_attn_every`` Mamba2 layers, each led by the
    shared attention block, then a tail super-block of the remaining
    layers (81 = 13 x 6 + 3). Every Mamba2 segment carries the shared
    attention."""
    if cfg.block_type == "attention":
        nd = cfg.num_layers if cfg.moe is None else cfg.moe.first_dense_layers
        segs = [Segment("dense", "attn", nd)] if nd else []
        if cfg.num_layers > nd:
            segs.append(Segment("moe", "attn", cfg.num_layers - nd,
                                moe=True))
        return segs
    if cfg.block_type == "rwkv6":
        return [Segment("rwkv", "rwkv", cfg.num_layers)]
    if cfg.block_type == "mamba2" and cfg.shared_attn_every:
        inner = cfg.shared_attn_every
        n_super, rem = divmod(cfg.num_layers, inner)
        segs = [Segment("mamba_main", "mamba", n_super, inner=inner)]
        if rem:
            segs.append(Segment("mamba_tail", "mamba", 1, inner=rem))
        return segs
    raise NotImplementedError(
        f"{cfg.name}: a Mamba2 stack without the shared attention block is "
        f"not ported (no config has one)")


def compute_dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _attn_block_init(generator, cfg: LMConfig, dtype,
                     moe_layer: bool = False):
    dev = generator.device
    p = {"attn_norm": rmsnorm_init(cfg.d_model, device=dev, dtype=dtype),
         "mlp_norm": rmsnorm_init(cfg.d_model, device=dev, dtype=dtype)}
    if cfg.mla is not None:
        m = cfg.mla
        p["attn"] = mla_init(generator, d_model=cfg.d_model,
                             num_heads=cfg.num_heads,
                             kv_lora_rank=m.kv_lora_rank,
                             qk_nope_dim=m.qk_nope_dim,
                             qk_rope_dim=m.qk_rope_dim, v_dim=m.v_dim,
                             dtype=dtype)
    else:
        p["attn"] = gqa_init(generator, d_model=cfg.d_model,
                             num_heads=cfg.num_heads,
                             num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
                             qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                             dtype=dtype)
    if moe_layer:
        m = cfg.moe
        p["mlp"] = moe_init(generator, d_model=cfg.d_model,
                            d_expert=m.d_expert, num_experts=m.num_experts,
                            num_shared=m.num_shared, dtype=dtype)
    else:
        p["mlp"] = glu_mlp_init(generator, cfg.d_model, cfg.d_ff,
                                dtype=dtype)
    return p


def _attn_block_apply(p, cfg: LMConfig, h, positions, cache, cache_index,
                      moe_layer: bool = False):
    """``cache`` None: the stateless form; else this layer's KV (or MLA)
    cache, written in place. Returns (h, the MoE layer's aux loss, or
    None)."""
    y = rmsnorm_apply(p["attn_norm"], h)
    if cfg.mla is not None:
        m = cfg.mla
        y, _ = mla_apply(p["attn"], y, positions, num_heads=cfg.num_heads,
                         kv_lora_rank=m.kv_lora_rank,
                         qk_nope_dim=m.qk_nope_dim,
                         qk_rope_dim=m.qk_rope_dim, v_dim=m.v_dim,
                         rope_theta=cfg.rope_theta, cache=cache,
                         cache_index=cache_index)
    else:
        y, _ = gqa_apply(p["attn"], y, positions, num_heads=cfg.num_heads,
                         num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
                         rope_theta=cfg.rope_theta, cache=cache,
                         cache_index=cache_index, attn_fn=attention)
    h = h + y
    y = rmsnorm_apply(p["mlp_norm"], h)
    if not moe_layer:
        return h + glu_mlp_apply(p["mlp"], y, activation=cfg.activation,
                                 d_ff=cfg.d_ff), None
    m = cfg.moe
    y, aux = moe_apply(p["mlp"], y, num_experts=m.num_experts,
                       top_k=m.top_k, capacity_factor=m.capacity_factor,
                       group_size=m.group_size, activation=cfg.activation,
                       d_shared=m.d_expert * m.num_shared)
    return h + y, aux


def _rwkv_block_init(generator, cfg: LMConfig, dtype):
    dev = generator.device
    p = rwkv6_block_init(generator, d_model=cfg.d_model, d_ff=cfg.d_ff,
                         head_dim=cfg.ssm_head_dim, dtype=dtype)
    p["ln1"] = layernorm_init(cfg.d_model, device=dev, dtype=dtype)
    p["ln2"] = layernorm_init(cfg.d_model, device=dev, dtype=dtype)
    return p


def _assign(dst, src):
    """Write a layer's new state into its slot of the stacked state."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _rwkv_block_apply(p, cfg: LMConfig, h, state, write: bool):
    """state {"wkv", "tm_x", "cm_x"}: this layer's views, updated in place
    when ``write`` (the stateless forward discards them, and writing would
    change tensors autograd saved)."""
    x = layernorm_apply(p["ln1"], h)
    y, wkv, tm_x = time_mix_apply(p["time_mix"], x,
                                  state["tm_x"].to(h.dtype), state["wkv"],
                                  head_dim=cfg.ssm_head_dim,
                                  chunk=min(cfg.ssm_chunk, 64))
    h = h + y
    x = layernorm_apply(p["ln2"], h)
    y, cm_x = channel_mix_apply(p["channel_mix"], x,
                                state["cm_x"].to(h.dtype))
    if write:
        _assign(state, {"wkv": wkv, "tm_x": tm_x, "cm_x": cm_x})
    return h + y


def _mamba_layer_init(generator, cfg: LMConfig, dtype):
    return {"norm": rmsnorm_init(cfg.d_model, device=generator.device,
                                 dtype=dtype),
            "mamba": mamba2_block_init(generator, d_model=cfg.d_model,
                                       d_state=cfg.ssm_state,
                                       head_dim=cfg.ssm_head_dim,
                                       dtype=dtype)}


def _mamba_layer_apply(p, cfg: LMConfig, h, state, write: bool):
    """state {"ssm", "conv"}: this layer's views, updated in place when
    ``write`` (as for :func:`_rwkv_block_apply`)."""
    y, new_state = mamba2_block_apply(
        p["mamba"], rmsnorm_apply(p["norm"], h), state,
        d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
        chunk=cfg.ssm_chunk)
    if write:
        _assign(state, new_state)
    return h + y


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _stacked_init(n: int, fn):
    """``n`` draws of ``fn()`` stacked along a new leading axis, written
    layer by layer into one allocation (peak: the stack plus one layer)."""
    first = fn()
    out = tree_map(lambda a: a.new_empty((n,) + a.shape), first)
    for i in range(n):
        layer = first if i == 0 else fn()
        tree_map(lambda d, s: d[i].copy_(s), out, layer)
    return out


def init_params(generator: torch.Generator, cfg: LMConfig, *,
                dtype=torch.float32):
    """Random parameters with the JAX package's tree, shapes and (with the
    default float32) dtypes, drawn on the generator's device layer by
    layer. With ``dtype`` given every leaf is cast as it is drawn, except
    ``final_norm``, which stays float32 (see :func:`cast_params`)."""
    dev = generator.device
    params: dict[str, Any] = {"segments": {}}
    if cfg.frontend != "audio_frames":
        params["embed"] = embedding_init(generator, cfg.vocab_size,
                                         cfg.d_model, dtype=dtype)
    for seg in layout(cfg):
        if seg.kind == "attn":
            params["segments"][seg.name] = _stacked_init(
                seg.count,
                lambda: _attn_block_init(generator, cfg, dtype, seg.moe))
        elif seg.kind == "rwkv":
            params["segments"][seg.name] = _stacked_init(
                seg.count, lambda: _rwkv_block_init(generator, cfg, dtype))
        else:
            layer = lambda: _mamba_layer_init(generator, cfg, dtype)
            params["segments"][seg.name] = _stacked_init(
                seg.count, lambda: _stacked_init(seg.inner, layer))
    if cfg.shared_attn_every:
        params["shared_attn"] = _attn_block_init(generator, cfg, dtype)
    params["final_norm"] = rmsnorm_init(cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": lecun_normal(
            generator, (cfg.d_model, cfg.vocab_size), dtype=dtype)}
    return params


def cast_params(params, cfg: LMConfig):
    """The compute copy of a float32 tree (from ``init_params`` or carried
    across from the JAX package): every floating leaf in ``cfg.dtype``,
    ``final_norm`` in float32. The JAX package makes the same cast inside
    every step; here it is made once."""
    out = cast({k: v for k, v in params.items() if k != "final_norm"},
               compute_dtype(cfg))
    out["final_norm"] = cast(params["final_norm"], torch.float32)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer(tree, i):
    return tree_map(lambda a: a[i], tree)


def forward(params, cfg: LMConfig, batch, state=None, cache_index=None, *,
            train: bool = False, return_hidden: bool = False):
    """batch: {"tokens": (B,S) integers, and ``"embeds"`` (B,S,D) for
    an ``audio_frames`` config or, optionally, ``"patch_embeds"`` (B,P,D)
    for a ``vision_patches`` one (spliced in the stateless form only);
    params from :func:`cast_params`.
    With a decode state, the S tokens continue the sequence at
    ``cache_index`` and the state is updated in place. Without one
    (stateless) the recurrent blocks start from zero states and attention
    takes its cache-less form. ``train`` with ``cfg.remat`` recomputes each
    layer of the stateless form in the backward. Returns (logits (B,S,V),
    or the final-normed hidden (B,S,D) with ``return_hidden``; state or
    None)."""
    out, state, _ = _forward(params, cfg, batch, state, cache_index,
                             train=train, return_hidden=return_hidden)
    return out, state


def _forward(params, cfg: LMConfig, batch, state=None, cache_index=None, *,
             train: bool = False, return_hidden: bool = False):
    """:func:`forward`, and the MoE layers' aux losses summed (float32; a
    zero without MoE layers), the JAX package's third output."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dtype = compute_dtype(cfg)
    head = _head_weight(params, cfg)      # a leaf every config has
    if head.dtype != dtype:
        raise TypeError(f"forward: parameters in {head.dtype}, config "
                        f"{cfg.name} computes in {cfg.dtype}: pass them "
                        f"through cast_params first")
    keep = state is not None
    shard = active()
    if not keep:
        # fresh zero recurrent states, as the JAX package's blocks make
        # without one; max_len 0: no KV cache, attention is cache-less
        state, cache_index = init_decode_state(
            cfg, b, 0, device=tokens.device), 0
    positions = (cache_index
                 + torch.arange(s, device=tokens.device)).expand(b, s)
    remat = train and cfg.remat and not keep and torch.is_grad_enabled()

    def layer_fn(seg, layer_p, layer_st):
        """The layer (or super-block) as h -> (h, aux or None)."""
        if seg.kind == "rwkv":
            return lambda h: (_rwkv_block_apply(layer_p, cfg, h, layer_st,
                                                keep), None)
        if seg.kind == "attn":
            return lambda h: _attn_block_apply(
                layer_p, cfg, h, positions, layer_st["kv"] if keep else None,
                cache_index, seg.moe)

        def super_block(h):
            h, _ = _attn_block_apply(params["shared_attn"], cfg, h,
                                     positions,
                                     layer_st["attn"]["kv"] if keep
                                     else None, cache_index)
            for j in range(seg.inner):
                h = _mamba_layer_apply(_layer(layer_p, j), cfg, h,
                                       _layer(layer_st["mamba"], j), keep)
            return h, None
        return super_block

    if cfg.frontend == "audio_frames":
        h = batch["embeds"].to(dtype)
    else:
        h = _embed(params["embed"]["embedding"], tokens, cfg, shard)
        if (cfg.frontend == "vision_patches" and "patch_embeds" in batch
                and not keep):
            patches = batch["patch_embeds"]
            if patches.shape[1] > s:
                raise ValueError(
                    f"{cfg.name}: {patches.shape[1]} patch positions do "
                    f"not fit a sequence of {s} tokens")
            h = torch.cat([patches.to(dtype), h[:, patches.shape[1]:]],
                          dim=1)
    if cfg.scale_embeddings:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    aux_total = torch.zeros((), device=tokens.device)
    for seg in layout(cfg):
        seg_p = params["segments"][seg.name]
        seg_st = state[seg.name]
        for i in range(seg.count):
            fn = layer_fn(seg, _layer(seg_p, i), _layer(seg_st, i))
            h, aux = (checkpoint(fn, h, use_reentrant=False) if remat
                      else fn(h))
            if aux is not None:
                aux_total = aux_total + aux

    h = rmsnorm_apply(params["final_norm"], h)
    if not return_hidden:
        vocab_part = _vocab_part(head, cfg, shard)
        if vocab_part:
            h = gather_from_region(copy_to_region(h, shard) @ head, -1,
                                   shard)
        else:
            h = h @ head
    return h, (state if keep else None), aux_total


def _vocab_part(head, cfg: LMConfig, shard) -> bool:
    """Whether the head (d, V) holds this rank's part of the vocabulary."""
    return shard is not None and shard.is_part(head.shape[-1],
                                               cfg.vocab_size)


def _embed(table, tokens, cfg: LMConfig, shard):
    """The embedding lookup; vocab-parallel when the table holds this
    rank's rows: the ids in its range looked up, the rest zero, summed
    over the group."""
    if shard is None or not shard.is_part(table.shape[0], cfg.vocab_size):
        return table[tokens]
    lo, hi = shard.bounds(cfg.vocab_size)
    inside = (tokens >= lo) & (tokens < hi)
    rows = table[(tokens - lo).clamp(0, hi - lo - 1)]
    return reduce_from_region(
        torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device)),
        shard)


def frontend_inputs(cfg: LMConfig, tokens, *, patches: bool = True):
    """A batch of ``tokens`` (..., S) with the zero frontend inputs the
    JAX package's CLIs feed: zero frame embeddings (..., S, D) for an
    ``audio_frames`` config and, with ``patches``, zero patch embeddings
    (..., num_frontend_positions, D) for a ``vision_patches`` one (the
    serve CLI feeds none: its serve step would ignore them)."""
    batch = {"tokens": tokens}
    zeros = lambda shape: torch.zeros(shape + (cfg.d_model,),
                                      dtype=compute_dtype(cfg),
                                      device=tokens.device)
    if cfg.frontend == "audio_frames":
        batch["embeds"] = zeros(tuple(tokens.shape))
    elif cfg.frontend == "vision_patches" and patches:
        batch["patch_embeds"] = zeros(tuple(tokens.shape[:-1])
                                      + (cfg.num_frontend_positions,))
    return batch


def _head_weight(params, cfg: LMConfig):
    return (params["embed"]["embedding"].T if cfg.tie_embeddings
            else params["lm_head"]["w"])


# ---------------------------------------------------------------------------
# loss / train step
# ---------------------------------------------------------------------------


def _token_ce(logits, labels, mask, shard=None):
    """(summed cross-entropy of the masked tokens, their count), in
    float32. With ``shard`` the logits are this rank's part of the
    vocabulary: the max, the sum of exponentials and the gold logit are
    reduced over the group."""
    logits = logits.float()
    if shard is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        v = logits.shape[-1]
        lo = shard.coord * v
        top = all_reduce(logits.detach().amax(-1), shard.group, op="max")
        total = reduce_from_region(
            torch.exp(logits - top[..., None]).sum(-1), shard)
        logz = torch.log(total) + top
        inside = (labels >= lo) & (labels < lo + v)
        mine = torch.gather(logits, -1, (labels.long() - lo).clamp(
            0, v - 1)[..., None])[..., 0]
        gold = reduce_from_region(torch.where(inside, mine, 0.0), shard)
    ce = (logz - gold) * mask
    return ce.sum(), mask.sum()


def lm_loss(params, cfg: LMConfig, batch):
    """Next-token cross-entropy of float32 master ``params`` (cast to
    ``cfg.dtype`` here, so the gradient reaches the masters) -> (loss,
    {"ce", "aux"}). The last position has no label, nor have a
    ``vision_patches`` config's first ``num_frontend_positions``. With
    ``cfg.logits_chunk`` dividing S the logits are made a chunk of the
    sequence at a time. An MoE config adds ``aux_loss_weight`` times the
    layers' summed aux loss over its number of MoE layers."""
    cparams = cast_params(params, cfg)
    hidden, _, aux = _forward(cparams, cfg, batch, train=True,
                              return_hidden=True)
    tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    if cfg.frontend == "vision_patches":
        mask[:, :cfg.num_frontend_positions] = 0.0
    w = _head_weight(cparams, cfg)
    shard = active()
    if _vocab_part(w, cfg, shard):
        hidden = copy_to_region(hidden, shard)
    else:
        shard = None
    chunk = cfg.logits_chunk
    if chunk and hidden.shape[1] % chunk == 0:
        ce = n = torch.zeros((), device=hidden.device)
        for c in range(0, hidden.shape[1], chunk):
            ce_c, n_c = _token_ce(hidden[:, c:c + chunk] @ w,
                                  labels[:, c:c + chunk],
                                  mask[:, c:c + chunk], shard)
            ce, n = ce + ce_c, n + n_c
    else:
        ce, n = _token_ce(hidden @ w, labels, mask, shard)
    ce = ce / torch.clamp(n, min=1.0)
    loss = ce
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux / max(
            cfg.num_layers - cfg.moe.first_dense_layers, 1)
    return loss, {"ce": ce.detach(), "aux": aux.detach()}


def _make_grads_fn(cfg: LMConfig, tcfg: TrainConfig):
    """``grads_of(params, batch) -> (grads, loss, metrics)`` for one member,
    shared by the stock train step and the population update. With
    ``tcfg.grad_accum`` k > 1 the batch is split into k microbatches along
    its first axis and the gradients are averaged in float32."""

    def one(flat, treedef, batch):
        inputs = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss, metrics = lm_loss(unflatten(treedef, inputs), cfg, batch)
            # an empty leaf (a segment of no layers: zamba2 cut below one
            # super-block) is never used; its gradient is empty
            used = iter(torch.autograd.grad(
                loss, [x for x in inputs if x.numel()]))
        grads = [next(used) if x.numel() else torch.zeros_like(x)
                 for x in inputs]
        return grads, loss.detach(), metrics

    def grads_of(params, batch):
        flat, treedef = flatten(params)
        k = tcfg.grad_accum
        if k <= 1:
            grads, loss, metrics = one(flat, treedef, batch)
            return unflatten(treedef, list(grads)), loss, metrics
        acc, losses, rows = None, [], []
        for j in range(k):
            micro = tree_map(
                lambda x: x.reshape((k, x.shape[0] // k) + x.shape[1:])[j],
                batch)
            grads, loss, metrics = one(flat, treedef, micro)
            grads = [g.float() / k for g in grads]
            acc = grads if acc is None else [a + g for a, g in
                                             zip(acc, grads)]
            losses.append(loss)
            rows.append(metrics)
        metrics = tree_map(lambda *xs: torch.stack(xs).mean(0), *rows)
        return unflatten(treedef, acc), torch.stack(losses).mean(), metrics

    return grads_of


def _make_lr_fn(tcfg: TrainConfig):
    """``lr_at(step, lr_scale, warmup_frac)``: the static warmup-cosine
    schedule when ``warmup_frac`` is None, the dynamic one when it is a
    per-member PBT hyper; elementwise, so it takes (N,) vectors."""
    static = warmup_cosine(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
    dynamic = dynamic_warmup_cosine(tcfg.lr, tcfg.total_steps)

    def lr_at(step, lr_scale=None, warmup_frac=None):
        lr = static(step) if warmup_frac is None else dynamic(step,
                                                              warmup_frac)
        if lr_scale is not None:
            lr = lr * lr_scale
        return lr

    return lr_at


def make_train_step(cfg: LMConfig, tcfg: TrainConfig):
    """One member's step with the stock AdamW (decay, clip and schedule from
    ``tcfg``): ``(opt_init, train_step)``, ``train_step(params, opt_state,
    batch, step, lr_scale=None, weight_decay=None, warmup_frac=None) ->
    (params, opt_state, metrics)``. It launches no kernel."""
    opt_init, opt_update = adam(tcfg.lr, weight_decay=tcfg.weight_decay,
                                max_grad_norm=tcfg.max_grad_norm)
    grads_of = _make_grads_fn(cfg, tcfg)
    lr_at = _make_lr_fn(tcfg)

    def train_step(params, opt_state, batch, step, lr_scale=None,
                   weight_decay=None, warmup_frac=None):
        grads, loss, metrics = grads_of(params, batch)
        lr = lr_at(step, lr_scale, warmup_frac)
        updates, opt_state = opt_update(grads, opt_state, params,
                                        lr_override=lr,
                                        wd_override=weight_decay)
        params = apply_updates(params, updates)
        return params, opt_state, dict(metrics, loss=loss, step=step)

    return opt_init, train_step


def make_population_update(cfg: LMConfig, tcfg: TrainConfig,
                           shard: ModelShard | None = None):
    """The population-level LM update: each member's gradients (a loop over
    the members, see the module's docstring) into one flat ``(N, P)``
    buffer, then ONE ``population_adam`` step for the whole population
    (one ``pop_adam`` launch on the card, its plain version on the CPU),
    written in place: the population's parameters and moments must be in
    flat buffers (``LMAgent.population_init``), or the step raises.

    ``update(state, batch, hypers=None, generator=None, *, noise=None) ->
    (state, metrics)``: batch leaves (N, B, ...), hypers a dict of (N,)
    ``lr_scale`` / ``weight_decay`` / ``warmup_frac`` vectors (absent keys
    take ``tcfg``'s values), metrics (N,) vectors. ``generator`` and
    ``noise`` are taken for the backends' signature; the update draws
    nothing.

    With ``shard`` (a :class:`~repro_torch.models.sharding.ModelShard` of
    size above 1) the state holds this rank's parts of the members
    (``LMAgent.population_init(shard=...)``): the gradients are taken
    inside :func:`~repro_torch.models.sharding.model_parallel`, and the
    clip's per-member square-sums are summed over the group, a sharded
    leaf's from every rank and a whole leaf's (the same on every rank)
    from the first only, so every rank applies the one-rank clip scale;
    still one ``pop_adam`` launch a rank and step."""
    reduce = None
    if shard is not None and shard.size > 1:
        reduce = model_square_sums(
            [d is not None for d in shard_table(cfg, shard.size).values()],
            shard)
    _, pop_apply = population_adam(tcfg.lr, weight_decay=tcfg.weight_decay,
                                   max_grad_norm=tcfg.max_grad_norm,
                                   flat=True, reduce_square_sums=reduce)
    grads_of = _make_grads_fn(cfg, tcfg)
    lr_at = _make_lr_fn(tcfg)

    def pop_update(state, batch, hypers=None, generator=None, *,
                   noise=None):
        from repro_torch.pop.agent import LMState  # pop.agent imports lm
        h = hypers if hypers else {}
        _, grads = flat_empty(state.params)
        rows = []
        for i in range(state.step.shape[0]):
            with model_parallel(shard):
                g, loss, metrics = grads_of(
                    tree_map(lambda x: x[i], state.params),
                    tree_map(lambda x: x[i], batch))
            tree_map(lambda d, x: d[i].copy_(x), grads, g)
            del g
            rows.append(dict(metrics, loss=loss))
        lr = lr_at(state.step, h.get("lr_scale"), h.get("warmup_frac"))
        params, opt_state = pop_apply(state.params, grads, state.opt_state,
                                      lr_override=lr,
                                      wd_override=h.get("weight_decay"))
        metrics = dict(stack(rows), step=state.step)
        return LMState(params=params, opt_state=opt_state,
                       step=state.step + 1), metrics

    return pop_update


# ---------------------------------------------------------------------------
# model-sharded members: shapes and the rules' dims
# ---------------------------------------------------------------------------


class _ShapeGenerator(torch.Generator):
    """A CPU generator whose draws land on the ``meta`` device: the
    parameters' shapes and dtypes without their memory."""
    device = torch.device("meta")


def param_shapes(cfg: LMConfig):
    """One member's parameter tree on the ``meta`` device (shapes and
    dtypes only, at any size)."""
    return init_params(_ShapeGenerator(), cfg)


_SHARD_TABLES: dict = {}


def shard_table(cfg: LMConfig, size: int) -> dict:
    """{parameter path: the dimension of one member's leaf that the rules
    shard over a model axis of ``size`` ranks, or None}, in flatten
    order."""
    key = (cfg, size)
    table = _SHARD_TABLES.get(key)
    if table is None:
        from repro_torch.models.sharding import tree_paths
        shapes = param_shapes(cfg)
        dims = member_dims(shapes, ModelShard(0, size), lead=0)
        table = _SHARD_TABLES[key] = dict(zip(tree_paths(shapes), dims))
    return table


def make_serve_step(cfg: LMConfig, shard: ModelShard | None = None):
    """``serve_step(params, batch, state, cache_index) -> (logits, state)``:
    a whole prompt (prefill, ``cache_index`` 0) or one token (decode).
    With ``shard`` the step runs under ``model_parallel(shard)`` on this
    rank's parts of the parameters and of the decode state
    (``init_decode_state(..., shard=shard)``); the logits are whole on
    every rank."""
    def serve_step(params, batch, state, cache_index):
        with torch.no_grad(), model_parallel(shard):
            return forward(params, cfg, batch, state=state,
                           cache_index=cache_index)
    return serve_step


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------


def _seg_state_shape(seg: Segment, cfg: LMConfig, batch: int, max_len: int):
    dtype = compute_dtype(cfg)
    kv = ((batch, max_len, cfg.num_kv_heads, cfg.hd), dtype)
    if seg.kind == "attn" and cfg.mla is not None:
        return {"kv": {"c_kv": ((batch, max_len, cfg.mla.kv_lora_rank),
                                dtype),
                       "k_rope": ((batch, max_len, cfg.mla.qk_rope_dim),
                                  dtype)}}
    if seg.kind == "attn":
        return {"kv": {"k": kv, "v": kv}}
    if seg.kind == "rwkv":
        nh = cfg.d_model // cfg.ssm_head_dim
        return {"wkv": ((batch, nh, cfg.ssm_head_dim, cfg.ssm_head_dim),
                        torch.float32),
                "tm_x": ((batch, 1, cfg.d_model), dtype),
                "cm_x": ((batch, 1, cfg.d_model), dtype)}
    d_inner = 2 * cfg.d_model
    nh = d_inner // cfg.ssm_head_dim
    mamba = {"ssm": ((seg.inner, batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                     torch.float32),
             "conv": ((seg.inner, batch, 3, d_inner + 2 * cfg.ssm_state),
                      dtype)}
    return {"mamba": mamba, "attn": {"kv": {"k": kv, "v": kv}}}


def _map_shapes(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    return fn(*tree)


def decode_state_shapes(cfg: LMConfig, batch: int, max_len: int, *,
                        shard: ModelShard | None = None):
    """{segment: tree of (shape, dtype)}, each shape led by the segment's
    layer count: the JAX package's ``decode_state_shapes``. With
    ``shard`` each shape is this rank's part
    (:func:`repro_torch.models.sharding.decode_state_dim`)."""
    whole = {seg.name: _map_shapes(
        lambda s, d: ((seg.count,) + s, d),
        _seg_state_shape(seg, cfg, batch, max_len)) for seg in layout(cfg)}
    if shard is None or shard.size == 1:
        return whole
    dims = decode_state_dims(cfg, whole, shard.size)

    def part(tree, dim):
        if isinstance(tree, dict):
            return {k: part(v, dim[k]) for k, v in tree.items()}
        shape, dtype = tree
        if dim is None:
            return tree
        shape = list(shape)
        # a rank's part; a sequence that does not divide is padded
        shape[dim] = -(-shape[dim] // shard.size)
        return tuple(shape), dtype
    return part(whole, dims)


def init_decode_state(cfg: LMConfig, batch: int, max_len: int, *,
                      device="cpu", shard: ModelShard | None = None):
    """Zero decode state; with ``shard`` only this rank's part of each
    leaf (:func:`decode_state_shapes`)."""
    return _map_shapes(
        lambda s, d: torch.zeros(s, dtype=d, device=device),
        decode_state_shapes(cfg, batch, max_len, shard=shard))


def whole_decode_state(cfg: LMConfig, state, batch: int, max_len: int,
                       shard: ModelShard):
    """The whole decode state from every rank's part of it (an all-gather
    over ``shard.group`` along each cut dimension, the padding of a cut
    sequence dropped); every rank of the group calls it."""
    dims = decode_state_dims(
        cfg, decode_state_shapes(cfg, batch, max_len), shard.size)
    whole = decode_state_shapes(cfg, batch, max_len)

    def walk(tree, dim, shape):
        if isinstance(tree, dict):
            return {k: walk(tree[k], dim[k], shape[k]) for k in tree}
        if dim is None:
            return tree
        out = torch.cat(all_gather(tree.contiguous(), shard.group), dim=dim)
        return out.narrow(dim, 0, shape[0][dim])
    return walk(state, dims, whole)


def input_specs(cfg: LMConfig, shape: ShapeSpec, *, device="meta"):
    """Every model input of a cell as tensors on ``device`` (the ``meta``
    device by default: shapes and dtypes, nothing allocated), the JAX
    package's ``input_specs``: (B, S) tokens for train and prefill, (B, 1)
    for decode, and a frontend's embeddings."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    dtype = compute_dtype(cfg)
    batch = {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                   device=device)}
    if cfg.frontend == "audio_frames":
        batch["embeds"] = torch.zeros((b, s, cfg.d_model), dtype=dtype,
                                      device=device)
    if cfg.frontend == "vision_patches" and shape.kind != "decode":
        batch["patch_embeds"] = torch.zeros(
            (b, cfg.num_frontend_positions, cfg.d_model), dtype=dtype,
            device=device)
    return batch
