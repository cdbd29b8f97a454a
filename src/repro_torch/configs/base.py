"""``LMConfig``, ``ShapeSpec`` (with ``LM_SHAPES`` and
``applicable_shapes``), ``HyperSpace``, ``PopulationConfig`` and
``TrainConfig``, copied from the JAX package's ``repro.configs.base``
(the port imports nothing of it).

``LMConfig`` keeps the fields that the port's LM serving and training
paths read, for the families it runs (dense attention, mixture of experts
with GQA or MLA, RWKV6 and Zamba2); ``replace`` and ``smoke`` give the
JAX package's values for them, ``MoESpec`` and ``MLASpec`` its defaults.
``frontend`` says what stands before the first layer: the embedding
table (``"none"``), precomputed audio-frame embeddings in its place
(``"audio_frames"``, no table) or a prefix of ``num_frontend_positions``
precomputed vision-patch embeddings spliced over the table's output
(``"vision_patches"``). The SSM scans always compute in float32.
There is no ``use_flash``/``use_kernels`` switch: the device decides
(the kernels on the card, their plain versions on the CPU).
Where the JAX package scales gemma's embeddings by testing the config's
``family`` and name, the port has the field ``scale_embeddings``, set by
the gemma config; it has no ``family``.

``TrainConfig.grad_compression`` (``"none"`` or ``"int8"``) selects the
data-parallel gradient reduction of :func:`repro_torch.optim.dp.
make_dp_update` (the int8 error-feedback one is ``optim/compress.py``).

``PopulationConfig`` has every field of the JAX package's but three:
``donate`` has no counterpart in the eager port, nor have ``fused_adam``
and ``fused_linear``: the port's update always runs the kernels on the
card."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    group_size: int = 256   # tokens a group: dispatch memory O(T*k*cf)
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MLASpec:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class LMConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    activation: str = "silu"       # silu -> SwiGLU, gelu -> GeGLU
    scale_embeddings: bool = False  # embeddings times sqrt(d_model) (gemma)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    block_type: str = "attention"  # attention | rwkv6 | mamba2
    ssm_state: int = 0
    ssm_head_dim: int = 64
    shared_attn_every: int = 0     # zamba2: shared attn block period
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    frontend: str = "none"         # none | audio_frames | vision_patches
    num_frontend_positions: int = 0
    dtype: str = "bfloat16"
    ssm_chunk: int = 128           # SSD/WKV chunk length
    remat: bool = True             # recompute each layer in the backward
    logits_chunk: int = 0          # >0: chunk the loss over the seq axis

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """True iff long-context (500k) decode is supported: a recurrent
        block's state does not grow with the sequence."""
        return self.block_type in ("rwkv6", "mamba2")

    def replace(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "LMConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            num_layers=min(self.num_layers,
                           2 if self.shared_attn_every == 0 else 8),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            d_ff=256,
            vocab_size=512,
            head_dim=32 if self.head_dim else None,
            dtype="float32",
            remat=False,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_expert=64,
                num_shared=min(self.moe.num_shared, 1), group_size=64)
        if self.mla is not None:
            kw["mla"] = MLASpec(kv_lora_rank=32, qk_nope_dim=16,
                                qk_rope_dim=8, v_dim=16)
        if self.shared_attn_every:
            kw["shared_attn_every"] = 4
        if self.num_frontend_positions:
            kw["num_frontend_positions"] = 8
        if self.block_type in ("rwkv6", "mamba2"):
            kw["ssm_head_dim"] = 32
            kw["ssm_state"] = 16 if self.block_type == "mamba2" else 0
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: LMConfig) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names


@dataclass(frozen=True)
class HyperSpace:
    """Per-hyperparameter prior: log-uniform or uniform ranges (paper §B.1)."""
    log_uniform: tuple = ()   # ((name, lo, hi), ...)
    uniform: tuple = ()       # ((name, lo, hi), ...)

    @property
    def names(self):
        return tuple(n for n, _, _ in self.log_uniform) + \
               tuple(n for n, _, _ in self.uniform)


@dataclass(frozen=True)
class PopulationConfig:
    """The paper's technique as a config value.

    ``strategy`` picks the outer evolution loop (size 1 always degrades to
    none); ``backend`` picks how the update executes. The port has the
    strategies ``pbt``, ``cem``, ``dvd`` and ``none`` and the backends
    ``vectorized``, ``sequential``, ``sharded`` and ``islands`` (the last
    two one rank per GPU under ``torch.distributed.run``).
    """
    size: int = 1
    strategy: str = "pbt"
    backend: str = "vectorized"
    num_steps: int = 1                   # chained update steps per call (§4.1)
    pbt_interval: int = 100_000          # trainer steps between evolve calls
    exploit_frac: float = 0.3            # paper §B.1: bottom/top 30%
    perturb_prob: float = 0.5            # resample vs perturb
    perturb_scale: float = 1.2
    hyper_space: HyperSpace = field(default_factory=HyperSpace)
    fitness_window: int = 10             # last-k fitness rows
    # CEM strategy (paper §5.2 / B.2)
    elite_frac: float = 0.5
    sigma_init: float = 1e-2
    cem_noise_init: float = 1e-2
    cem_noise_decay: float = 0.999
    # DvD strategy (§B.2 coefficient schedule)
    dvd_period: int = 20_000


@dataclass(frozen=True)
class TrainConfig:
    """LM training: the optimizer's settings and the warmup-cosine
    schedule (``models.lm.make_train_step``)."""
    lr: float = 3e-4
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    seed: int = 0
    population: PopulationConfig = field(default_factory=PopulationConfig)
    grad_compression: str = "none"       # none | int8
    grad_accum: int = 1                  # microbatches per optimizer step

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
