"""Model, shape, precision and FNO configurations (counterpart of
``repro/configs/base.py``).

``ModelConfig`` describes every architecture of the LM zoo; the unified
transformer (``repro_torch.models.transformer``) interprets it.
``ShapeSpec`` names an input-shape cell (``SHAPES``; ``SMOKE_SHAPES`` are
their CPU sizes).

``FNOConfig.block_plan`` overrides the fused launches' plans field by
field (``repro_torch.tuning``); the reference's (bb, bo, bh) triple is a
TPU tiling and has no counterpart: the CUDA kernels' plans have their own
fields.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a policy dtype name."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype name {name!r}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unified LM-family architecture description."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    attention: str = "full"  # full | swa | local_global | bidirectional | none
    window_size: int = 0  # for swa / local layers of local_global
    local_per_global: int = 0  # local_global: N local layers per global layer
    qkv_bias: bool = False
    logit_softcap: float = 0.0

    # --- positional encoding ---
    rope_style: str = "full"  # full | partial | none
    rope_fraction: float = 1.0  # fraction of head_dim rotated (partial RoPE)
    rope_base: float = 10000.0

    # --- mlp / norm ---
    mlp: str = "swiglu"  # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # --- hybrid (Hymba) ---
    hybrid_parallel: bool = False  # attention and SSM heads in parallel
    global_layers: Tuple[int, ...] = ()  # layer indices using full attention

    # --- modality frontend (a stub: the caller provides embeddings) ---
    frontend: str = "none"  # none | audio | vision
    num_prefix_embeds: int = 0  # VLM: patch embeddings prepended to tokens

    dtype: str = "bfloat16"

    @property
    def d_attn(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def d_kv(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_decoder(self) -> bool:
        return self.attention != "bidirectional"

    @property
    def has_attention(self) -> bool:
        return self.attention != "none"

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def sub_quadratic(self) -> bool:
        """True when seq-len scaling is sub-quadratic (SSM / windowed)."""
        if not self.has_attention:
            return True
        return (self.attention in ("swa", "local_global")
                or self.hybrid_parallel)

    def param_count(self, active_only: bool = False) -> int:
        """The parameter count behind MODEL_FLOPS = 6·N·D, the
        reference's (``active_only``: the top-k experts of a MoE layer
        instead of all of them)."""
        d, f = self.d_model, self.d_ff
        emb = self.vocab_size * d
        per_layer = 0
        if self.has_attention:
            per_layer += d * self.d_attn + 2 * d * self.d_kv  # QKV
            per_layer += self.d_attn * d  # O
            if self.qkv_bias:
                per_layer += self.d_attn + 2 * self.d_kv
        if self.has_ssm:
            di = self.d_inner
            per_layer += d * 2 * di  # in_proj (x, z)
            per_layer += d * 2 * self.ssm_state  # B, C proj (ngroups=1)
            per_layer += d * self.ssm_heads  # dt proj
            per_layer += di * self.ssm_conv_width  # depthwise conv
            per_layer += di * d  # out proj
            per_layer += 2 * self.ssm_heads  # A_log, D
        gated = self.mlp in ("swiglu", "geglu")
        mlp_p = d * f * (3 if gated else 2)
        if self.num_experts:
            experts = self.top_k if active_only else self.num_experts
            per_layer += experts * mlp_p + d * self.num_experts  # + router
            if self.dense_residual:
                per_layer += mlp_p
        elif f > 0:
            per_layer += mlp_p
        per_layer += 2 * d  # norms
        total = emb + self.num_layers * per_layer + d
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        return total

    def validate(self) -> None:
        def need(ok: bool, msg: str) -> None:
            if not ok:
                raise ValueError(f"{self.name}: {msg}")

        need(self.d_model > 0 and self.num_layers > 0,
             "d_model and num_layers must be positive")
        if self.has_attention:
            need(self.num_heads % max(self.num_kv_heads, 1) == 0,
                 f"num_heads {self.num_heads} not divisible by "
                 f"num_kv_heads {self.num_kv_heads}")
        if self.num_experts:
            need(0 < self.top_k <= self.num_experts,
                 f"top_k {self.top_k} not in 1..{self.num_experts}")
        if self.has_ssm:
            need(self.d_inner % self.ssm_head_dim == 0,
                 f"d_inner={self.d_inner} not divisible by "
                 f"ssm_head_dim={self.ssm_head_dim}")
        if self.attention == "local_global":
            need(self.local_per_global > 0 and self.window_size > 0,
                 "local_global needs local_per_global and window_size")
        if self.attention == "swa":
            need(self.window_size > 0, "swa needs window_size")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Reduced shapes for CPU smoke tests.
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 64, 2, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 128, 1, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 128, 2, "decode"),
    "long_500k": ShapeSpec("long_500k", 256, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One precision policy for the whole spectral stack.

      * ``param_dtype``    — master-parameter storage.
      * ``compute_dtype``  — activation / kernel I/O dtype; ``apply_fno``
        casts the input once, the block casts its operands.
      * ``spectral_dtype`` — the DFT operand matrices.
      * ``accum_dtype``    — kernel accumulators (f32 under bf16 too).
      * ``grad_acc_dtype`` — microbatch gradient accumulation (training).
    """

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    spectral_dtype: str = "float32"
    accum_dtype: str = "float32"
    grad_acc_dtype: str = "float32"

    _ALIASES = {"f32": "float32", "float32": "float32",
                "bf16": "bfloat16", "bfloat16": "bfloat16"}

    @classmethod
    def from_name(cls, name: str) -> "PrecisionPolicy":
        """"f32" → pure f32; "bf16" → bf16 compute and spectral operands
        with f32 master params, accumulators and grad accumulation. Any
        other name is a uniform policy at that dtype (f32 accumulation)."""
        canon = cls._ALIASES.get(name)
        if canon is None:
            return cls(param_dtype=name, compute_dtype=name,
                       spectral_dtype=name)
        if canon == "float32":
            return cls()
        return cls(compute_dtype="bfloat16", spectral_dtype="bfloat16")


@dataclasses.dataclass(frozen=True)
class FNOConfig:
    """Fourier Neural Operator configuration (the paper's architecture)."""

    name: str
    ndim: int  # 1, 2, or 3
    hidden: int
    num_layers: int
    in_channels: int
    out_channels: int
    spatial: Tuple[int, ...]
    modes: Tuple[int, ...]  # kept low-frequency modes per spatial axis
    weight_mode: str = "shared"  # shared (paper CGEMM) | per_mode
    lifting_dim: int = 0  # 0 => 2*hidden
    path: str = "staged"  # ref | staged | fused
    dtype: str = "float32"  # precision preset name
    policy: Optional[PrecisionPolicy] = None  # explicit override of `dtype`
    # Whole-block fusion on the fused path: spectral + 1x1 bypass + bias +
    # GELU in ONE kernel launch per layer (kernels/ops.fno_block_nd).
    fuse_block: bool = False
    # Fold the lifting MLP into the FIRST fused block launch and the
    # projection MLP into the LAST one (kernels/ops.fno_block_ends_nd), so
    # the lifted and projected activations never reach device memory.
    # Fused path with fuse_block only; ignored otherwise.
    fuse_ends: bool = False
    # The TP inter-layer collective layout (``kernels.ops.
    # fno_block_nd_sharded``): "scatter" completes each interior layer's
    # sharded hidden contraction with a reduce-scatter that emits the next
    # layer's hidden shard (half the wire bytes of "psum"); "psum"
    # all-reduces every layer to a replicated pre-activation. The last
    # layer always all-reduces. Ignored when TP is off.
    tp_layout: str = "scatter"  # scatter | psum
    # The scattered layout's reduce-scatter as a ring of tp-1 point-to-point
    # hops instead of one collective (same sum, same shard).
    tp_overlap: bool = False
    # An explicit override of the fused launches' plans: sorted (field,
    # value) pairs of ``tuning.plans.FIELDS`` (the block kernel's cluster,
    # chain, rows_f, rows_i; the wgrad's cols; the core's np, nb, kc, ri,
    # wj), each launch taking the fields its kernel has. None (the
    # default): the tuned cache, then the rule planner
    # (``tuning.resolve_plan``). See configs.fno.with_block_plan.
    block_plan: Optional[Tuple[Tuple[str, Any], ...]] = None

    @property
    def precision(self) -> PrecisionPolicy:
        return self.policy or PrecisionPolicy.from_name(self.dtype)

    def param_count(self) -> int:
        h = self.hidden
        lift = self.lifting_dim or 2 * h
        p = self.in_channels * lift + lift * h
        per_layer = 2 * h * h
        if self.weight_mode == "per_mode":
            per_layer *= math.prod(self.modes)
        per_layer += h * h + h
        p += self.num_layers * per_layer
        p += h * lift + lift * self.out_channels
        return p

    def validate(self) -> None:
        if self.ndim not in (1, 2, 3) or len(self.spatial) != self.ndim:
            raise ValueError(f"{self.name}: ndim {self.ndim} does not match "
                             f"spatial {self.spatial}")
        if len(self.modes) != self.ndim:
            raise ValueError(f"{self.name}: modes {self.modes} must have "
                             f"{self.ndim} entries")
        for m, s in zip(self.modes, self.spatial):
            if not 0 < m <= s // 2:
                raise ValueError(f"{self.name}: modes {m} must be <= "
                                 f"{s // 2} (Nyquist excl.)")
        if self.path not in ("ref", "staged", "fused"):
            raise ValueError(f"{self.name}: unknown path {self.path!r}")
        if self.tp_layout not in ("scatter", "psum"):
            raise ValueError(f"{self.name}: tp_layout must be 'scatter' or "
                             f"'psum', got {self.tp_layout!r}")
        if self.block_plan is not None:
            from repro_torch.tuning.plans import normalize_override
            try:
                ok = normalize_override(self.block_plan) == tuple(
                    self.block_plan)
            except (TypeError, ValueError) as exc:
                raise ValueError(f"{self.name}: block_plan: {exc}") from None
            if not ok:
                raise ValueError(
                    f"{self.name}: block_plan must be sorted (field, value) "
                    f"pairs without zero fields, as with_block_plan makes "
                    f"them, got {self.block_plan!r}")
