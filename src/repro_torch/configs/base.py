"""Precision policy and FNO configuration (counterpart of the FNO part of
``repro/configs/base.py``).

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
