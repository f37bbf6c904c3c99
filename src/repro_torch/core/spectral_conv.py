"""SpectralConv functions — the FNO Fourier layer and the whole FNO block
(counterpart of ``repro/core/spectral_conv.py``).

Functional style: ``init_*(generator, …) -> params``, ``apply_*(params, x)``.
Channel-first layout [B, C, *spatial].
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import PrecisionPolicy
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops


def require_fused(path: str) -> None:
    """Refuse an oracle path inside a multi-rank sharding context: only the
    fused path has a sharded dispatch."""
    if path != "fused":
        raise ValueError(
            f"path {path!r} does not run under a multi-rank sharding "
            f"context: only the fused path is sharded (run the staged and "
            f"ref oracles on one rank)")


def init_spectral_nd(gen: torch.Generator, in_ch: int, out_ch: int,
                     modes: Sequence[int], weight_mode: str = "shared",
                     dtype: torch.dtype = torch.float32,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """Spectral-weight init: W [O,I] shared (the paper's CGEMM) or
    [O,I,k_1..k_R] per-mode, scaled by 1/sqrt(I·O). Drawn on the CPU from
    `gen` so a seed gives the same weights on every device."""
    scale = 1.0 / (in_ch * out_ch) ** 0.5
    shape = ((out_ch, in_ch) if weight_mode == "shared"
             else (out_ch, in_ch) + tuple(modes))
    draw = lambda: (scale * torch.randn(shape, generator=gen)).to(
        device=device, dtype=dtype)
    return {"wr": draw(), "wi": draw()}


def apply_spectral_nd(params: Dict[str, torch.Tensor], x: torch.Tensor,
                      modes: Sequence[int], *, path: str = "staged",
                      variant: str = "full",
                      policy: Optional[PrecisionPolicy] = None
                      ) -> torch.Tensor:
    """x: [B, C_in, *spatial] -> [B, C_out, *spatial]: the bare spectral
    layer, on the fused path the paper's fused FFT→CGEMM→iFFT with its
    fused backward (`variant` "full" or "partial"; at rank 1 both are the
    one launch, as the reference's ``apply_spectral_1d`` has no variant),
    or an oracle path ("ref"/"staged")."""
    return ops.spectral_layer_nd(x, params["wr"], params["wi"], modes,
                                 path=path, variant=variant, policy=policy)


def apply_fno_block_nd(spec_params: Dict[str, torch.Tensor],
                       byp_params: Dict[str, torch.Tensor], x: torch.Tensor,
                       modes: Sequence[int], *, path: str = "fused",
                       variant: str = "full",
                       policy: Optional[PrecisionPolicy] = None,
                       ends: Optional[Tuple] = None,
                       tp_layout: str = "psum",
                       tp_overlap: bool = False) -> torch.Tensor:
    """One whole FNO block — gelu(spectral(x) + 1×1 bypass + bias) — as a
    single kernel launch on the fused path (variant="full"), or the paper's
    partial fusion (variant="partial": row DFT, fused core, row iDFT, then
    the tail), any rank.

    spec_params: {"wr","wi"}; byp_params: {"w","b"} from
    ``core.fno._dense_init``, where w is [C_in, C_out] — transposed here to
    the kernel's [O,H] layout.

    ends: an optional (lift, proj) pair of the model's end-MLP params
    ((w, b, w, b) tuples or None) folded into this block's launch
    (``ops.fno_block_ends_nd``).

    Inside a multi-rank ``sharding_context`` the block runs through
    ``ops.fno_block_nd_sharded``: DP over the context's batch axes, TP over
    its model axis with the partials completed per `tp_layout` ("scatter":
    a reduce-scatter into the next layer's hidden shard, as a ring with
    `tp_overlap`; "psum": an all-reduce). Only the fused path runs there:
    the "staged" and "ref" oracles raise. The single-rank path ignores
    tp_layout and tp_overlap."""
    wb = byp_params["w"].transpose(0, 1)
    ctx = shd.active_context()
    if ctx is not None:
        require_fused(path)
        return ops.fno_block_nd_sharded(
            x, spec_params["wr"], spec_params["wi"], wb, byp_params["b"],
            tuple(modes), ctx=ctx, variant=variant, policy=policy,
            tp_layout=tp_layout, tp_overlap=tp_overlap, ends=ends)
    if ends is not None and any(e is not None for e in ends):
        return ops.fno_block_ends_nd(
            x, spec_params["wr"], spec_params["wi"], wb, byp_params["b"],
            tuple(modes), lift=ends[0], proj=ends[1], path=path,
            variant=variant, policy=policy)
    return ops.fno_block_nd(x, spec_params["wr"], spec_params["wi"], wb,
                            byp_params["b"], tuple(modes), path=path,
                            variant=variant, policy=policy)
