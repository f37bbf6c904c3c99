"""SpectralConv functions — the FNO Fourier layer and the whole FNO block
(counterpart of ``repro/core/spectral_conv.py``).

Functional style: ``init_*(generator, …) -> params``, ``apply_*(params, x)``.
Channel-first layout [B, C, *spatial].
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.base import PrecisionPolicy
from repro_torch.kernels import ops


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
                      policy: Optional[PrecisionPolicy] = None
                      ) -> torch.Tensor:
    """x: [B, C_in, *spatial] -> [B, C_out, *spatial] on an oracle path."""
    return ops.spectral_layer_nd(x, params["wr"], params["wi"], modes,
                                 path=path, policy=policy)


def apply_fno_block_nd(spec_params: Dict[str, torch.Tensor],
                       byp_params: Dict[str, torch.Tensor], x: torch.Tensor,
                       modes: Sequence[int], *, path: str = "fused",
                       variant: str = "full",
                       policy: Optional[PrecisionPolicy] = None
                       ) -> torch.Tensor:
    """One whole FNO block — gelu(spectral(x) + 1×1 bypass + bias) — as a
    single kernel launch on the fused path (variant="full"), or the paper's
    partial fusion (variant="partial": row DFT, fused core, row iDFT, then
    the tail), any rank.

    spec_params: {"wr","wi"}; byp_params: {"w","b"} from
    ``core.fno._dense_init``, where w is [C_in, C_out] — transposed here to
    the kernel's [O,H] layout."""
    wb = byp_params["w"].transpose(0, 1)
    return ops.fno_block_nd(x, spec_params["wr"], spec_params["wi"], wb,
                            byp_params["b"], tuple(modes), path=path,
                            variant=variant, policy=policy)
