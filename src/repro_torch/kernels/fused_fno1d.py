"""Rank-1 wrappers over the fused kernels (counterpart of
``repro/kernels/fused_fno1d.py``), with the reference's positional
operands. They pin rank 1 and call ``engine``: ``bb``/``bo``/``bh`` are
accepted and ignored, as the port plans its own launches. A CPU tensor runs
the plain versions; a CUDA tensor launches the kernels or raises.

For the differentiable layer use ``ops.spectral_layer_nd``; for the whole
FNO block, ``ops.fno_block_nd``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import engine


def _rank1(x: torch.Tensor) -> None:
    if x.ndim != 3:
        raise ValueError(f"fused_fno1d takes [B,C,N], got shape "
                         f"{tuple(x.shape)}")


def fused_fno1d_call(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                     cr: torch.Tensor, ci: torch.Tensor, er: torch.Tensor,
                     ei: torch.Tensor, bb: int = 0, bo: int = 0,
                     bh: int = 0) -> torch.Tensor:
    """The bare spectral layer in one launch. x: [B,H,N] real; w: [O,H] or
    [O,H,K]; c: [N,K]; e: [K,N] -> y [B,O,N] at x's dtype."""
    _rank1(x)
    return engine.fused_block(x, wr, wi, None, None, (cr, ci, er, ei),
                              act="linear")


def fused_fno1d_wgrad_call(x: torch.Tensor, g: torch.Tensor,
                           cr: torch.Tensor, ci: torch.Tensor,
                           etr: torch.Tensor, eti: torch.Tensor,
                           bb: int = 0, bo: int = 0, bh: int = 0,
                           per_mode: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bare layer's weight gradient in one launch. x: [B,H,N] primal;
    g: [B,O,N] cotangent; c, et: [N,K]. Returns float32 (dwr, dwi): [O,H]
    shared, or [O,H,K] per-mode (the parameter layout; the reference's
    kernel emits [K,O,H])."""
    _rank1(x)
    return engine.fused_wgrad(x, g, (cr, ci, etr, eti), per_mode=per_mode,
                              with_bypass=False)
