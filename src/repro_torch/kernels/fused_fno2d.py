"""Rank-2 wrappers over the fused kernels (counterpart of
``repro/kernels/fused_fno2d.py``), with the reference's positional
operands. They pin rank 2 and call ``engine``: ``bb``/``bo``/``bh`` are
accepted and ignored, as the port plans its own launches. A CPU tensor runs
the plain versions; a CUDA tensor launches the kernels or raises.

* ``fused_fno2d_call`` — the paper's partial-fusion middle (TurboFNO §4.3):
  [truncated cDFT along X → CGEMM → padded icDFT along X] on the complex
  stage-1 output (``engine.fused_core``).
* ``fused_fno2d_full_call`` — the whole 2D spectral layer
  [rDFT_Y → cDFT_X → CGEMM → icDFT_X → irDFT_Y] in one launch
  (``engine.fused_block`` without a bypass).
* ``fused_fno2d_wgrad_call`` — the layer's weight gradient
  (``engine.fused_wgrad`` without the bypass).

For the differentiable layer use ``ops.spectral_layer_nd``; for the whole
FNO block, ``ops.fno_block_nd``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import engine


def _rank2(x: torch.Tensor, what: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"{what} takes [B,C,X,Y], got shape "
                         f"{tuple(x.shape)}")


def fused_fno2d_call(zr: torch.Tensor, zi: torch.Tensor, wr: torch.Tensor,
                     wi: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
                     gr: torch.Tensor, gi: torch.Tensor, bb: int = 0,
                     bo: int = 0, bh: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z: [B,H,X,KY] complex pair (stage-1 output); w: [O,H] or
    [O,H,KX,KY]; f: [X,KX]; g: [KX,X]. Returns the y pair [B,KY,O,X] with
    either weights (the reference's per-mode kernel emits [KY,B,O,X])."""
    _rank2(zr, "fused_fno2d_call")
    return engine.fused_core(zr, zi, wr, wi, fr, fi, gr, gi)


def fused_fno2d_full_call(x: torch.Tensor, wr: torch.Tensor,
                          wi: torch.Tensor, cr: torch.Tensor,
                          ci: torch.Tensor, fr: torch.Tensor,
                          fi: torch.Tensor, gr: torch.Tensor,
                          gi: torch.Tensor, er: torch.Tensor,
                          ei: torch.Tensor, bb: int = 0, bo: int = 0,
                          bh: int = 0) -> torch.Tensor:
    """The whole 2D spectral layer in one launch. x: [B,H,X,Y] real; w:
    [O,H] or [O,H,KX,KY]; c: [Y,KY]; f: [X,KX]; g: [KX,X]; e: [KY,Y].
    Returns y [B,O,X,Y] at x's dtype."""
    _rank2(x, "fused_fno2d_full_call")
    return engine.fused_block(x, wr, wi, None, None,
                              (cr, ci, fr, fi, gr, gi, er, ei),
                              act="linear")


def fused_fno2d_wgrad_call(x: torch.Tensor, g: torch.Tensor,
                           cr: torch.Tensor, ci: torch.Tensor,
                           fr: torch.Tensor, fi: torch.Tensor,
                           etr: torch.Tensor, eti: torch.Tensor,
                           gtr: torch.Tensor, gti: torch.Tensor,
                           bb: int = 0, bo: int = 0, bh: int = 0,
                           per_mode: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,H,X,Y] primal; g: [B,O,X,Y] cotangent; c, et: [Y,KY]; f, gt:
    [X,KX]. Returns float32 (dwr, dwi): [O,H] shared or [O,H,KX,KY]
    per-mode (the parameter layout; the reference's kernel emits
    [KY,KX,O,H])."""
    _rank2(x, "fused_fno2d_wgrad_call")
    return engine.fused_wgrad(x, g, (cr, ci, fr, fi, etr, eti, gtr, gti),
                              per_mode=per_mode, with_bypass=False)
