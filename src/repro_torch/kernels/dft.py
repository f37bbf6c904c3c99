"""The standalone row DFT kernels: wrappers, plain PyTorch versions, launch
counts (counterpart of ``repro/kernels/dft.py``, ``csrc/dft_rows.cu``).

Each transforms the last axis of its input, its leading axes flattened to
rows, as a product with a DFT operand (truncation = an operand with K
columns, zero padding = an operand with K rows):

  rdft   real x [..., N]  -> (x·Cr, x·Ci)                    [..., K]
  cdft   pair [..., N]    -> (xr·Fr − xi·Fi, xr·Fi + xi·Fr)  [..., K]
         (forward-truncated or padded-inverse, as the operand says)
  irdft  pair [..., K]    -> xr·Er − xi·Ei                   [..., N]

Every product accumulates in f32 and the result is written at the input's
dtype, as the reference writes ``x2d.dtype``. A CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises, it never falls back.
The wrappers take no tensor that requires grad: the partial variant's
backward is the fully fused adjoint (``kernels.ops.fno_block_nd``).
Launches are counted in ``engine.LAUNCHES`` as ("rdft" | "cdft" |
"irdft", dtype).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import build, engine

_F32 = torch.float32


def rdft_plain(x: torch.Tensor, cr: torch.Tensor,
               ci: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rdft`` in plain PyTorch: f32 products, emitted at x's dtype."""
    x32 = x.to(_F32)
    return (x32 @ cr.to(_F32)).to(x.dtype), (x32 @ ci.to(_F32)).to(x.dtype)


def cdft_plain(xr: torch.Tensor, xi: torch.Tensor, fr: torch.Tensor,
               fi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cdft`` in plain PyTorch: f32 products, emitted at xr's dtype."""
    a, b, m, n = (t.to(_F32) for t in (xr, xi, fr, fi))
    return (a @ m - b @ n).to(xr.dtype), (a @ n + b @ m).to(xr.dtype)


def irdft_plain(xr: torch.Tensor, xi: torch.Tensor, er: torch.Tensor,
                ei: torch.Tensor) -> torch.Tensor:
    """``irdft`` in plain PyTorch: f32 products, emitted at xr's dtype."""
    a, b, m, n = (t.to(_F32) for t in (xr, xi, er, ei))
    return (a @ m - b @ n).to(xr.dtype)


def _check(what, ins, mats):
    """Inputs share a shape [..., N_in]; the operand pair is [N_in,
    N_out]."""
    x = ins[0]
    if x.ndim < 1:
        raise ValueError(f"{what} takes [..., N] rows, got a scalar")
    engine._check_tensors(what, x, (*ins, *mats))
    n_in = x.shape[-1]
    for t in ins[1:]:
        if t.shape != x.shape:
            raise ValueError(f"{what}: real and imaginary parts differ in "
                             f"shape: {tuple(x.shape)} vs {tuple(t.shape)}")
    n_out = mats[0].shape[-1] if mats[0].ndim == 2 else -1
    for t in mats:
        if t.ndim != 2 or tuple(t.shape) != (n_in, n_out):
            raise ValueError(f"{what}: the operand must be [N_in, N_out] "
                             f"with N_in={n_in}, got {tuple(t.shape)}")


def _launch(lib, kind, ins, mats, stream):
    """Allocate the outputs and launch one row kernel through its C entry
    ``dft_rows_<kind>`` (no checks); returns the list of outputs."""
    x = ins[0]
    rows, n_in = math.prod(x.shape[:-1]), x.shape[-1]
    n_out = mats[0].shape[1]
    shape = tuple(x.shape[:-1]) + (n_out,)
    outs = [torch.empty(shape, dtype=x.dtype, device=x.device)
            for _ in range(1 if kind == "irdft" else 2)]
    err = getattr(lib, f"dft_rows_{kind}")(
        engine._DTYPE_CODES[x.dtype],
        *[t.data_ptr() for t in (*ins, *mats, *outs)], rows, n_in, n_out,
        stream)
    if err != 0:
        msg = lib.dft_rows_error_string(err).decode()
        raise RuntimeError(f"{kind} kernel launch failed: {msg} (cudaError "
                           f"{err}, rows={rows} n_in={n_in} n_out={n_out})")
    return outs


def _on_card_launch(kind, ins, mats):
    """Launch the `kind` kernel on the inputs' card and count it."""
    x = ins[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        outs = _launch(build.load_dft_rows(), kind, ins, mats, stream)
    engine.LAUNCHES[(kind, engine._dtype_name(x.dtype))] += 1
    return outs


def rdft(x: torch.Tensor, cr: torch.Tensor,
         ci: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncated real DFT of the last axis in one launch: x [..., N]
    float32 or bfloat16, (cr, ci) [N, K] at x's dtype (e.g.
    ``spectral.row_operand_tensors("rdft", …)``), all contiguous. Returns
    the pair [..., K] at x's dtype."""
    _check("rdft", (x,), (cr, ci))
    if not engine._on_card(x, "rdft"):
        return rdft_plain(x, cr, ci)
    return tuple(_on_card_launch("rdft", (x,), (cr, ci)))


def cdft(xr: torch.Tensor, xi: torch.Tensor, fr: torch.Tensor,
         fi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex DFT of the last axis in one launch: the pair [..., N], the
    operand pair [N, K] — forward-truncated ("cdft") or padded inverse
    ("icdft", then N is the kept modes and K the length). Returns the pair
    [..., K] at xr's dtype."""
    _check("cdft", (xr, xi), (fr, fi))
    if not engine._on_card(xr, "cdft"):
        return cdft_plain(xr, xi, fr, fi)
    return tuple(_on_card_launch("cdft", (xr, xi), (fr, fi)))


def irdft(xr: torch.Tensor, xi: torch.Tensor, er: torch.Tensor,
          ei: torch.Tensor) -> torch.Tensor:
    """Padded inverse real DFT of the last axis in one launch: the pair
    [..., K], the hermitian-folded operand pair [K, N]. Returns the real
    [..., N] = xr·er − xi·ei at xr's dtype."""
    _check("irdft", (xr, xi), (er, ei))
    if not engine._on_card(xr, "irdft"):
        return irdft_plain(xr, xi, er, ei)
    return _on_card_launch("irdft", (xr, xi), (er, ei))[0]
