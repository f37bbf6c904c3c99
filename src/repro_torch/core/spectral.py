"""Spectral-transform algebra: truncated DFTs as matmuls (counterpart of
``repro/core/spectral.py``).

The operand factories are host-side numpy, built in float64 and cast to
float32 exactly as the reference builds them, so the bundles are
bit-equal to the reference's in f32. Transforms act on the LAST axis;
complex tensors travel as (real, imag) pairs of real tensors.

The TPU's 128-lane mode padding (``pad_modes_to``) is not ported: the
Hopper kernel masks its own ragged edges.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype

_F32 = torch.float32


# ---------------------------------------------------------------------------
# DFT matrix factories (host-side numpy; cached; O(N·k) memory)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def rdft_mats(n: int, modes: int,
              dtype: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """Forward truncated real-input DFT X[m] = Σ_n x[n]·e^{-2πi mn/N}.

    Returns (Cr, Ci), each [n, modes] at `dtype` (built in float64): Xr =
    x @ Cr, Xi = x @ Ci.
    """
    if modes > n // 2 + 1:
        raise ValueError(f"modes {modes} > n//2+1 for n={n}")
    m = np.arange(modes)[None, :]
    k = np.arange(n)[:, None]
    ang = 2.0 * np.pi * k * m / n
    return np.cos(ang).astype(dtype), (-np.sin(ang)).astype(dtype)


@functools.lru_cache(maxsize=64)
def irdft_mats(n: int, modes: int,
               dtype: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of (truncate ∘ rFFT) with implicit zero padding:

        y[j] = (1/N)·Σ_{m<modes} c_m·(Xr[m]·cos(2πmj/N) − Xi[m]·sin(2πmj/N)),

    with the hermitian fold c_0 = 1, c_m = 2, c_{N/2} = 1. Returns
    (Er, Ei), each [modes, n]: y = Xr @ Er − Xi @ Ei.
    """
    if modes > n // 2 + 1:
        raise ValueError(f"modes {modes} > n//2+1 for n={n}")
    m = np.arange(modes)[:, None]
    j = np.arange(n)[None, :]
    ang = 2.0 * np.pi * m * j / n
    c = np.full((modes, 1), 2.0)
    c[0] = 1.0
    if modes == n // 2 + 1 and n % 2 == 0:
        c[-1] = 1.0  # Nyquist bin is its own conjugate
    return ((c * np.cos(ang) / n).astype(dtype),
            (c * np.sin(ang) / n).astype(dtype))


@functools.lru_cache(maxsize=64)
def cdft_mats(n: int, modes: int, inverse: bool = False,
              dtype: str = "float32") -> Tuple[np.ndarray, np.ndarray]:
    """Complex truncated DFT matrix: forward F[k, m] = e^{-2πi km/N}
    ([n, modes]); inverse E[m, j] = e^{+2πi mj/N}/N ([modes, n]).

    Keeps only the FIRST `modes` bins (TurboFNO's convention), so the
    truncate → pad → inverse round trip is a projection."""
    if not inverse:
        k = np.arange(n)[:, None]
        m = np.arange(modes)[None, :]
        ang = 2.0 * np.pi * k * m / n
        return np.cos(ang).astype(dtype), (-np.sin(ang)).astype(dtype)
    m = np.arange(modes)[:, None]
    j = np.arange(n)[None, :]
    ang = 2.0 * np.pi * m * j / n
    return (np.cos(ang) / n).astype(dtype), (np.sin(ang) / n).astype(dtype)


# ---------------------------------------------------------------------------
# Adjoint (transposed) factories — the backward kernels' operands.
#
# The spectral layer y = Re(((x·C)∘W)·E) is real-linear, so its adjoint in x
# is the SAME fused DFT → CGEMM → iDFT pipeline with every DFT operand
# transposed (no conjugation: conjugating every factor at once leaves the
# real part unchanged) and the weight transposed over (out, hidden).
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def rdft_adjoint_mats(n: int, modes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Transposed truncated-rDFT operands, each [modes, n]: the adjoint
    pipeline's last inverse-slot stage, dx = Tr @ Crᵀ − Ti @ Ciᵀ."""
    cr, ci = rdft_mats(n, modes)
    return np.ascontiguousarray(cr.T), np.ascontiguousarray(ci.T)


@functools.lru_cache(maxsize=64)
def irdft_adjoint_mats(n: int, modes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Transposed padded-irDFT operands, each [n, modes]: the adjoint
    pipeline's first forward-slot stage, G = g @ Erᵀ + i·(g @ Eiᵀ)."""
    er, ei = irdft_mats(n, modes)
    return np.ascontiguousarray(er.T), np.ascontiguousarray(ei.T)


@functools.lru_cache(maxsize=64)
def cdft_adjoint_mats(n: int, modes: int,
                      inverse: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Transposed complex-DFT operands: forward transposed [modes, n]
    (adjoint inverse slot); inverse transposed [n, modes] (adjoint forward
    slot)."""
    fr, fi = cdft_mats(n, modes, inverse)
    return np.ascontiguousarray(fr.T), np.ascontiguousarray(fi.T)


# ---------------------------------------------------------------------------
# Rank-generic fused-kernel operand bundles: R forward-slot stages in kernel
# order (axis s_R first, each [n, k]) then R inverse-slot stages (axis s_1
# first, each [k, n]). adjoint=True swaps every operand for its transpose:
# the backward's dx pipeline.
# ---------------------------------------------------------------------------
def _fused_mat_pairs(spatial, modes, adjoint=False):
    """numpy (mr, mi) pairs: R forward-slot then R inverse-slot operands."""
    r = len(spatial)
    fwd, inv = [], []
    for i in range(r):  # forward stages transform axes s_R, s_{R-1}, …, s_1
        ax = r - 1 - i
        n, k = spatial[ax], modes[ax]
        if ax == r - 1:  # the real-input axis
            fwd.append(irdft_adjoint_mats(n, k) if adjoint
                       else rdft_mats(n, k))
        else:
            fwd.append(cdft_adjoint_mats(n, k, True) if adjoint
                       else cdft_mats(n, k, False))
    for ax in range(r):  # inverse stages transform axes s_1, …, s_R
        n, k = spatial[ax], modes[ax]
        if ax == r - 1:
            inv.append(rdft_adjoint_mats(n, k) if adjoint
                       else irdft_mats(n, k))
        else:
            inv.append(cdft_adjoint_mats(n, k, False) if adjoint
                       else cdft_mats(n, k, True))
    return fwd + inv


def _flat(pairs) -> Tuple[np.ndarray, ...]:
    out = []
    for mr, mi in pairs:
        out += [mr, mi]
    return tuple(out)


@functools.lru_cache(maxsize=256)
def fused_operand_mats(spatial: Tuple[int, ...], modes: Tuple[int, ...],
                       adjoint: bool = False) -> Tuple[np.ndarray, ...]:
    """Flat float32 operand tuple for the fused block kernel: (cr, ci) per
    forward-slot stage then (er, ei) per inverse-slot stage; adjoint=True
    gives the dx pipeline's transposed bundle."""
    return _flat(_fused_mat_pairs(tuple(spatial), tuple(modes), adjoint))


@functools.lru_cache(maxsize=256)
def wgrad_operand_mats(spatial: Tuple[int, ...],
                       modes: Tuple[int, ...]) -> Tuple[np.ndarray, ...]:
    """Flat float32 operand tuple for the fused weight-gradient kernel: R
    forward stages for the primal spectrum A, then R adjoint-forward stages
    (transposed inverse transforms) that push the cotangent into the
    spectral domain as Ĝ. All [n, k], axis s_R first."""
    r = len(spatial)
    spatial, modes = tuple(spatial), tuple(modes)
    return _flat(_fused_mat_pairs(spatial, modes, False)[:r]
                 + _fused_mat_pairs(spatial, modes, True)[:r])


_BUNDLES = {
    "forward": lambda sp, m: fused_operand_mats(sp, m),
    "adjoint": lambda sp, m: fused_operand_mats(sp, m, adjoint=True),
    "wgrad": wgrad_operand_mats,
}


def operand_tensors(spatial, modes, dtype: str, device,
                    kind: str = "forward") -> Tuple[torch.Tensor, ...]:
    """An operand bundle — "forward" (block forward and gz recompute),
    "adjoint" (dx) or "wgrad" — as contiguous torch tensors at `dtype` (the
    policy's spectral dtype) on `device`; cached per (shapes, dtype, device,
    kind) so repeated layer calls reuse the device copies."""
    if kind not in _BUNDLES:
        raise ValueError(f"kind must be one of {tuple(_BUNDLES)}, got "
                         f"{kind!r}")
    return _operand_tensors(tuple(int(s) for s in spatial),
                            tuple(int(m) for m in modes), dtype,
                            str(torch.device(device)), kind)


@functools.lru_cache(maxsize=64)
def _operand_tensors(spatial, modes, dtype, device, kind):
    dt = torch_dtype(dtype)
    return tuple(torch.from_numpy(m).to(device=device, dtype=dt).contiguous()
                 for m in _BUNDLES[kind](spatial, modes))


# ---------------------------------------------------------------------------
# Partial-fusion operands. The outer axes s_2..s_R are separable, so their
# forward transforms compose into ONE matmul with the Kronecker product of
# the per-axis DFT matrices: the reference's single row launch, and the
# plain versions of ``kernels/dft.py``'s outer transforms (the CUDA kernel
# takes the per-axis factors instead). Rows index the flattened (s_2..s_R)
# in natural order, columns (k_R..k_2): the spectrum layout the fused core
# expects. Built in float64 and cast to float32, as the reference builds
# them.
# ---------------------------------------------------------------------------
def _kron_ordered(factors):
    """Combine complex per-axis factors F_j[a_j, b_j] (axis order s_2..s_R)
    into M[(a_2..a_R), (b_R..b_2)]."""
    r1 = len(factors)
    subs_in = [f"{chr(97 + 2 * j)}{chr(98 + 2 * j)}" for j in range(r1)]
    rows = "".join(s[0] for s in subs_in)
    cols = "".join(subs_in[j][1] for j in reversed(range(r1)))
    m = np.einsum(",".join(subs_in) + "->" + rows + cols, *factors)
    nr = int(np.prod([f.shape[0] for f in factors]))
    nc = int(np.prod([f.shape[1] for f in factors]))
    return m.reshape(nr, nc)


@functools.lru_cache(maxsize=64)
def outer_fwd_mats(outer_spatial: Tuple[int, ...], outer_modes: Tuple[int, ...]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Combined forward operand for the outer axes (s_2..s_R): real input,
    truncated spectrum out. float32 [Πn_j, Πk_j], columns (k_R..k_2)."""
    factors = []
    for n, k in zip(outer_spatial, outer_modes):
        fr, fi = cdft_mats(n, k, False, "float64")
        factors.append(fr + 1j * fi)
    m = _kron_ordered(factors)
    return m.real.astype(np.float32), m.imag.astype(np.float32)


@functools.lru_cache(maxsize=64)
def outer_inv_mats(outer_spatial: Tuple[int, ...], outer_modes: Tuple[int, ...]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Combined inverse operand for the outer axes: padded complex inverse
    along s_2..s_{R-1} and the hermitian-folded real inverse along s_R.
    float32 [Πk_j, Πn_j], rows (k_R..k_2), columns (s_2..s_R); consumed as
    y = Xr@Er − Xi@Ei (only the real part survives)."""
    factors = []
    last = len(outer_spatial) - 1
    for j, (n, k) in enumerate(zip(outer_spatial, outer_modes)):
        er, ei = (irdft_mats(n, k, "float64") if j == last
                  else cdft_mats(n, k, True, "float64"))
        factors.append(er + 1j * ei)
    # Factors fed reversed (s_R..s_2) give rows (k_R..k_2) and columns
    # (s_2..s_R).
    m = _kron_ordered(factors[::-1])
    return m.real.astype(np.float32), m.imag.astype(np.float32)


# Operands of the row kernels (kernels/dft.py), by kind, over the axes
# `spatial` / `modes` they transform: [N_in, N_out] pairs.
_ROW_MATS = {
    "rdft": lambda sp, m: rdft_mats(sp[0], m[0]),
    "irdft": lambda sp, m: irdft_mats(sp[0], m[0]),
    "cdft": lambda sp, m: cdft_mats(sp[0], m[0], False),
    "icdft": lambda sp, m: cdft_mats(sp[0], m[0], True),
    "outer_fwd": outer_fwd_mats,
    "outer_inv": outer_inv_mats,
}


def row_operand_tensors(kind: str, spatial, modes, dtype: str,
                        device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A row kernel's operand pair — "rdft", "irdft", "cdft", "icdft" over
    one axis (n,)/(k,), or "outer_fwd"/"outer_inv" over the outer axes
    (s_2..s_R)/(k_2..k_R) — as contiguous tensors at `dtype` on `device`,
    cast from the float32 operand as the reference casts it; cached like
    ``operand_tensors``."""
    if kind not in _ROW_MATS:
        raise ValueError(f"kind must be one of {tuple(_ROW_MATS)}, got "
                         f"{kind!r}")
    return _row_tensors(kind, tuple(int(s) for s in spatial),
                        tuple(int(m) for m in modes), dtype,
                        str(torch.device(device)))


@functools.lru_cache(maxsize=64)
def _row_tensors(kind, spatial, modes, dtype, device):
    dt = torch_dtype(dtype)
    return tuple(torch.from_numpy(m).to(device=device, dtype=dt).contiguous()
                 for m in _ROW_MATS[kind](spatial, modes))


# ---------------------------------------------------------------------------
# Staged transforms (matmul formulation, one library matmul per stage). The
# operands are cast to the input's dtype and the products accumulate in f32,
# as the reference's preferred_element_type=f32 dots do.
# ---------------------------------------------------------------------------
def _mats_like(pair, like: torch.Tensor):
    """Operand pair rounded to `like`'s dtype, carried as f32."""
    return tuple(torch.from_numpy(m).to(like.device, like.dtype).to(_F32)
                 for m in pair)


def truncated_rdft(x: torch.Tensor, modes: int):
    """rFFT along the last axis, keeping the first `modes` bins."""
    cr, ci = _mats_like(rdft_mats(x.shape[-1], modes), x)
    x32 = x.to(_F32)
    return x32 @ cr, x32 @ ci


def padded_irdft(xr: torch.Tensor, xi: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse rFFT from `modes` kept bins, zero-padded to length n."""
    er, ei = _mats_like(irdft_mats(n, xr.shape[-1]), xr)
    return xr.to(_F32) @ er - xi.to(_F32) @ ei


def truncated_cdft(xr: torch.Tensor, xi: torch.Tensor, modes: int):
    """Complex DFT along the last axis keeping the first `modes` bins."""
    fr, fi = _mats_like(cdft_mats(xr.shape[-1], modes, False), xr)
    xr, xi = xr.to(_F32), xi.to(_F32)
    return xr @ fr - xi @ fi, xr @ fi + xi @ fr


def padded_icdft(xr: torch.Tensor, xi: torch.Tensor, n: int):
    """Inverse complex DFT from first-`modes` bins zero-padded to n."""
    er, ei = _mats_like(cdft_mats(n, xr.shape[-1], True), xr)
    xr, xi = xr.to(_F32), xi.to(_F32)
    return xr @ er - xi @ ei, xr @ ei + xi @ er
