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
def rdft_mats(n: int, modes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Forward truncated real-input DFT X[m] = Σ_n x[n]·e^{-2πi mn/N}.

    Returns (Cr, Ci), each [n, modes] float32: Xr = x @ Cr, Xi = x @ Ci.
    """
    if modes > n // 2 + 1:
        raise ValueError(f"modes {modes} > n//2+1 for n={n}")
    m = np.arange(modes)[None, :]
    k = np.arange(n)[:, None]
    ang = 2.0 * np.pi * k * m / n
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=64)
def irdft_mats(n: int, modes: int) -> Tuple[np.ndarray, np.ndarray]:
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
    return ((c * np.cos(ang) / n).astype(np.float32),
            (c * np.sin(ang) / n).astype(np.float32))


@functools.lru_cache(maxsize=64)
def cdft_mats(n: int, modes: int,
              inverse: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Complex truncated DFT matrix: forward F[k, m] = e^{-2πi km/N}
    ([n, modes]); inverse E[m, j] = e^{+2πi mj/N}/N ([modes, n]).

    Keeps only the FIRST `modes` bins (TurboFNO's convention), so the
    truncate → pad → inverse round trip is a projection."""
    if not inverse:
        k = np.arange(n)[:, None]
        m = np.arange(modes)[None, :]
        ang = 2.0 * np.pi * k * m / n
        return (np.cos(ang).astype(np.float32),
                (-np.sin(ang)).astype(np.float32))
    m = np.arange(modes)[:, None]
    j = np.arange(n)[None, :]
    ang = 2.0 * np.pi * m * j / n
    return ((np.cos(ang) / n).astype(np.float32),
            (np.sin(ang) / n).astype(np.float32))


# ---------------------------------------------------------------------------
# Rank-generic fused-kernel operand bundles: R forward stages in kernel
# order (axis s_R first, each [n, k]) then R inverse stages (axis s_1 first,
# each [k, n]). The transposed (adjoint) bundle of the backward pass is not
# ported yet.
# ---------------------------------------------------------------------------
def _fused_mat_pairs(spatial, modes):
    """numpy (mr, mi) pairs: R forward-slot then R inverse-slot operands."""
    r = len(spatial)
    fwd, inv = [], []
    for i in range(r):  # forward stages transform axes s_R, s_{R-1}, …, s_1
        ax = r - 1 - i
        n, k = spatial[ax], modes[ax]
        fwd.append(rdft_mats(n, k) if ax == r - 1  # the real-input axis
                   else cdft_mats(n, k, False))
    for ax in range(r):  # inverse stages transform axes s_1, …, s_R
        n, k = spatial[ax], modes[ax]
        inv.append(irdft_mats(n, k) if ax == r - 1
                   else cdft_mats(n, k, True))
    return fwd + inv


@functools.lru_cache(maxsize=256)
def fused_operand_mats(spatial: Tuple[int, ...],
                       modes: Tuple[int, ...]) -> Tuple[np.ndarray, ...]:
    """Flat float32 operand tuple for the fused kernel: (cr, ci) per
    forward stage then (er, ei) per inverse stage."""
    out = []
    for mr, mi in _fused_mat_pairs(tuple(spatial), tuple(modes)):
        out += [mr, mi]
    return tuple(out)


def operand_tensors(spatial, modes, dtype: str,
                    device) -> Tuple[torch.Tensor, ...]:
    """The operand bundle as contiguous torch tensors at `dtype` (the
    policy's spectral dtype) on `device`; cached per (shapes, dtype,
    device) so repeated layer calls reuse the device copies."""
    return _operand_tensors(tuple(int(s) for s in spatial),
                            tuple(int(m) for m in modes), dtype,
                            str(torch.device(device)))


@functools.lru_cache(maxsize=64)
def _operand_tensors(spatial, modes, dtype, device):
    dt = torch_dtype(dtype)
    return tuple(torch.from_numpy(m).to(device=device, dtype=dt).contiguous()
                 for m in fused_operand_mats(spatial, modes))


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
