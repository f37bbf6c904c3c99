"""The complex matrix product kernel: wrapper, plain PyTorch version, launch
count (counterpart of ``repro/kernels/cgemm.py``, ``csrc/cgemm.cu``).

    C = A·B,  A [M,K], B [K,N] complex as (re, im) planes:
    Cr = ar·br − ai·bi,  Ci = ar·bi + ai·br

Four real products accumulating in f32 (on the card's tensor cores: bf16
as it is, f32 as three TF32 passes), the result written at the input's
dtype, as the reference writes ``ar.dtype``. The kernel masks ragged M, K
and N, so nothing pads (the reference pads to 128 for the TPU); it keeps
A resident in shared memory where A fits and walks K in chunks where it
does not (``plan``). A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises, it never falls back. Launches are counted
in ``engine.LAUNCHES`` as ("cgemm", dtype).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, engine

_F32 = torch.float32


def cgemm_plain(ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor,
                bi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cgemm`` in plain PyTorch: f32 products, emitted at ar's dtype."""
    a, b, c, d = (t.to(_F32) for t in (ar, ai, br, bi))
    return (a @ c - b @ d).to(ar.dtype), (a @ d + b @ c).to(ar.dtype)


def _check(ar, ai, br, bi):
    """Returns (M, K, N)."""
    if ar.ndim != 2 or br.ndim != 2:
        raise ValueError(f"cgemm takes A [M,K] and B [K,N], got "
                         f"{tuple(ar.shape)} and {tuple(br.shape)}")
    engine._check_tensors("cgemm", ar, (ar, ai, br, bi))
    m, k = ar.shape
    n = br.shape[1]
    for name, t, want in (("ai", ai, (m, k)), ("br", br, (k, n)),
                          ("bi", bi, (k, n))):
        if tuple(t.shape) != want:
            raise ValueError(f"cgemm: {name} must be {want}, got "
                             f"{tuple(t.shape)}")
    return m, k, n


def _launch(lib, ar, ai, br, bi, stream):
    """Allocate C and launch the kernel through its C entry (no checks)."""
    m, k = ar.shape
    n = br.shape[1]
    cr = torch.empty((m, n), dtype=ar.dtype, device=ar.device)
    ci = torch.empty((m, n), dtype=ar.dtype, device=ar.device)
    ptrs = (ctypes.c_void_p * 6)(*[t.data_ptr() for t in
                                   (ar, ai, br, bi, cr, ci)])
    err = lib.cgemm(engine._DTYPE_CODES[ar.dtype], ptrs, m, n, k, stream)
    if err != 0:
        msg = lib.cgemm_error_string(err).decode()
        raise RuntimeError(f"cgemm kernel launch failed: {msg} (cudaError "
                           f"{err}, M={m} K={k} N={n})")
    return cr, ci


def plan(lib, dtype: torch.dtype, m: int, k: int) -> dict:
    """The kernel's plan for an (M, K) A at `dtype` (``cgemm_plan``):
    slices of M, rows a slice, the K chunk, the chunks (1: A resident in
    shared memory) and a block's shared memory in bytes."""
    out = (ctypes.c_longlong * 5)()
    lib.cgemm_plan(engine._DTYPE_CODES[dtype], m, k, out)
    return dict(zip(("slices", "rows", "k_chunk", "chunks", "smem"), out))


def cgemm(ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor,
          bi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M,K)·(K,N) complex product in one launch: the planes ar, ai
    [M,K] and br, bi [K,N], float32 or bfloat16, one dtype, contiguous.
    Returns (cr, ci) [M,N] at ar's dtype. A CPU tensor runs
    ``cgemm_plain``; a CUDA tensor launches the kernel or raises."""
    _check(ar, ai, br, bi)
    if not engine._on_card(ar, "cgemm"):
        return cgemm_plain(ar, ai, br, bi)
    with torch.cuda.device(ar.device):
        stream = torch.cuda.current_stream(ar.device).cuda_stream
        out = _launch(build.load_cgemm(), ar, ai, br, bi, stream)
    engine.LAUNCHES[("cgemm", engine._dtype_name(ar.dtype))] += 1
    return out
