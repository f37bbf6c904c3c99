"""The standalone row DFT kernels: wrappers, plain PyTorch versions, launch
counts (counterpart of ``repro/kernels/dft.py``, ``csrc/dft_rows.cu``).

Each transforms the last axis of its input, its leading axes flattened to
rows, as a product with a DFT operand (truncation = an operand with K
columns, zero padding = an operand with K rows):

  rdft   real x [..., N]  -> (x·Cr, x·Ci)                    [..., K]
  cdft   pair [..., N]    -> (xr·Fr − xi·Fi, xr·Fi + xi·Fr)  [..., K]
         (forward-truncated or padded-inverse, as the operand says)
  irdft  pair [..., K]    -> xr·Er − xi·Ei                   [..., N]

and, over the two outer axes (s_2, s_3) of a rank-3 field, with the
per-axis factors:

  outer_rdft   real x [..., n2, n3]  -> pair [..., k3, k2]   (k2 minor)
  outer_irdft  pair [..., k3, k2]    -> real [..., n2, n3]

whose plain versions are the reference's single product with the
Kronecker-combined operand (``spectral.outer_fwd_mats`` /
``outer_inv_mats``). rdft and outer_rdft launch one kernel counted
"rdft", irdft and outer_irdft one counted "irdft", cdft one counted
"cdft": a block walks groups of whole slabs (rows at rank 2, and for
cdft) with the operand resident in shared memory. The launch sizes the
group, up to ``MAX_GROUP_ROWS`` rows; ``check_slab`` refuses a slab (a
cdft row) over the shared-memory budget, on any device.

Every product accumulates in f32 and the result is written at the input's
dtype, as the reference writes ``x2d.dtype``. A CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises, it never falls back.
The wrappers take no tensor that requires grad: the partial variant's
backward is the fully fused adjoint (``kernels.ops.fno_block_nd``).
Launches are counted in ``engine.LAUNCHES`` as ("rdft" | "cdft" |
"irdft", dtype).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from repro_torch.core import spectral
from repro_torch.kernels import build, engine

_F32 = torch.float32
Pair = Tuple[torch.Tensor, torch.Tensor]

# Most rows of one slab group (group × n2), by (kind, outer axes, element
# bytes): the fastest cap of those ``launch/row_groups.py`` sweeps on an
# H100 ("icdft": cdft with the padded-inverse operand). The launch takes
# the most slabs up to the cap that fit a block's shared memory. The
# rdft's f32 product keeps the most rows it can; the irdft (which writes y
# from registers and runs two blocks a multiprocessor) and the rank-2 bf16
# products take fewer; cdft's f32 operand (64 KB at fno2d) leaves room for
# 64 rows.
MAX_GROUP_ROWS = {("rdft", True, 4): 256, ("rdft", True, 2): 256,
                  ("rdft", False, 4): 128, ("rdft", False, 2): 64,
                  ("irdft", True, 4): 128, ("irdft", True, 2): 128,
                  ("irdft", False, 4): 64, ("irdft", False, 2): 64,
                  ("cdft", False, 4): 64, ("cdft", False, 2): 128,
                  ("icdft", False, 4): 64, ("icdft", False, 2): 128}
_SMEM_SLACK = 128  # kSmemSlack: the kernel rounds its base up to 128 bytes


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


def outer_rdft_plain(x: torch.Tensor, f2: Pair, f3: Pair) -> Pair:
    """``outer_rdft`` in plain PyTorch: the reference's one product with
    the Kronecker-combined operand ``outer_fwd_mats`` at the factors'
    extents and dtype."""
    (n2, k2), (n3, k3) = f2[0].shape, f3[0].shape
    mats = spectral.row_operand_tensors(
        "outer_fwd", (n2, n3), (k2, k3), engine._dtype_name(f3[0].dtype),
        x.device)
    lead = tuple(x.shape[:-2])
    zr, zi = rdft_plain(x.reshape(*lead, n2 * n3), *mats)
    return zr.reshape(*lead, k3, k2), zi.reshape(*lead, k3, k2)


def outer_irdft_plain(tr: torch.Tensor, ti: torch.Tensor, e2: Pair,
                      e3: Pair) -> torch.Tensor:
    """``outer_irdft`` in plain PyTorch: the reference's one product with
    the combined padded inverse ``outer_inv_mats``."""
    (k2, n2), (k3, n3) = e2[0].shape, e3[0].shape
    mats = spectral.row_operand_tensors(
        "outer_inv", (n2, n3), (k2, k3), engine._dtype_name(e3[0].dtype),
        tr.device)
    lead = tuple(tr.shape[:-2])
    y = irdft_plain(tr.reshape(*lead, k3 * k2), ti.reshape(*lead, k3 * k2),
                    *mats)
    return y.reshape(*lead, n2, n3)


# ---------------------------------------------------------------------------
# The one-slab refusal: csrc/dft_rows.cu rdft_layout / irdft_layout, in
# Python, so that a CPU tensor is refused where the card would refuse it.
# ---------------------------------------------------------------------------
def _pad(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(kind: str, esize: int, outer: bool, group: int, n2: int,
               n3: int, k2: int, k3: int) -> int:
    """Dynamic shared memory of one rdft / irdft / cdft block with `group`
    slabs of n2 × n3 (k3 × k2 modes; rank 2 and cdft: n2 = k2 = 1) at
    `esize` bytes an element, as the kernel lays it out
    (``dft_rows_smem``)."""
    a = lambda v: _pad(v, 128)
    if kind == "cdft":  # cdft_layout: [xr | xi] twice, [[Fr, Fi], [−Fi, Fr]], C
        mp, hb, hc = _pad(group, 16), _pad(n3, 16 if esize == 2 else 8), \
            _pad(k3, 16)
        x = mp * (2 * hb + 16 // esize) * esize
        b = 2 * hb * (2 * hc + 8) * esize
        return a(a(a(x) + x) + b) + a(4 * mp * (2 * hc + 4)) + _SMEM_SLACK
    if kind == "rdft":
        mma = esize == 2
        mp = _pad(group * n2, 16 if mma else 8)
        kp = _pad(n3, 16 if mma else 4)
        np_ = 2 * _pad(k3, 8 if mma else 4)
        x = mp * (kp + 16 // esize) * esize
        b = kp * (np_ + (8 if mma else 4)) * (2 if mma else 4)
        c = 4 * mp * (np_ + 4)
        f2 = 4 * n2 * (2 * _pad(k2, 4) + 4) if outer else 0
        return a(a(a(a(x) + x) + b) + c) + a(f2) + _SMEM_SLACK
    mma = esize == 2 and not outer
    hc = _pad(k2 if outer else k3, 8)
    in_ld = 2 * hc + 16 // esize
    mp = _pad(group * n2 if outer else group, 16 if mma else 8)
    in_rows = group * k3 if outer else mp
    kp = 2 * (_pad(k3, 4) if outer else hc)
    np_ = _pad(n3, 16 if mma else 4)
    x = in_rows * in_ld * esize
    direct = not mma and n3 % 4 == 0  # the product writes y: no C
    total = a(a(a(x) + x) + kp * (np_ + (8 if mma else 4))
              * (2 if mma else 4)) + (0 if direct else a(4 * mp * (np_ + 4)))
    if outer:
        e2 = 4 * k2 * (2 * _pad(n2, 4) + 4)
        total = a(total + e2) + a(4 * mp * (kp + 4))
    return total + _SMEM_SLACK


@functools.lru_cache(maxsize=None)
def check_slab(kind: str, dtype: torch.dtype, dims: Tuple[int, ...],
               outer: bool) -> None:
    """Raise ValueError when one slab of dims = (n2, n3, k2, k3) (outer=False:
    one row, n2 = k2 = 1) does not fit a block's shared memory at `dtype`:
    the rdft / irdft / cdft launch takes no such shape. Cached: a model's
    launches repeat a few shapes."""
    n2, n3, k2, k3 = dims
    esize = dtype.itemsize
    need = smem_bytes(kind, esize, outer, 1, n2, n3, k2, k3)
    if need > engine._SMEM_LIMIT:
        what = (f"a slab of {n2}x{n3} points, {k3}x{k2} modes" if outer
                else f"rows of {n3} points, {k3} modes")
        raise ValueError(
            f"{kind}: {what} at {dtype} need {need} bytes of shared "
            f"memory, over the {engine._SMEM_LIMIT} a block has")


def max_group(kind: str, dtype: torch.dtype, n2: int, outer: bool) -> int:
    """The cap on an rdft / irdft / cdft / icdft launch's slab group:
    ``MAX_GROUP_ROWS`` rows of slabs of n2 rows."""
    return max(1, MAX_GROUP_ROWS[(kind, outer, dtype.itemsize)] // n2)


# ---------------------------------------------------------------------------
# Checks and launches
# ---------------------------------------------------------------------------
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


def _check_outer(what, ins, f2, f3, tail):
    """Inputs [..., *tail] (their pair shares the shape); factor pairs of
    2-D tensors."""
    x = ins[0]
    if x.ndim < 2:
        raise ValueError(f"{what} takes [..., a, b] slabs, got "
                         f"{tuple(x.shape)}")
    engine._check_tensors(what, x, (*ins, *f2, *f3))
    for t in ins[1:]:
        if t.shape != x.shape:
            raise ValueError(f"{what}: real and imaginary parts differ in "
                             f"shape: {tuple(x.shape)} vs {tuple(t.shape)}")
    for f in (f2, f3):
        if f[0].ndim != 2 or f[1].shape != f[0].shape:
            raise ValueError(f"{what}: a factor pair must be two equal 2-D "
                             f"tensors, got {tuple(f[0].shape)} and "
                             f"{tuple(f[1].shape)}")
    if tuple(x.shape[-2:]) != tail:
        raise ValueError(f"{what}: the slabs must be {tail} for factors "
                         f"{tuple(f2[0].shape)} and {tuple(f3[0].shape)}, "
                         f"got {tuple(x.shape)}")


def _launch_rows(lib, kind, ins, f3, f2, dims, stream, group=None):
    """Allocate the outputs and launch one rdft / irdft / cdft kernel
    through its C entry ``dft_rows_<kind>``: `ins` the input (rdft) or pair
    (irdft, cdft), `f3` the last-axis operand pair, `f2` the outer one or
    None (rank 2, cdft), dims = (n2, n3, k2, k3), slab groups of at most
    `group` slabs (default ``max_group``). No checks; returns the list of
    outputs."""
    n2, n3, k2, k3 = dims
    x = ins[0]
    lead = tuple(x.shape[:-2]) if f2 is not None else tuple(x.shape[:-1])
    slabs = math.prod(lead)
    if group is None:
        group = max_group(kind, x.dtype, n2, f2 is not None)
    if kind != "irdft":
        tail = (k3, k2) if f2 is not None else (k3,)
        outs = [torch.empty(lead + tail, dtype=x.dtype, device=x.device)
                for _ in range(2)]
    else:
        tail = (n2, n3) if f2 is not None else (n3,)
        outs = [torch.empty(lead + tail, dtype=x.dtype, device=x.device)]
    ptr = lambda t: t.data_ptr()
    m2 = (ptr(f2[0]), ptr(f2[1])) if f2 is not None else (None, None)
    if kind == "rdft":
        err = lib.dft_rows_rdft(
            engine._DTYPE_CODES[x.dtype], ptr(x), ptr(f3[0]), ptr(f3[1]),
            *m2, ptr(outs[0]), ptr(outs[1]), slabs, n2, n3, k2, k3, group,
            stream)
    elif kind == "cdft":
        err = lib.dft_rows_cdft(
            engine._DTYPE_CODES[x.dtype], ptr(ins[0]), ptr(ins[1]),
            ptr(f3[0]), ptr(f3[1]), ptr(outs[0]), ptr(outs[1]), slabs, n3,
            k3, group, stream)
    else:
        err = lib.dft_rows_irdft(
            engine._DTYPE_CODES[x.dtype], ptr(ins[0]), ptr(ins[1]),
            ptr(f3[0]), ptr(f3[1]), *m2, ptr(outs[0]), slabs, n2, n3, k2,
            k3, group, stream)
    if err != 0:
        msg = lib.dft_rows_error_string(err).decode()
        raise RuntimeError(
            f"{kind} kernel launch failed: {msg} (cudaError {err}, "
            f"slabs={slabs} n2={n2} n3={n3} k2={k2} k3={k3} "
            f"max group={group})")
    return outs


def _on_card(kind, x, run):
    """Launch `run(lib, stream)` on x's card and count it as `kind`."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        outs = run(build.load_dft_rows(), stream)
    engine.LAUNCHES[(kind, engine._dtype_name(x.dtype))] += 1
    return outs


def rdft(x: torch.Tensor, cr: torch.Tensor,
         ci: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncated real DFT of the last axis in one launch: x [..., N]
    float32 or bfloat16, (cr, ci) [N, K] at x's dtype (e.g.
    ``spectral.row_operand_tensors("rdft", …)``), all contiguous. Returns
    the pair [..., K] at x's dtype."""
    _check("rdft", (x,), (cr, ci))
    dims = (1, x.shape[-1], 1, cr.shape[1])
    check_slab("rdft", x.dtype, dims, False)
    if not engine._on_card(x, "rdft"):
        return rdft_plain(x, cr, ci)
    return tuple(_on_card("rdft", x, lambda lib, s: _launch_rows(
        lib, "rdft", (x,), (cr, ci), None, dims, s)))


def cdft(xr: torch.Tensor, xi: torch.Tensor, fr: torch.Tensor,
         fi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex DFT of the last axis in one launch: the pair [..., N], the
    operand pair [N, K] — forward-truncated ("cdft") or padded inverse
    ("icdft", then N is the kept modes and K the length). Returns the pair
    [..., K] at xr's dtype."""
    _check("cdft", (xr, xi), (fr, fi))
    dims = (1, xr.shape[-1], 1, fr.shape[1])
    check_slab("cdft", xr.dtype, dims, False)
    if not engine._on_card(xr, "cdft"):
        return cdft_plain(xr, xi, fr, fi)
    group = max_group("icdft" if dims[3] > dims[1] else "cdft", xr.dtype,
                      1, False)
    return tuple(_on_card("cdft", xr, lambda lib, s: _launch_rows(
        lib, "cdft", (xr, xi), (fr, fi), None, dims, s, group)))


def irdft(xr: torch.Tensor, xi: torch.Tensor, er: torch.Tensor,
          ei: torch.Tensor) -> torch.Tensor:
    """Padded inverse real DFT of the last axis in one launch: the pair
    [..., K], the hermitian-folded operand pair [K, N]. Returns the real
    [..., N] = xr·er − xi·ei at xr's dtype."""
    _check("irdft", (xr, xi), (er, ei))
    dims = (1, er.shape[1], 1, xr.shape[-1])
    check_slab("irdft", xr.dtype, dims, False)
    if not engine._on_card(xr, "irdft"):
        return irdft_plain(xr, xi, er, ei)
    return _on_card("irdft", xr, lambda lib, s: _launch_rows(
        lib, "irdft", (xr, xi), (er, ei), None, dims, s))[0]


def outer_rdft(x: torch.Tensor, f2: Pair, f3: Pair) -> Pair:
    """Truncated real DFT of the two outer axes in one launch: x [..., n2,
    n3] float32 or bfloat16; f2 = (fr, fi) [n2, k2] the complex factor of
    s_2 and f3 [n3, k3] the truncated factor of s_3 (``cdft_mats`` each,
    e.g. ``spectral.row_operand_tensors("cdft", …)``), at x's dtype, all
    contiguous. Returns the pair [..., k3, k2] at x's dtype, k2 minor.
    Counted as an "rdft" launch."""
    (n2, k2), (n3, k3) = f2[0].shape, f3[0].shape
    _check_outer("outer_rdft", (x,), f2, f3, (n2, n3))
    dims = (n2, n3, k2, k3)
    check_slab("rdft", x.dtype, dims, True)
    if not engine._on_card(x, "outer_rdft"):
        return outer_rdft_plain(x, f2, f3)
    return tuple(_on_card("rdft", x, lambda lib, s: _launch_rows(
        lib, "rdft", (x,), f3, f2, dims, s)))


def outer_irdft(tr: torch.Tensor, ti: torch.Tensor, e2: Pair,
                e3: Pair) -> torch.Tensor:
    """Padded inverse DFT of the two outer axes in one launch: the pair
    [..., k3, k2] (k2 minor); e2 = (er, ei) [k2, n2] the complex inverse of
    s_2 (``cdft_mats(…, inverse=True)``) and e3 [k3, n3] the
    hermitian-folded real inverse of s_3 (``irdft_mats``), at the pair's
    dtype, all contiguous. Returns the real [..., n2, n3]. Counted as an
    "irdft" launch."""
    (k2, n2), (k3, n3) = e2[0].shape, e3[0].shape
    _check_outer("outer_irdft", (tr, ti), e2, e3, (k3, k2))
    dims = (n2, n3, k2, k3)
    check_slab("irdft", tr.dtype, dims, True)
    if not engine._on_card(tr, "outer_irdft"):
        return outer_irdft_plain(tr, ti, e2, e3)
    return _on_card("irdft", tr, lambda lib, s: _launch_rows(
        lib, "irdft", (tr, ti), e3, e2, dims, s))[0]
