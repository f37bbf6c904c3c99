"""The fused FNO block kernel: wrapper, plain PyTorch version, launch count.

Counterpart of ``repro/kernels/engine.py::fused_fnond_call`` in its
block-forward mode (``act="gelu"``, shared weights, bypass + bias
epilogue). The kernel itself is ``csrc/fused_block.cu``; this module
validates operands, plans its launch, and launches it.

    y = gelu_tanh(Re iDFT_pad(Σ_h DFT_trunc(x_h)·(wr+i·wi)[o,h])
                  + Σ_h wb[o,h]·x_h + bias[o])

``fused_block`` runs the kernel on a CUDA tensor and the plain version on a
CPU tensor; on a CUDA tensor it launches or raises, it never falls back.
The path is forward-only: inputs that require grad raise.
On the card, compare against the plain version with
``torch.backends.cuda.matmul.allow_tf32 = False`` (callers set it).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_F32 = torch.float32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches by element type ("float32" / "bfloat16"): the wrapper adds
# one where it launches the kernel and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()

_THREADS = 512     # kThreads in csrc/fused_block.cu
_TP = 4            # kTP: outputs per thread of a non-accumulating stage
_PTS = 2           # kPts: points per thread of the bypass epilogue
_MAX_OUT = 8       # kMaxOut: out channels per block of a cluster
_PORTABLE_CLUSTER = 8  # cluster size every Hopper part schedules
_MAX_CLUSTER = 16  # Hopper's non-portable cluster size
_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block can use
BATCH_BLOCK = 1    # samples per cluster: the serving quantum


# ---------------------------------------------------------------------------
# Plain version: the same function as staged f32 matmuls, in the engine's
# contraction order (forward s_R first, inverse s_1 first).
# ---------------------------------------------------------------------------
def _cstage(zr, zi, mr, mi, axis):
    """One complex DFT stage along `axis`; the new axis is appended last
    (``jax.lax.dot_general`` order). zi=None marks a real input."""
    dot = lambda a, m: torch.tensordot(a, m, dims=([axis], [0]))
    if zi is None:
        return dot(zr, mr), dot(zr, mi)
    return dot(zr, mr) - dot(zi, mi), dot(zr, mi) + dot(zi, mr)


def fused_block_plain(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                      wb: torch.Tensor, bias: torch.Tensor,
                      mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's function in plain PyTorch, accumulating in f32 and
    emitting y at x's dtype. Arguments as ``fused_block``."""
    r = x.ndim - 2
    m = [t.to(_F32) for t in mats]
    zr, zi = x.to(_F32), None
    for i in range(r):  # [B,H,s_1..s_R] -> [B,H,K_R..K_1]
        zr, zi = _cstage(zr, zi, m[2 * i], m[2 * i + 1], 1 + r - i)
    w_r, w_i = wr.to(_F32), wi.to(_F32)
    cg = lambda a, w: torch.tensordot(a, w, dims=([1], [1]))
    tr, ti = cg(zr, w_r) - cg(zi, w_i), cg(zr, w_i) + cg(zi, w_r)
    inv = m[2 * r:]
    for i in range(r):  # [B,K_R..K_1,O] -> [B,O,s_1..s_R]
        mr, mi = inv[2 * i], inv[2 * i + 1]
        if i < r - 1:
            tr, ti = _cstage(tr, ti, mr, mi, r - i)
        else:
            z = (torch.tensordot(tr, mr, dims=([r - i], [0]))
                 - torch.tensordot(ti, mi, dims=([r - i], [0])))
    byp = torch.einsum("oh,bh...->bo...", wb.to(_F32), x.to(_F32))
    z = z + byp + bias.to(_F32).reshape((1, -1) + (1,) * r)
    return F.gelu(z, approximate="tanh").to(x.dtype)


# ---------------------------------------------------------------------------
# Launch plan and operand checks
# ---------------------------------------------------------------------------
def launch_plan(hidden: int, out: int, spatial: Sequence[int],
                modes: Sequence[int],
                max_cluster: int = _PORTABLE_CLUSTER) -> Dict[str, int]:
    """Cluster size (the largest power of two up to `max_cluster`, hidden
    and out), channel slices, chunk rows and shared memory of one launch;
    raises ValueError for shapes the kernel cannot hold."""
    r = len(spatial)
    n = list(spatial) + [1] * (3 - r)
    k = list(modes) + [1] * (3 - r)
    cl = 1
    while cl * 2 <= min(max_cluster, hidden, out):
        cl *= 2
    hs, os_ = -(-hidden // cl), -(-out // cl)
    if os_ > _MAX_OUT:
        raise ValueError(f"fused block kernel holds at most "
                         f"{_MAX_OUT * cl} out channels, got {out}")
    p = n[1] * n[2]          # points per s_1 row
    kp = k[1] * k[2]         # modes per k_1
    kk = k[0] * kp
    # s_1 rows per chunk: enough outputs for every thread's registers.
    rows_f = min(n[0], max(1, _TP * _THREADS // kp))
    rows_i = min(n[0], max(1, _PTS * _THREADS // p))
    fwd = rows_f * p + (2 * rows_f * kp if r >= 2 else 0)
    inv = os_ * rows_i * p + (2 * os_ * rows_i * kp if r >= 2 else 0)
    if r == 3:
        fwd += 2 * rows_f * n[1] * k[2]
        inv += 2 * os_ * rows_i * n[1] * k[2]
    floats = 2 * hs * kk + 2 * os_ * kk + 3 * os_ * hidden + _MAX_OUT
    smem = 4 * (floats + max(fwd, inv))
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"fused block kernel needs {smem} B of shared memory for hidden="
            f"{hidden} out={out} spatial={tuple(spatial)} modes="
            f"{tuple(modes)} (limit {_SMEM_LIMIT}); this shape needs a "
            f"tiled kernel")
    return {"cluster": cl, "hs": hs, "os": os_, "rows_f": rows_f,
            "rows_i": rows_i, "smem": smem}


def _check(x, wr, wi, wb, bias, mats):
    r = x.ndim - 2
    if r not in (1, 2, 3):
        raise ValueError(f"x must be [B,H,s_1..s_R] with R in 1..3, got "
                         f"shape {tuple(x.shape)}")
    h = x.shape[1]
    o = wr.shape[0]
    ops = (x, wr, wi, wb, bias, *mats)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused block takes float32 or bfloat16, got "
                        f"{x.dtype}")
    for t in ops:
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError("fused block operands must share x's dtype and "
                            f"device ({x.dtype}, {x.device}), got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("fused block operands must be contiguous")
        if t.requires_grad:
            raise RuntimeError(
                "the fused block kernel is forward-only: its "
                "backward kernels are not ported yet")
    for name, t in (("wr", wr), ("wi", wi), ("wb", wb)):
        if tuple(t.shape) != (o, h):
            raise ValueError(f"{name} must be [O,H]=({o},{h}), got "
                             f"{tuple(t.shape)}")
    if tuple(bias.shape) != (o, 1):
        raise ValueError(f"bias must be [O,1]=({o},1), got "
                         f"{tuple(bias.shape)}")
    if len(mats) != 4 * r:
        raise ValueError(f"expected {4 * r} DFT operands, got {len(mats)}")
    spatial = tuple(x.shape[2:])
    modes = []
    for i in range(r):  # forward stage i is axis R-i: [n, k]
        n = spatial[r - 1 - i]
        kf = mats[2 * i].shape[1]
        ki = mats[2 * r + 2 * (r - 1 - i)].shape[0]
        for t, want in ((mats[2 * i], (n, kf)), (mats[2 * i + 1], (n, kf)),
                        (mats[2 * r + 2 * (r - 1 - i)], (kf, n)),
                        (mats[2 * r + 2 * (r - 1 - i) + 1], (kf, n))):
            if tuple(t.shape) != want or ki != kf:
                raise ValueError(f"DFT operand shape {tuple(t.shape)} does "
                                 f"not match axis {r - i} (n={n}, k={kf})")
        modes.insert(0, kf)
    return spatial, tuple(modes)


@functools.lru_cache(maxsize=64)
def _max_clusters(lib, dtype_code: int, rank: int, cluster: int,
                  smem: int) -> int:
    """How many clusters of this launch the card runs at once."""
    n = ctypes.c_int(0)
    err = lib.fused_block_max_clusters(dtype_code, rank, cluster, smem,
                                       ctypes.byref(n))
    if err != 0:
        msg = lib.fused_block_error_string(err).decode()
        raise RuntimeError(f"cluster occupancy query failed: {msg}")
    return n.value


def pick_plan(lib, dtype_code: int, batch: int, hidden: int, out: int,
              spatial, modes) -> Dict[str, int]:
    """Clusters of 16 blocks halve a sample's time but the card holds fewer
    of them at once: take 16 when the whole batch fits in one wave of
    16-block clusters (asked of the card), else the portable 8."""
    plan = launch_plan(hidden, out, spatial, modes)
    big = launch_plan(hidden, out, spatial, modes, _MAX_CLUSTER)
    if big["cluster"] <= plan["cluster"]:
        return plan
    fits = _max_clusters(lib, dtype_code, len(spatial), big["cluster"],
                         big["smem"])
    return big if batch <= fits else plan


def _launch(lib, x, wr, wi, wb, bias, mats, spatial, modes, stream):
    """Allocate y and launch the kernel through the C entry (no checks)."""
    b, h = x.shape[:2]
    o = wr.shape[0]
    r = len(spatial)
    plan = pick_plan(lib, _DTYPE_CODES[x.dtype], b, h, o, spatial, modes)
    y = torch.empty((b, o) + tuple(spatial), dtype=x.dtype, device=x.device)
    ints = lambda v: (ctypes.c_int * len(v))(*v)
    dims = ints([b, h, o] + list(spatial) + [1] * (3 - r)
                + list(modes) + [1] * (3 - r))
    pl = ints([plan["cluster"], plan["hs"], plan["os"], plan["rows_f"],
               plan["rows_i"], plan["smem"]])
    ptrs = (ctypes.c_void_p * len(mats))(*[m.data_ptr() for m in mats])
    err = lib.fused_block_forward(
        _DTYPE_CODES[x.dtype], r, x.data_ptr(), wr.data_ptr(), wi.data_ptr(),
        wb.data_ptr(), bias.data_ptr(), ptrs, y.data_ptr(), dims, pl, stream)
    if err != 0:
        msg = lib.fused_block_error_string(err).decode()
        raise RuntimeError(f"fused block kernel launch failed: {msg} "
                           f"(cudaError {err}, plan {plan})")
    return y


def fused_block(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                wb: torch.Tensor, bias: torch.Tensor,
                mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """One FNO block forward in one kernel launch.

    x: [B,H,s_1..s_R] float32 or bfloat16; wr/wi/wb: [O,H]; bias: [O,1];
    mats: the 4R operands of ``core.spectral.operand_tensors`` (R forward
    stages [n,k], axis s_R first, then R inverse stages [k,n], axis s_1
    first), all at x's dtype and contiguous. Returns y [B,O,s_1..s_R] at
    x's dtype. A CPU tensor runs ``fused_block_plain``; a CUDA tensor
    launches the kernel or raises.
    """
    spatial, modes = _check(x, wr, wi, wb, bias, mats)
    if x.device.type == "cpu":
        return fused_block_plain(x, wr, wi, wb, bias, mats)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused block runs on cuda or cpu, not "
                           f"{x.device}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        y = _launch(build.load_fused_block(), x, wr, wi, wb, bias, mats,
                    spatial, modes, stream)
    LAUNCHES[str(x.dtype).removeprefix("torch.")] += 1
    return y
