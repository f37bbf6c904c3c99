"""The fused FNO block kernels: wrappers, plain PyTorch versions, launch
counts.

Counterpart of ``repro/kernels/engine.py``:

* ``fused_block`` — ``fused_fnond_call`` with the block epilogue
  (``csrc/fused_block.cu``), shared weights, in three modes:

      z = Re iDFT_pad(Σ_h DFT_trunc(x_h)·(wr+i·wi)[o,h]) + Σ_h wb[o,h]·x_h
          (+ bias[o])
      act="gelu"      y  = gelu_tanh(z)       the block forward;
      act="gelu_vjp"  gz = gy·gelu_tanh'(z)   the backward's recompute;
      act="linear"    y  = z                  with the adjoint bundle and
                                              transposed weights: dx.

  With wb=None (no bypass, no bias, act="linear") it is the bare spectral
  layer, the rank-1 partial variant's forward.

* ``fused_wgrad`` — ``fused_fnond_wgrad_call(with_bypass=True)``
  (``csrc/fused_wgrad.cu``): dW = conj(Σ Ĝ·A), dW_b = Σ gz·xᵀ, dbias = Σ gz.

* ``fused_core`` — ``fused_fnond_core_call`` (``csrc/fused_core.cu``), the
  partial variant's middle: truncated cDFT along s_1 → CGEMM → padded icDFT
  along s_1 on a spectrum whose outer axes are already transformed
  (``kernels.dft`` holds the row kernels around it).

Each wrapper validates its operands, plans its launch and launches on a CUDA
tensor, and runs its plain version on a CPU tensor; on a CUDA tensor it
launches or raises, it never falls back. The wrappers take no tensor that
requires grad: ``kernels.ops.fno_block_nd`` is the differentiable entry,
and its backward calls them on detached tensors.
On the card, compare against the plain versions with
``torch.backends.cuda.matmul.allow_tf32 = False`` (callers set it).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_F32 = torch.float32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"gelu": 0, "gelu_vjp": 1, "linear": 2}
# Launch kind counted per epilogue mode: with a bypass the linear mode runs
# only as the backward's dx adjoint; without one it is the bare spectral
# layer ("spectral_fwd").
_ACT_KINDS = {"gelu": "block_fwd", "gelu_vjp": "gz_recompute",
              "linear": "dx_adjoint"}
# The kinds of one full-variant training step, and of one partial-variant
# block forward (kernels.dft counts "rdft", "cdft" and "irdft").
KINDS = ("block_fwd", "gz_recompute", "dx_adjoint", "wgrad")
PARTIAL_KINDS = ("rdft", "core", "irdft")

# Kernel launches by (kind, element type), e.g. ("block_fwd", "float32"):
# each wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()

_THREADS = 512     # kThreads in csrc/fno_common.cuh
_TP = 4            # kTP: outputs per thread of a non-accumulating stage
_PTS = 2           # kPts: points per thread of the bypass epilogue
_MAX_OUT = 8       # kMaxOut: out channels per block of a cluster
_WGRAD_COLS = 128  # points per chunk of the wgrad kernel's dW_b reduction
_PORTABLE_CLUSTER = 8  # cluster size every Hopper part schedules
_MAX_CLUSTER = 16  # Hopper's non-portable cluster size
_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block can use
BATCH_BLOCK = 1    # samples per cluster: the serving quantum
_CORE_CHUNK = 4096  # z floats per plane of a core kernel's forward chunk


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# Plain versions: the same functions as staged f32 matmuls, in the engine's
# contraction order (forward s_R first, inverse s_1 first).
# ---------------------------------------------------------------------------
def _cstage(zr, zi, mr, mi, axis):
    """One complex DFT stage along `axis`; the new axis is appended last
    (``jax.lax.dot_general`` order). zi=None marks a real input."""
    dot = lambda a, m: torch.tensordot(a, m, dims=([axis], [0]))
    if zi is None:
        return dot(zr, mr), dot(zr, mi)
    return dot(zr, mr) - dot(zi, mi), dot(zr, mi) + dot(zi, mr)


def _chain(x, m):
    """Forward DFT chain of x [B,C,s_1..s_R] (f32 operands m, axis s_R
    first) -> spectrum pair [B,C,K_R..K_1]."""
    r = x.ndim - 2
    zr, zi = x.to(_F32), None
    for i in range(r):
        zr, zi = _cstage(zr, zi, m[2 * i], m[2 * i + 1], 1 + r - i)
    return zr, zi


def dgelu_tanh(z: torch.Tensor) -> torch.Tensor:
    """d/dz of the tanh-approximate GELU (the reference's ``_dgelu``)."""
    c, a = 0.7978845608028654, 0.044715
    z2 = z * z
    t = torch.tanh(c * z * (1.0 + a * z2))
    return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * c * (1.0 + 3.0 * a * z2)


def fused_block_plain(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                      wb: Optional[torch.Tensor],
                      bias: Optional[torch.Tensor],
                      mats: Sequence[torch.Tensor], *, act: str = "gelu",
                      gy: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """The block kernel's function in plain PyTorch, accumulating in f32
    and emitting at `out_dtype` (x's dtype by default). Arguments as
    ``fused_block``."""
    r = x.ndim - 2
    m = [t.to(_F32) for t in mats]
    zr, zi = _chain(x, m[:2 * r])
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
    if wb is not None:
        z = z + torch.einsum("oh,bh...->bo...", wb.to(_F32), x.to(_F32))
    if bias is not None:
        z = z + bias.to(_F32).reshape((1, -1) + (1,) * r)
    if act == "gelu":
        z = F.gelu(z, approximate="tanh")
    elif act == "gelu_vjp":
        z = gy.to(_F32) * dgelu_tanh(z)
    return z.to(out_dtype or x.dtype)


def fused_wgrad_plain(x: torch.Tensor, gz: torch.Tensor,
                      mats: Sequence[torch.Tensor]
                      ) -> Tuple[torch.Tensor, ...]:
    """The weight-gradient kernel's function in plain PyTorch, in f32.
    Arguments and results as ``fused_wgrad``."""
    r = x.ndim - 2
    m = [t.to(_F32) for t in mats]
    ar, ai = _chain(x, m[:2 * r])
    gr, gi = _chain(gz, m[2 * r:])
    red = [0] + list(range(2, 2 + r))  # batch and every spectral axis
    dot = lambda p, q: torch.tensordot(p, q, dims=(red, red))
    dwr = dot(gr, ar) - dot(gi, ai)
    dwi = -(dot(gr, ai) + dot(gi, ar))  # conj
    g32 = gz.to(_F32)
    dwb = dot(g32, x.to(_F32))
    dbias = g32.sum(dim=red).reshape(-1, 1)
    return dwr, dwi, dwb, dbias


def fused_core_plain(zr: torch.Tensor, zi: torch.Tensor, wr: torch.Tensor,
                     wi: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
                     gr: torch.Tensor, gi: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial-fusion core's function in plain PyTorch, accumulating in
    f32 and emitting at z's dtype. Arguments and results as
    ``fused_core``."""
    f = lambda t: t.to(_F32)
    z_r, z_i = f(zr).movedim(2, -1), f(zi).movedim(2, -1)  # [B,H,…,s_1]
    a_r = z_r @ f(fr) - z_i @ f(fi)                       # [B,H,…,K_1]
    a_i = z_r @ f(fi) + z_i @ f(fr)
    cg = lambda a, w: torch.einsum("oh,bh...k->b...ok", f(w), a)
    c_r = cg(a_r, wr) - cg(a_i, wi)                       # [B,…,O,K_1]
    c_i = cg(a_i, wr) + cg(a_r, wi)
    y_r = c_r @ f(gr) - c_i @ f(gi)                       # [B,…,O,s_1]
    y_i = c_r @ f(gi) + c_i @ f(gr)
    return y_r.to(zr.dtype), y_i.to(zr.dtype)


# ---------------------------------------------------------------------------
# Launch plans and operand checks
# ---------------------------------------------------------------------------
def _cluster_slices(hidden: int, out: int, max_cluster: int):
    """Cluster size (the largest power of two up to `max_cluster`, hidden
    and out) and the hidden / out channels per block."""
    cl = 1
    while cl * 2 <= min(max_cluster, hidden, out):
        cl *= 2
    hs, os_ = -(-hidden // cl), -(-out // cl)
    if os_ > _MAX_OUT:
        raise ValueError(f"fused block kernels hold at most "
                         f"{_MAX_OUT * cl} out channels, got {out}")
    return cl, hs, os_


def _chain_rows(spatial, modes):
    """s_1 rows per forward-chain chunk (enough outputs for every thread's
    registers) and the chain's work area in floats."""
    r = len(spatial)
    n = list(spatial) + [1] * (3 - r)
    k = list(modes) + [1] * (3 - r)
    kp = k[1] * k[2]
    rows_f = min(n[0], max(1, _TP * _THREADS // kp))
    fwd = rows_f * n[1] * n[2] + (2 * rows_f * kp if r >= 2 else 0)
    if r == 3:
        fwd += 2 * rows_f * n[1] * k[2]
    return rows_f, fwd


def _check_smem(smem: int, what: str, hidden, out, spatial, modes) -> None:
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"{what} needs {smem} B of shared memory for hidden={hidden} "
            f"out={out} spatial={tuple(spatial)} modes={tuple(modes)} "
            f"(limit {_SMEM_LIMIT}); this shape needs a tiled kernel")


def launch_plan(hidden: int, out: int, spatial: Sequence[int],
                modes: Sequence[int],
                max_cluster: int = _PORTABLE_CLUSTER) -> Dict[str, int]:
    """The block kernel's cluster size, channel slices, chunk rows and
    shared memory; raises ValueError for shapes the kernel cannot hold."""
    r = len(spatial)
    n = list(spatial) + [1] * (3 - r)
    k = list(modes) + [1] * (3 - r)
    cl, hs, os_ = _cluster_slices(hidden, out, max_cluster)
    p = n[1] * n[2]          # points per s_1 row
    kp = k[1] * k[2]         # modes per k_1
    kk = k[0] * kp
    rows_f, fwd = _chain_rows(spatial, modes)
    rows_i = min(n[0], max(1, _PTS * _THREADS // p))
    inv = os_ * rows_i * p + (2 * os_ * rows_i * kp if r >= 2 else 0)
    if r == 3:
        inv += 2 * os_ * rows_i * n[1] * k[2]
    floats = 2 * hs * kk + 2 * os_ * kk + 3 * os_ * hidden + _MAX_OUT
    smem = 4 * (floats + max(fwd, inv))
    _check_smem(smem, "fused block kernel", hidden, out, spatial, modes)
    return {"cluster": cl, "hs": hs, "os": os_, "rows_f": rows_f,
            "rows_i": rows_i, "smem": smem}


def wgrad_plan(hidden: int, out: int, spatial: Sequence[int],
               modes: Sequence[int],
               max_cluster: int = _PORTABLE_CLUSTER) -> Dict[str, int]:
    """The weight-gradient kernel's cluster size, channel slices, chunk
    sizes and shared memory; raises ValueError for shapes it cannot hold."""
    if hidden > _THREADS:
        raise ValueError(f"fused wgrad kernel takes at most {_THREADS} "
                         f"hidden channels, got {hidden}")
    cl, hs, os_ = _cluster_slices(hidden, out, max_cluster)
    kk = 1
    for m in modes:
        kk *= m
    pts = 1
    for s in spatial:
        pts *= s
    rows_f, fwd = _chain_rows(spatial, modes)
    cols = min(pts, _WGRAD_COLS)
    groups = _THREADS // hidden  # mode / point groups per hidden channel
    work = max(fwd, 2 * groups * os_ * hidden,
               hidden * (cols + 1) + os_ * cols,
               groups * os_ * hidden + groups * os_)
    floats = 2 * (hs + os_) * (kk + 1) + 4 + work
    smem = 4 * floats
    _check_smem(smem, "fused wgrad kernel", hidden, out, spatial, modes)
    return {"cluster": cl, "hs": hs, "os": os_, "rows_f": rows_f,
            "cols": cols, "smem": smem}


def core_plan(hidden: int, out: int, n1: int, k1: int) -> Dict[str, int]:
    """The core kernel's s_1 rows per forward chunk and shared memory (the
    weights, the spectrum A, then z's chunk or C); raises ValueError for
    shapes a block cannot hold."""
    rows = min(n1, max(1, _CORE_CHUNK // hidden))
    floats = 2 * out * hidden + 2 * hidden * k1 + max(2 * hidden * rows,
                                                      2 * out * k1)
    smem = 4 * floats
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"fused core kernel needs {smem} B of shared memory for "
            f"hidden={hidden} out={out} s_1={n1} k_1={k1} (limit "
            f"{_SMEM_LIMIT}); this shape needs a tiled kernel")
    return {"rows": rows, "smem": smem}


def _check_mats(mats, spatial, inverse: bool):
    """4R operands: R forward-slot stages [n,k] (axis s_R first), then R
    inverse-slot stages [k,n] (axis s_1 first) — or, with inverse=False,
    R more [n,k] stages (the wgrad bundle). Returns the modes."""
    r = len(spatial)
    if len(mats) != 4 * r:
        raise ValueError(f"expected {4 * r} DFT operands, got {len(mats)}")
    modes = []
    for i in range(r):  # forward stage i is axis R-i: [n, k]
        n = spatial[r - 1 - i]
        kf = mats[2 * i].shape[1]
        if inverse:
            j = 2 * r + 2 * (r - 1 - i)
            second = ((mats[j], (kf, n)), (mats[j + 1], (kf, n)))
        else:
            j = 2 * r + 2 * i
            second = ((mats[j], (n, kf)), (mats[j + 1], (n, kf)))
        for t, want in ((mats[2 * i], (n, kf)), (mats[2 * i + 1], (n, kf)),
                        *second):
            if tuple(t.shape) != want:
                raise ValueError(f"DFT operand shape {tuple(t.shape)} does "
                                 f"not match axis {r - i} (n={n}, k={kf})")
        modes.insert(0, kf)
    return tuple(modes)


def _check_tensors(what, x, ops):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    for t in ops:
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{what} operands must share x's dtype and "
                            f"device ({x.dtype}, {x.device}), got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} operands must be contiguous")
        if t.requires_grad:
            raise RuntimeError(
                f"{what} takes no tensor that requires grad: it launches one "
                f"kernel and records no graph. Differentiate through "
                f"repro_torch.kernels.ops.fno_block_nd, whose backward "
                f"launches the gz-recompute, dx-adjoint and wgrad kernels")


def _check_rank(x):
    r = x.ndim - 2
    if r not in (1, 2, 3):
        raise ValueError(f"x must be [B,H,s_1..s_R] with R in 1..3, got "
                         f"shape {tuple(x.shape)}")
    return r


def _check(x, wr, wi, wb, bias, mats, act, gy, out_dtype):
    _check_rank(x)
    if act not in _ACT_CODES:
        raise ValueError(f"act must be one of {tuple(_ACT_CODES)}, got "
                         f"{act!r}")
    if (gy is None) != (act != "gelu_vjp"):
        raise ValueError("gy is required by act='gelu_vjp' and taken by "
                         "no other mode")
    if out_dtype is not None and out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if wb is None and (act != "linear" or bias is not None):
        raise ValueError("without wb the block kernel is the bare spectral "
                         "layer: act='linear' and no bias")
    h = x.shape[1]
    o = wr.shape[0]
    extra = tuple(t for t in (wb, bias, gy) if t is not None)
    _check_tensors("fused block", x, (x, wr, wi, *extra, *mats))
    for name, t in (("wr", wr), ("wi", wi), ("wb", wb)):
        if t is not None and tuple(t.shape) != (o, h):
            raise ValueError(f"{name} must be [O,H]=({o},{h}), got "
                             f"{tuple(t.shape)}")
    if bias is not None and tuple(bias.shape) != (o, 1):
        raise ValueError(f"bias must be [O,1]=({o},1), got "
                         f"{tuple(bias.shape)}")
    spatial = tuple(x.shape[2:])
    if gy is not None and tuple(gy.shape) != (x.shape[0], o) + spatial:
        raise ValueError(f"gy must be [B,O,s…]={(x.shape[0], o) + spatial}, "
                         f"got {tuple(gy.shape)}")
    return spatial, _check_mats(mats, spatial, inverse=True)


def _check_wgrad(x, gz, mats):
    _check_rank(x)
    _check_tensors("fused wgrad", x, (x, gz, *mats))
    spatial = tuple(x.shape[2:])
    if gz.ndim != x.ndim or gz.shape[0] != x.shape[0] or \
            tuple(gz.shape[2:]) != spatial:
        raise ValueError(f"gz must be [B,O,s…] with x's batch and extents "
                         f"{spatial}, got {tuple(gz.shape)}")
    return spatial, _check_mats(mats, spatial, inverse=False)


def _check_core(zr, zi, wr, wi, fr, fi, gr, gi):
    if zr.ndim < 3:
        raise ValueError(f"z must be [B,H,s_1,K_R..K_2], got shape "
                         f"{tuple(zr.shape)}")
    if wr.ndim != 2:
        raise ValueError("the fused core kernel takes shared [O,H] weights; "
                         "per-mode weights [O,H,k…] are not ported yet "
                         "(ROADMAP Queue B item 1.5)")
    _check_tensors("fused core", zr, (zr, zi, wr, wi, fr, fi, gr, gi))
    h, n1 = zr.shape[1], zr.shape[2]
    o, k1 = wr.shape[0], fr.shape[1]
    for name, t, want in (("zi", zi, tuple(zr.shape)), ("wr", wr, (o, h)),
                          ("wi", wi, (o, h)), ("fr", fr, (n1, k1)),
                          ("fi", fi, (n1, k1)), ("gr", gr, (k1, n1)),
                          ("gi", gi, (k1, n1))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")


@functools.lru_cache(maxsize=64)
def _max_clusters(lib, prefix: str, dtype_code: int, rank: int,
                  cluster: int, smem: int) -> int:
    """How many clusters of this launch the card runs at once."""
    n = ctypes.c_int(0)
    err = getattr(lib, f"{prefix}_max_clusters")(
        dtype_code, rank, cluster, smem, ctypes.byref(n))
    if err != 0:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"cluster occupancy query failed: {msg}")
    return n.value


def _pick(plan_fn: Callable, lib, prefix: str, dtype_code: int, batch: int,
          hidden: int, out: int, spatial, modes) -> Dict[str, int]:
    """Clusters of 16 blocks halve a sample's time but the card holds fewer
    of them at once: take 16 when the whole batch fits in one wave of
    16-block clusters (asked of the card), else the portable 8."""
    plan = plan_fn(hidden, out, spatial, modes)
    big = plan_fn(hidden, out, spatial, modes, _MAX_CLUSTER)
    if big["cluster"] <= plan["cluster"]:
        return plan
    fits = _max_clusters(lib, prefix, dtype_code, len(spatial),
                         big["cluster"], big["smem"])
    return big if batch <= fits else plan


def pick_plan(lib, dtype_code: int, batch: int, hidden: int, out: int,
              spatial, modes) -> Dict[str, int]:
    """The block kernel's plan for this batch on this card."""
    return _pick(launch_plan, lib, "fused_block", dtype_code, batch, hidden,
                 out, spatial, modes)


def pick_wgrad_plan(lib, dtype_code: int, batch: int, hidden: int,
                    out: int, spatial, modes) -> Dict[str, int]:
    """The weight-gradient kernel's plan for this batch on this card."""
    return _pick(wgrad_plan, lib, "fused_wgrad", dtype_code, batch, hidden,
                 out, spatial, modes)


def _ints(v):
    return (ctypes.c_int * len(v))(*v)


def _dims(b, h, o, spatial, modes):
    r = len(spatial)
    return _ints([b, h, o] + list(spatial) + [1] * (3 - r)
                 + list(modes) + [1] * (3 - r))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(lib, x, wr, wi, wb, bias, mats, spatial, modes, stream, *,
            act="gelu", gy=None, out_dtype=None):
    """Allocate y and launch the block kernel through the C entry (no
    checks)."""
    b, h = x.shape[:2]
    o = wr.shape[0]
    code = _DTYPE_CODES[x.dtype]
    plan = pick_plan(lib, code, b, h, o, spatial, modes)
    od = out_dtype or x.dtype
    y = torch.empty((b, o) + tuple(spatial), dtype=od, device=x.device)
    pl = _ints([plan["cluster"], plan["hs"], plan["os"], plan["rows_f"],
                plan["rows_i"], plan["smem"]])
    ptrs = (ctypes.c_void_p * len(mats))(*[m.data_ptr() for m in mats])
    err = lib.fused_block_forward(
        code, len(spatial), _ACT_CODES[act], int(od == _F32), x.data_ptr(),
        wr.data_ptr(), wi.data_ptr(), _ptr(wb), _ptr(bias), _ptr(gy),
        ptrs, y.data_ptr(), _dims(b, h, o, spatial, modes), pl, stream)
    if err != 0:
        msg = lib.fused_block_error_string(err).decode()
        raise RuntimeError(f"fused block kernel launch failed: {msg} "
                           f"(cudaError {err}, plan {plan})")
    return y


def _launch_wgrad(lib, x, gz, mats, spatial, modes, stream):
    """Allocate the outputs and scratch and launch the weight-gradient
    kernel through the C entry (no checks)."""
    b, h = x.shape[:2]
    o = gz.shape[1]
    code = _DTYPE_CODES[x.dtype]
    plan = pick_wgrad_plan(lib, code, b, h, o, spatial, modes)
    dev = x.device
    ws = torch.empty((b, 3 * o * h + o), dtype=_F32, device=dev)
    tickets = torch.zeros((plan["cluster"],), dtype=torch.int32, device=dev)
    outs = [torch.empty((o, h), dtype=_F32, device=dev) for _ in range(3)]
    outs.append(torch.empty((o, 1), dtype=_F32, device=dev))
    pl = _ints([plan["cluster"], plan["hs"], plan["os"], plan["rows_f"],
                plan["cols"], plan["smem"]])
    ptrs = (ctypes.c_void_p * len(mats))(*[m.data_ptr() for m in mats])
    optrs = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in outs])
    err = lib.fused_wgrad(code, len(spatial), x.data_ptr(), gz.data_ptr(),
                          ptrs, ws.data_ptr(), tickets.data_ptr(), optrs,
                          _dims(b, h, o, spatial, modes), pl, stream)
    if err != 0:
        msg = lib.fused_wgrad_error_string(err).decode()
        raise RuntimeError(f"fused wgrad kernel launch failed: {msg} "
                           f"(cudaError {err}, plan {plan})")
    return tuple(outs)


def _launch_core(lib, zr, zi, wr, wi, fr, fi, gr, gi, stream):
    """Allocate the y pair and launch the core kernel through the C entry
    (no checks)."""
    b, h, n1 = zr.shape[:3]
    spec = tuple(zr.shape[3:])
    o, k1 = wr.shape[0], fr.shape[1]
    plan = core_plan(h, o, n1, k1)
    shape = (b,) + spec + (o, n1)
    yr = torch.empty(shape, dtype=zr.dtype, device=zr.device)
    yi = torch.empty(shape, dtype=zr.dtype, device=zr.device)
    ptrs = (ctypes.c_void_p * 8)(*[t.data_ptr() for t in
                                   (zr, zi, wr, wi, fr, fi, gr, gi)])
    p = 1
    for k in spec:
        p *= k
    err = lib.fused_core(_DTYPE_CODES[zr.dtype], ptrs, yr.data_ptr(),
                         yi.data_ptr(), _ints([b, h, o, n1, k1, p]),
                         plan["rows"], plan["smem"], stream)
    if err != 0:
        msg = lib.fused_core_error_string(err).decode()
        raise RuntimeError(f"fused core kernel launch failed: {msg} "
                           f"(cudaError {err}, plan {plan})")
    return yr, yi


def _on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{what} runs on cuda or cpu, not {x.device}")
    return True


def fused_block(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                wb: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                mats: Sequence[torch.Tensor], *, act: str = "gelu",
                gy: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One FNO block kernel launch in one of its three epilogue modes.

    x: [B,H,s_1..s_R] float32 or bfloat16; wr/wi/wb: [O,H] (wb=None: the
    bare spectral layer, with act="linear" and no bias); bias: [O,1] or
    None; mats: the 4R operands of ``core.spectral.operand_tensors`` (R
    forward-slot stages [n,k], axis s_R first, then R inverse-slot stages
    [k,n], axis s_1 first; the "adjoint" bundle for dx), all at x's dtype
    and contiguous. act: "gelu" (y), "gelu_vjp" (gz from gy [B,O,s…]) or
    "linear" (z). Returns [B,O,s_1..s_R] at `out_dtype` (x's dtype by
    default). A CPU tensor runs ``fused_block_plain``; a CUDA tensor
    launches the kernel or raises.
    """
    spatial, modes = _check(x, wr, wi, wb, bias, mats, act, gy, out_dtype)
    if not _on_card(x, "fused block"):
        return fused_block_plain(x, wr, wi, wb, bias, mats, act=act, gy=gy,
                                 out_dtype=out_dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        y = _launch(build.load_fused_block(), x, wr, wi, wb, bias, mats,
                    spatial, modes, stream, act=act, gy=gy,
                    out_dtype=out_dtype)
    kind = "spectral_fwd" if wb is None else _ACT_KINDS[act]
    LAUNCHES[(kind, _dtype_name(x.dtype))] += 1
    return y


def fused_wgrad(x: torch.Tensor, gz: torch.Tensor,
                mats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The block's weight gradients in one kernel launch.

    x: [B,H,s_1..s_R] float32 or bfloat16 (the block input); gz:
    [B,O,s_1..s_R] (the pre-activation cotangent); mats: the 4R operands of
    ``core.spectral.operand_tensors(kind="wgrad")`` (R forward stages for x,
    then R adjoint-forward stages for gz, each [n,k], axis s_R first), all
    at x's dtype and contiguous. Returns float32 (dwr, dwi, dwb [O,H],
    dbias [O,1]). A CPU tensor runs ``fused_wgrad_plain``; a CUDA tensor
    launches the kernel or raises.
    """
    spatial, modes = _check_wgrad(x, gz, mats)
    if not _on_card(x, "fused wgrad"):
        return fused_wgrad_plain(x, gz, mats)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        outs = _launch_wgrad(build.load_fused_wgrad(), x, gz, mats, spatial,
                             modes, stream)
    LAUNCHES[("wgrad", _dtype_name(x.dtype))] += 1
    return outs


def fused_core(zr: torch.Tensor, zi: torch.Tensor, wr: torch.Tensor,
               wi: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
               gr: torch.Tensor, gi: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial variant's fused middle in one kernel launch: truncated
    cDFT along s_1 → CGEMM over hidden → padded icDFT along s_1.

    z: the pair [B,H,s_1,K_R..K_2] (outer axes already transformed),
    float32 or bfloat16; wr/wi: shared [O,H]; fr/fi: [s_1,K_1] (forward
    cDFT); gr/gi: [K_1,s_1] (padded inverse), all at z's dtype and
    contiguous. Returns the y pair [B,K_R..K_2,O,s_1] at z's dtype (the
    reference's layout; the caller transposes). A CPU tensor runs
    ``fused_core_plain``; a CUDA tensor launches the kernel or raises.
    """
    _check_core(zr, zi, wr, wi, fr, fi, gr, gi)
    if not _on_card(zr, "fused core"):
        return fused_core_plain(zr, zi, wr, wi, fr, fi, gr, gi)
    with torch.cuda.device(zr.device):
        stream = torch.cuda.current_stream(zr.device).cuda_stream
        y = _launch_core(build.load_fused_core(), zr, zi, wr, wi, fr, fi,
                         gr, gi, stream)
    LAUNCHES[("core", _dtype_name(zr.dtype))] += 1
    return y
