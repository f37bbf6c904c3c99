"""The fused FNO block kernels: wrappers, plain PyTorch versions, launch
counts.

Counterpart of ``repro/kernels/engine.py``:

* ``fused_block`` — ``fused_fnond_call`` with the block epilogue
  (``csrc/fused_block.cu``), shared [O,H] or per-mode [O,H,k_1..k_R]
  weights, in three modes:

      z = Re iDFT_pad(Σ_h DFT_trunc(x_h)·(wr+i·wi)[o,h(,k)]) + Σ_h wb[o,h]·x_h
          (+ bias[o])
      act="gelu"      y  = gelu_tanh(z)       the block forward;
      act="gelu_vjp"  gz = gy·gelu_tanh'(z)   the backward's recompute;
      act="linear"    y  = z                  the linear (TP-partial)
                                              block, or, with the adjoint
                                              bundle and transposed
                                              weights, the backward's dx.

  With wb=None (no bypass, no bias, act="linear") it is the bare spectral
  layer: its forward (the spectral-only path's, and the rank-1 partial
  variant's), and, with the adjoint bundle, transposed weights and
  adjoint=True, its backward's dx. With ``lift=`` / ``proj=`` (act="gelu")
  it is a model's first and last block with the end MLPs folded in
  ("block_ends"): x is then the raw input, and y the model's output.

* ``fused_wgrad`` — ``fused_fnond_wgrad_call`` (``csrc/fused_wgrad.cu``):
  dW = conj(Σ Ĝ·A) (summed over the modes for shared weights, one per mode
  for per-mode ones) and, with_bypass=True (the block's backward),
  dW_b = Σ gz·xᵀ and dbias = Σ gz; with_bypass=False is the bare spectral
  layer's backward.

* ``fused_core`` — ``fused_fnond_core_call`` (``csrc/fused_core.cu``), the
  partial variant's middle: truncated cDFT along s_1 → CGEMM → padded icDFT
  along s_1 on a spectrum whose outer axes are already transformed
  (``kernels.dft`` holds the row kernels around it), shared or per-mode
  weights.

Each wrapper validates its operands, plans its launch and launches on a CUDA
tensor, and runs its plain version on a CPU tensor; on a CUDA tensor it
launches or raises, it never falls back. The wrappers take no tensor that
requires grad: ``kernels.ops.fno_block_nd`` and ``spectral_layer_nd`` are
the differentiable entries, and their backwards call them on detached
tensors.
On the card, compare against the plain versions with
``torch.backends.cuda.matmul.allow_tf32 = False`` (callers set it).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.roofline.hw import SMEM_PER_BLOCK as _SMEM_LIMIT

_F32 = torch.float32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"gelu": 0, "gelu_vjp": 1, "linear": 2}
# The kinds of one full-variant block's training step, of one
# partial-variant forward (kernels.dft counts "rdft", "cdft" and "irdft"),
# of one spectral-only layer's training step (fuse_block off: the bare
# layer forward, its dx and its bypass-free wgrad), and of one linear
# (TP-partial) block's training step: its forward, then dx and wgrad with
# no gz recompute.
KINDS = ("block_fwd", "gz_recompute", "dx_adjoint", "wgrad")
PARTIAL_KINDS = ("rdft", "core", "irdft")
SPECTRAL_KINDS = ("spectral_fwd", "spectral_dx", "spectral_wgrad")
LINEAR_KINDS = ("block_linear", "dx_adjoint", "wgrad")


def launch_kind(wb, act: str, adjoint: bool, ends: bool = False) -> str:
    """The kind a block-kernel launch is counted as, from what the caller
    asked, never guessed from the operands: ends=True is a block with the
    model's end MLPs folded in ("block_ends"); adjoint=True is a backward's
    dx ("dx_adjoint" with the bypass, "spectral_dx" without); otherwise
    "block_fwd", "gz_recompute", and for act="linear" the linear block's
    forward ("block_linear") or, without wb, the bare layer's
    ("spectral_fwd")."""
    if ends:
        return "block_ends"
    if adjoint:
        return "dx_adjoint" if wb is not None else "spectral_dx"
    if act == "linear":
        return "block_linear" if wb is not None else "spectral_fwd"
    return {"gelu": "block_fwd", "gelu_vjp": "gz_recompute"}[act]


# Kernel launches by (kind, element type), e.g. ("block_fwd", "float32"):
# each wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()

_THREADS = 512     # kThreads in csrc/fno_common.cuh
_TP = 4            # kTP: outputs per thread of a non-accumulating stage
_MAX_OUT = 8       # kMaxOut: out channels per block of a cluster
_OUT_GROUP = 32    # kOG: out channels a thread forms at once in the block
                   # kernel's split epilogue
_WGRAD_COLS = 256  # the most points per chunk of the wgrad kernel's dW_b
_WGRAD_FLAG = 128  # kFlag: bytes before the wgrad kernel's spectra
# The most s_1 rows per chunk of the tensor-core forward chain by rank
# (rank 1: points, a multiple of 16), and the 16 × 8 tiles the warps hold
# in registers: kMaxAcc a warp of the chain's accumulating stage, kMaxPT of
# the wgrad's dW_b product (csrc/chain_tc.cuh, csrc/fused_wgrad.cu).
_TC_ROWS = {1: 64, 2: 64, 3: 8}
# Phase 1's chain in a plan ("chain"): on the tensor cores
# (chain::forward_chain) or on the CUDA cores (fno::forward_chain), and the
# code the C entries take.
CHAINS = ("tc", "fma")
_WARPS = _THREADS // 32
_MAX_ACC = 4
_MAX_PT = 9
_PORTABLE_CLUSTER = 8  # cluster size every Hopper part schedules
_MAX_CLUSTER = 16  # Hopper's non-portable cluster size
BATCH_BLOCK = 1    # samples per cluster: the serving quantum


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


def _col(v: torch.Tensor, r: int) -> torch.Tensor:
    """A [D,1] bias broadcast over batch and r spatial axes, in f32."""
    return v.to(_F32).reshape((1, -1) + (1,) * r)


def _lift_plain(x, lift):
    """h = l2·gelu_tanh(l1·x + b1) + b2 in f32 from the raw input, rounded
    to x's dtype as it feeds the chain and the bypass."""
    r = x.ndim - 2
    l1w, l1b, l2w, l2b = lift
    a = F.gelu(torch.einsum("lc,bc...->bl...", l1w.to(_F32), x.to(_F32))
               + _col(l1b, r), approximate="tanh")
    h = torch.einsum("hl,bl...->bh...", l2w.to(_F32), a) + _col(l2b, r)
    return h.to(x.dtype)


def _proj_plain(z, proj):
    """y = p2·gelu_tanh(p1·z + b1) + b2 on the activated block output z
    (f32)."""
    r = z.ndim - 2
    p1w, p1b, p2w, p2b = proj
    a = F.gelu(torch.einsum("lo,bo...->bl...", p1w.to(_F32), z)
               + _col(p1b, r), approximate="tanh")
    return torch.einsum("cl,bl...->bc...", p2w.to(_F32), a) + _col(p2b, r)


def fused_block_plain(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                      wb: Optional[torch.Tensor],
                      bias: Optional[torch.Tensor],
                      mats: Sequence[torch.Tensor], *, act: str = "gelu",
                      gy: Optional[torch.Tensor] = None,
                      out_dtype: Optional[torch.dtype] = None,
                      lift: Optional[Sequence[torch.Tensor]] = None,
                      proj: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
    """The block kernel's function in plain PyTorch, accumulating in f32
    and emitting at `out_dtype` (x's dtype by default). Arguments as
    ``fused_block``; with the ends, the lifted x is rounded to x's dtype
    and the projection takes the activated output in f32, as the
    reference's kernel does."""
    if lift is not None:
        x = _lift_plain(x, lift)
    r = x.ndim - 2
    m = [t.to(_F32) for t in mats]
    zr, zi = _chain(x, m[:2 * r])
    w_r, w_i = wr.to(_F32), wi.to(_F32)
    if wr.ndim == 2:
        cg = lambda a, w: torch.tensordot(a, w, dims=([1], [1]))
    else:  # per-mode: the spectrum is K_R..K_1, the weight K_1..K_R
        fwd = "uvw"[:r]
        eq = f"bh{fwd[::-1]},oh{fwd}->b{fwd[::-1]}o"
        cg = lambda a, w: torch.einsum(eq, a, w)
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
    if proj is not None:
        z = _proj_plain(z, proj)
    return z.to(out_dtype or x.dtype)


def fused_wgrad_plain(x: torch.Tensor, gz: torch.Tensor,
                      mats: Sequence[torch.Tensor], *,
                      per_mode: bool = False,
                      with_bypass: bool = True) -> Tuple[torch.Tensor, ...]:
    """The weight-gradient kernel's function in plain PyTorch, in f32.
    Arguments and results as ``fused_wgrad``."""
    r = x.ndim - 2
    m = [t.to(_F32) for t in mats]
    ar, ai = _chain(x, m[:2 * r])
    gr, gi = _chain(gz, m[2 * r:])
    red = [0] + list(range(2, 2 + r))  # batch and every spectral axis
    dot = lambda p, q: torch.tensordot(p, q, dims=(red, red))
    sdot = dot
    if per_mode:  # batch only; dW in the parameter layout [O,H,K_1..K_R]
        fwd = "uvw"[:r]
        eq = f"bo{fwd[::-1]},bh{fwd[::-1]}->oh{fwd}"
        sdot = lambda p, q: torch.einsum(eq, p, q)
    dwr = sdot(gr, ar) - sdot(gi, ai)
    dwi = -(sdot(gr, ai) + sdot(gi, ar))  # conj
    if not with_bypass:
        return dwr, dwi
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
    if wr.ndim == 2:
        eq = "oh,bh...k->b...ok"
    else:  # per-mode [O,H,K_1,K_2..K_R] against A [B,H,K_R..K_2,K_1]
        spec = "pqr"[:zr.ndim - 3]
        eq = f"ohk{spec},bh{spec[::-1]}k->b{spec[::-1]}ok"
    cg = lambda a, w: torch.einsum(eq, f(w), a)
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
    """The most s_1 rows per chunk of the CUDA cores' forward chain: enough
    outputs for every thread's registers in the chain's stages."""
    k = list(modes) + [1] * (3 - len(modes))
    return min(spatial[0], max(1, _TP * _THREADS // (k[1] * k[2])))


def _chain_work(spatial, modes, rows_f):
    """The CUDA cores' forward chain's work area in floats at `rows_f` s_1
    rows per chunk (``fno::chain_work``)."""
    r = len(spatial)
    n = list(spatial) + [1] * (3 - r)
    k = list(modes) + [1] * (3 - r)
    kp = k[1] * k[2]
    fwd = rows_f * n[1] * n[2] + (2 * rows_f * kp if r >= 2 else 0)
    if r == 3:
        fwd += 2 * rows_f * n[1] * k[2]
    return fwd


def _most(cap: int, fits: Callable[[int], bool], step: int = 1):
    """The largest multiple of `step` up to `cap` for which `fits` holds,
    fits being true up to some value and false past it; `step` when none
    does (the caller's check then raises)."""
    lo, hi = 1, cap // step
    if hi < 1 or not fits(step):
        return step
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid * step):
            lo = mid
        else:
            hi = mid - 1
    return lo * step


def _tc_rows(spatial, fits: Callable[[int], bool]) -> int:
    """The most s_1 rows a chunk (rank 1: points, a multiple of 16) of the
    tensor-core chain, up to ``_TC_ROWS``, for which `fits` holds, stepping
    down one at a time (its layout is not monotone in the rows: the warps
    that split a stage's depth need partial tiles); `step` when none does."""
    step = 16 if len(spatial) == 1 else 1
    rows = min(_pad(spatial[0], step), _TC_ROWS[len(spatial)])
    while rows > step and not fits(rows):
        rows -= step
    return rows


class PlanRefused(ValueError):
    """A plan the planner refuses. `field` names the pinned plan field it
    refuses (``FNOConfig.block_plan``, a tuned entry, ``plan=`` of a
    wrapper), or is None where the shape itself cannot be planned."""

    def __init__(self, field: Optional[str], msg: str):
        super().__init__(msg if field is None else
                         f"plan field {field!r} refused: {msg}")
        self.field = field


def _check_smem(smem: int, what: str, hidden, out, spatial, modes,
                field: Optional[str] = None) -> None:
    if smem > _SMEM_LIMIT:
        raise PlanRefused(field, (
            f"{what} needs {smem} B of shared memory for hidden={hidden} "
            f"out={out} spatial={tuple(spatial)} modes={tuple(modes)} "
            f"(limit {_SMEM_LIMIT}); this shape needs a tiled kernel"))


def _grow(plan_fn: Callable, max_cluster: int, *args,
          **pins) -> Dict[str, int]:
    """`plan_fn` at `max_cluster`, or at Hopper's clusters of 16 when the
    smaller cluster cannot hold the shape (too many out channels per block
    or too much shared memory); raises the larger cluster's ValueError when
    neither can."""
    try:
        return plan_fn(*args, max_cluster, **pins)
    except ValueError:
        if max_cluster >= _MAX_CLUSTER:
            raise
        return plan_fn(*args, _MAX_CLUSTER, **pins)


def _rows_range(kind: str, spatial, modes) -> Tuple[int, int, int]:
    """(least, most, step) of a forward chunk's s_1 rows (rank 1: points)
    on chain `kind`: the tensor cores' up to ``_TC_ROWS`` (rank 1 in
    multiples of 16 points), the CUDA cores' up to ``_chain_rows``."""
    if kind == "tc":
        step = 16 if len(spatial) == 1 else 1
        return step, min(_pad(spatial[0], step), _TC_ROWS[len(spatial)]), step
    return 1, _chain_rows(spatial, modes), 1


def _pinned_rows(field: str, v: int, lo: int, hi: int, step: int,
                 fits: bool) -> None:
    """Refuse a pinned chunk size outside [lo, hi] in steps of `step`, or
    whose layout does not fit."""
    if not (lo <= v <= hi and v % step == 0):
        raise PlanRefused(field, f"{field}={v} is outside {lo}..{hi}"
                          + (f" in steps of {step}" if step > 1 else ""))
    if not fits:
        raise PlanRefused(field, f"{field}={v} does not fit the "
                          f"{_SMEM_LIMIT} B of shared memory (or the "
                          f"registers' tiles) of a block")


def launch_plan(hidden: int, out: int, spatial: Sequence[int],
                modes: Sequence[int], max_cluster: int = _PORTABLE_CLUSTER,
                per_mode: bool = False,
                ends: Optional[Tuple[int, int, int, int]] = None,
                chain: Optional[str] = None, rows_f: int = 0,
                rows_i: int = 0) -> Dict[str, int]:
    """The block kernel's cluster size, channel slices, chunk rows, phase
    1's chain and shared memory, at clusters of up to `max_cluster` blocks
    or of 16 when those cannot hold the shape; raises ValueError for shapes
    the kernel cannot hold. Shared weights are staged in shared memory (2
    rows of [os,H]: wr, wi); per-mode weights [O,H,K] are read from device
    memory as the CGEMM streams over the modes. wb's rows and the bias are
    staged only with the ends: without them the split epilogue stages wb's
    columns of 32 out channels at a time over the inverse chain's stages.

    Phase 1 (the forward chain) works over C and the tail, phase 3 keeps C,
    its factors and stages in the tail and ys over the spectra A where it
    fits (``_block_layout``), so the two are planned apart. "chain" is "tc"
    (the tensor cores: the most s_1 rows up to ``_TC_ROWS`` whose resident
    factors fit, fno3d 2) where that fits and its accumulator tiles fit the
    registers, else "fma" (the CUDA cores: the most rows up to the
    register-filling count, ``_chain_rows``, that fit); `chain` forces one
    (ValueError where it does not fit). "rows_i", the s_1 rows of an
    inverse chunk, is the most that fit.

    ends=(C_in, L, Lp, C_out) plans a launch with the model's end MLPs
    (L=0: no lift, Lp=0: no projection) and adds "ep", the points a block
    takes of each piece of a chunk (128, or fewer where that does not
    fit): the lift holds the block's hidden slice of a chunk,
    [hs][rows_f·P], where the chain reads the input (its chain is "fma"),
    and a piece's inner activation and lifted state, [L][ep] and [H][ep];
    in phase 3, over the inverse chain's stages, the bypass piece
    [max(L,O)][ep] with [H][ep]; the projection a piece's [O][ep] channels,
    [Lp][ep] hidden units and [C_out][ep] outputs.

    rows_f / rows_i (0: the planner's) pin a chunk's rows: rows_f within
    the chain's range (rank 1's tensor-core chain a multiple of 16 points)
    where phase 1 fits at it, rows_i where phase 3 does; otherwise
    ``PlanRefused`` naming the field."""
    return dict(_grow(_launch_plan, max_cluster, hidden, out,
                      tuple(spatial), tuple(modes), per_mode,
                      tuple(ends) if ends is not None else None, chain,
                      rows_f=rows_f, rows_i=rows_i))


def _inv_bytes(spatial, modes, os_, rows_i, wl, dp):
    """(C's bytes, the factors' bytes, the stages' bytes) of the inverse
    chain with `wl` columns of the last factor and `dp` rows of the first at
    once: ``chain::inv_layout`` of csrc/chain_tc.cuh."""
    r = len(spatial)
    n = list(spatial) + [1] * (3 - r)
    k = list(modes) + [1] * (3 - r)
    mc = os_ if r == 1 else _pad(os_ * k[1] * k[2], 16)
    c = 4 * (_pad(k[0], 4) * (2 * mc + (0 if r == 1 else 8)) + 32)
    wl = min(wl, _pad(n[r - 1], 8))
    fac = [(min(dp, _pad(k[0], 4)), _pad(rows_i, 8))]
    if r >= 2:
        fac.append((_pad(k[1], 4), wl if r == 2 else _pad(n[1], 8)))
    if r == 3:
        fac.append((_pad(k[2], 4), wl))
    fbytes = sum(_pad(4 * d * (2 * h + 8), 128) for d, h in fac)
    stages = 0
    if r >= 2:
        m1 = _pad(os_ * rows_i * k[2], 16)
        stages += _pad(4 * _pad(k[1], 4) * (2 * m1 + 8), 128)
    if r == 3:
        m2 = _pad(os_ * rows_i * n[1], 16)
        stages += _pad(4 * _pad(k[2], 4) * (2 * m2 + 8), 128)
    return c, fbytes, stages


def _block_layout(esize, hidden, out, spatial, modes, hs, os_, rows_f,
                  rows_i, wl, dp, chain, per_mode, lift=0, lp=0, cout=0,
                  ep=0):
    """{"p1", "p3", "bytes", "tiles"}: the ends of phases 1 and 3, the
    shared memory of a block launch and (chain "tc") the chain's
    accumulator tiles: ``block_layout`` of csrc/fused_block.cu."""
    r = len(spatial)
    n = list(spatial) + [1] * (3 - r)
    kk = 1
    for m in modes:
        kk *= m
    p = n[1] * n[2]
    ends = (os_ * hidden + _MAX_OUT) if lift or lp else 0  # wb, the bias
    a = _pad(4 * ((0 if per_mode else 2) * os_ * hidden + ends), 128)
    c = _pad(a + 8 * hs * kk, 128)
    cbytes, fbytes, stages = _inv_bytes(spatial, modes, os_, rows_i, wl,
                                        dp)
    t = _pad(c + cbytes, 128)
    tiles = 0
    if lift:
        chain_b = _chain_work(spatial, modes, rows_f) - rows_f * p
        p1 = 4 * (hs * rows_f * p + max(chain_b, (lift + hidden) * ep))
    elif chain == "fma":
        p1 = 4 * _chain_work(spatial, modes, rows_f)
    else:
        p1, tiles = _chain_bytes(esize, spatial, modes, rows_f, hs)
    # Over the stages the split epilogue's wb columns [H][kOG] (kOG = 32),
    # or over the factors and stages the ends' scratch.
    tail = fbytes + stages
    if not lift and not lp:
        tail = max(tail, fbytes + 4 * hidden * _OUT_GROUP)
    if lift:
        tail = max(tail, 4 * (max(lift, out) + hidden) * ep)
    if lp:
        tail = max(tail, 4 * (out + lp + cout) * ep)
    end = _pad(t + tail, 128)
    ys = 4 * os_ * rows_i * p
    if ys > 8 * hs * kk:
        end = _pad(end + ys, 128)
    return {"p1": c + p1, "p3": end, "bytes": max(c + p1, end),
            "tiles": tiles}


@functools.lru_cache(maxsize=1024)
def _launch_plan(hidden, out, spatial, modes, per_mode, ends, chain,
                 max_cluster, rows_f=0, rows_i=0):
    if chain not in (None,) + CHAINS:
        raise PlanRefused("chain", f"chain must be one of {CHAINS}, got "
                                   f"{chain!r}")
    cl, hs, os_ = _cluster_slices(hidden, out, max_cluster)
    _, lift, lp, cout = ends if ends is not None else (0, 0, 0, 0)
    pinned_chain = chain is not None
    if lift:
        if chain == "tc":
            raise PlanRefused("chain", "the lift feeds the CUDA cores' chain")
        chain = "fma"
    # The ends: the most points a block of a piece (the pieces' count
    # bounds those launches) at one s_1 row a chunk, then the most rows.
    # The inverse factors are resident where they fit at one s_1 row a
    # chunk: the first's rows (else dp at a time), then the last's columns
    # (else pieces of wl); then the most s_1 rows a chunk.
    low = 8 if len(spatial) > 1 else 0  # the least wl
    rows1 = _pad(modes[0], 4)
    for ep in ((128, 64, 32, 16, 8) if ends is not None else (0,)):
        lay = lambda rf, ri, kind, wl=low, dp=4, ep=ep: _block_layout(
            4, hidden, out, spatial, modes, hs, os_, rf, ri, wl, dp, kind,
            per_mode, lift, lp, cout, ep)
        if lay(1, 1, "fma")["bytes"] <= _SMEM_LIMIT:
            break
    p3 = lambda ri, wl, dp: lay(1, ri, "fma", wl, dp)["p3"] <= _SMEM_LIMIT
    dp = _most(rows1, lambda v: p3(1, low, v), 4)
    wl = low and _most(_pad(spatial[-1], 8), lambda v: p3(1, v, dp), 8)
    if rows_i:
        _pinned_rows("rows_i", rows_i, 1, spatial[0], 1,
                     p3(rows_i, wl, dp))
    else:
        rows_i = _most(spatial[0], lambda v: p3(v, wl, dp))
    fits_f = {"tc": lambda v: lay(v, 1, "tc")["p1"] <= _SMEM_LIMIT and lay(
                  v, 1, "tc")["tiles"] <= _WARPS * _MAX_ACC,
              "fma": lambda v: lay(v, 1, "fma")["p1"] <= _SMEM_LIMIT}
    kinds = (chain,) if chain is not None else CHAINS
    pin_f = rows_f
    for kind in kinds:
        lo, hi, step = _rows_range(kind, spatial, modes)
        if pin_f:
            if not (lo <= pin_f <= hi and pin_f % step == 0
                    and fits_f[kind](pin_f)) and kind != kinds[-1]:
                continue
            _pinned_rows("rows_f", pin_f, lo, hi, step, fits_f[kind](pin_f))
        elif kind == "tc":
            rows_f = _tc_rows(spatial, fits_f["tc"])
        else:
            rows_f = _most(hi, fits_f["fma"])
        got = lay(rows_f, rows_i, kind, wl, dp)
        if got["bytes"] <= _SMEM_LIMIT and got["tiles"] <= _WARPS * _MAX_ACC:
            break
    field = ("chain" if pinned_chain else "rows_f" if pin_f else None)
    _check_smem(got["bytes"], "fused block kernel", hidden, out, spatial,
                modes, field)
    if kind == "tc" and got["tiles"] > _WARPS * _MAX_ACC:
        raise PlanRefused(field, (
            f"fused block kernel's tensor-core chain holds at most "
            f"{_WARPS * _MAX_ACC} tiles in registers, got {got['tiles']} for "
            f"hidden={hidden} modes={tuple(modes)}"))
    plan = {"cluster": cl, "hs": hs, "os": os_, "rows_f": rows_f,
            "rows_i": rows_i, "smem": got["bytes"], "chain": kind, "wl": wl,
            "dp": dp}
    if ends is not None:
        plan["ep"] = ep
    return plan


def wgrad_plan(hidden: int, out: int, spatial: Sequence[int],
               modes: Sequence[int], max_cluster: int = _PORTABLE_CLUSTER,
               per_mode: bool = False,
               chain: Optional[str] = None, rows_f: int = 0,
               cols: int = 0) -> Dict[str, int]:
    """The weight-gradient kernel's cluster size, channel slices, chunk
    sizes, phase 1's chain and shared memory, at clusters of up to
    `max_cluster` blocks or of 16 when those cannot hold the shape; raises
    ValueError for shapes it cannot hold. "chain" is "tc" (the tensor
    cores, its factors resident) where that fits beside the spectra and its
    accumulator tiles fit the registers, else "fma" (the CUDA cores);
    `chain` forces one. "rows_f" is the s_1 rows of a chain's chunk (rank
    1: its points), the most that fit, up to ``_TC_ROWS`` ("tc") or the
    register-filling count ``_chain_rows`` ("fma"); "cols" the points of a
    dW_b chunk, the most up to ``_WGRAD_COLS`` whose double buffer fits the
    shared memory the chains take (at least 64 KB); "work" the floats
    after the flag that the per-mode batch reduction stages Ĝ in
    (``wgrad_mode_chunk``). Sized for f32 operands: bf16 ones take no more.
    Planned once per shape (every launch asks). rows_f and cols (0: the
    planner's) pin the chain's rows, as ``launch_plan``'s, and the dW_b
    chunk's points (one of ``WGRAD_COLS``, at most a block's share of the
    points, where it fits); otherwise ``PlanRefused`` naming the field."""
    return dict(_grow(_wgrad_plan, max_cluster, hidden, out, tuple(spatial),
                      tuple(modes), per_mode, chain, rows_f=rows_f,
                      cols=cols))


# The points a dW_b chunk of the wgrad kernel may take, most first.
WGRAD_COLS = (_WGRAD_COLS, 128, 64, 32, 16)


def _pad(v: int, m: int) -> int:
    return -(-v // m) * m


def _chain_bytes(esize, spatial, modes, rows, nch):
    """(bytes, accumulating tiles) of the tensor-core chain's work area:
    ``chain::layout`` and ``chain::acc_tiles`` of csrc/chain_tc.cuh."""
    r = len(spatial)
    n, k = list(spatial), list(modes)
    dep, xpad = (16, 8) if esize == 2 else (8, 4)
    ha = _pad(k[-1], 8)
    ldfa = 2 * ha + 8
    if r == 1:
        xrows = _pad(nch, 16)
        da = _pad(rows, dep)
        xb = _pad(xrows * (da + xpad) * esize, 128)
        fb = _pad(da * ldfa * esize, 128)
        return 2 * xb + 2 * fb, (xrows // 16) * (2 * ha // 8)
    da = _pad(n[-1], dep)
    xrows = _pad(rows * n[1] if r == 3 else rows, 16)
    h1 = _pad(k[0], 8)
    mz = _pad((k[1] if r == 3 else 1) * ha, 16)
    parts = [da * ldfa * esize, xrows * (da + xpad) * esize,
             xrows * (da + xpad) * esize, 4 * _pad(n[0], 4) * (2 * h1 + 8),
             4 * _pad(rows + 3, 4) * (2 * mz + 8)]
    ta = (xrows // 16) * (2 * ha // 8)
    split = (_depth_splits(ta, da // dep) - 1) * ta
    if r == 3:
        d2, h2, mb = _pad(n[1], 4), _pad(k[1], 8), _pad(rows * ha, 16)
        parts += [4 * d2 * (2 * h2 + 8), 4 * d2 * (2 * mb + 8)]
        tb = (mb // 16) * (2 * h2 // 8)
        split = max(split, (_depth_splits(tb, d2 // 4) - 1) * tb)
    parts.append(512 * split)
    return sum(_pad(p, 128) for p in parts), (mz // 16) * (2 * h1 // 8)


def _depth_splits(tiles: int, steps: int) -> int:
    """Warps that split each of a chain stage's tiles (``depth_splits``)."""
    return 1 if tiles >= _WARPS else min(_WARPS // tiles, steps)


def _wgrad_bytes(esize, hidden, out, spatial, modes, hs, os_, rows, cols,
                 bypass=True, chain="tc"):
    """(shared-memory bytes, chain tiles, dW_b tiles) of a wgrad launch:
    ``wgrad_layout`` of csrc/fused_wgrad.cu (chain "fma": no chain
    tiles)."""
    kk = 1
    for m in modes:
        kk *= m
    work = _pad(_WGRAD_FLAG + 4 * 2 * (hs + os_) * (kk + 1), 128)
    if chain == "fma":
        nbytes, chain_tiles = work + 4 * _chain_work(spatial, modes, rows), 0
    else:
        tc_bytes, chain_tiles = _chain_bytes(esize, spatial, modes, rows,
                                             max(hs, os_))
        nbytes = work + tc_bytes
    om, hn = _pad(out, 16), _pad(hidden + 1, 8)
    ldp = cols + (8 if esize == 2 else 4)
    tiles = (om // 16) * (hn // 8)
    splits = 1 if tiles >= _WARPS else _WARPS // tiles
    if bypass:
        g = _pad(om * ldp * esize, 128)
        x = _pad(hn * ldp * esize, 128)
        part = _pad(4 * out * (hidden + 1), 128)
        spl = 4 * splits * tiles * 128 if splits > 1 else 0
        nbytes = max(nbytes, _WGRAD_FLAG + 2 * g + 2 * x,
                     _WGRAD_FLAG + part + spl)
    return nbytes, chain_tiles, tiles


@functools.lru_cache(maxsize=1024)
def _wgrad_plan(hidden, out, spatial, modes, per_mode, chain, max_cluster,
                rows_f=0, cols=0):
    if hidden > _THREADS:
        raise ValueError(f"fused wgrad kernel takes at most {_THREADS} "
                         f"hidden channels, got {hidden}")
    if chain not in (None,) + CHAINS:
        raise PlanRefused("chain", f"chain must be one of {CHAINS}, got "
                                   f"{chain!r}")
    cl, hs, os_ = _cluster_slices(hidden, out, max_cluster)
    pts = 1
    for s in spatial:
        pts *= s
    share = max(16, _pad(-(-pts // cl), 16))  # a block's points, padded
    kinds = (chain,) if chain is not None else CHAINS
    if cols and not (cols in WGRAD_COLS and cols <= share):
        raise PlanRefused("cols", f"cols={cols} is not one of {WGRAD_COLS} "
                                  f"up to a block's {share} points")
    for kind in kinds:
        at = lambda rows, cols, bypass=True, kind=kind: _wgrad_bytes(
            4, hidden, out, spatial, modes, hs, os_, rows, cols, bypass,
            kind)
        fits = lambda v: at(v, 16, False)[0] <= _SMEM_LIMIT
        lo, hi, step = _rows_range(kind, spatial, modes)
        if rows_f:
            if not (lo <= rows_f <= hi and rows_f % step == 0
                    and fits(rows_f)) and kind != kinds[-1]:
                continue
            _pinned_rows("rows_f", rows_f, lo, hi, step, fits(rows_f))
            rows = rows_f
        elif kind == "tc":
            rows = _tc_rows(spatial, fits)
        else:
            rows = _most(hi, fits)
        chains = at(rows, 16, False)[0]
        pick = cols or 16
        for c in () if cols else WGRAD_COLS[:-1]:
            if c <= share and at(rows, c)[0] <= max(chains, 65536):
                pick = c
                break
        smem, chain_tiles, tiles = at(rows, pick)
        if smem <= _SMEM_LIMIT and chain_tiles <= _WARPS * _MAX_ACC:
            break
    field = ("cols" if cols and at(rows, 16)[0] <= _SMEM_LIMIT
             else "chain" if chain is not None
             else "rows_f" if rows_f else None)
    _check_smem(smem, "fused wgrad kernel", hidden, out, spatial, modes,
                field)
    cols = pick
    if chain_tiles > _WARPS * _MAX_ACC or tiles > _WARPS * _MAX_PT:
        raise PlanRefused(field, (
            f"fused wgrad kernel holds at most {_WARPS * _MAX_ACC} chain and "
            f"{_WARPS * _MAX_PT} dW_b tiles in registers, got {chain_tiles} "
            f"and {tiles} for hidden={hidden} out={out} modes="
            f"{tuple(modes)}; this shape needs a tiled kernel"))
    return {"cluster": cl, "hs": hs, "os": os_, "rows_f": rows,
            "cols": cols, "work": (smem - _WGRAD_FLAG) // 4, "smem": smem,
            "chain": kind}


def wgrad_mode_chunk(plan: Dict[str, int], batch: int, modes) -> int:
    """Modes per chunk of the per-mode wgrad kernel's batch reduction: the
    last block of each cluster rank stages Ĝ of every sample over a chunk
    of modes, [B][2][os][chunk] floats, in the plan's work area."""
    kk = 1
    for m in modes:
        kk *= m
    chunk = min(kk, plan["work"] // (2 * batch * plan["os"]))
    if chunk < 1:
        raise ValueError(f"per-mode wgrad cannot stage a batch of {batch} "
                         f"in {plan['work']} floats of shared memory")
    return chunk


# The core kernel's plan fields, in fused_core_plan's order, and the ones
# its launch takes (which ``FORCED["core"]`` may pin; 0 or absent: the
# planner's choice).
CORE_PLAN_FIELDS = ("cluster", "hs", "os", "nb", "np", "kc", "ri", "wj",
                    "groups", "ptiles", "smem", "w_bytes")
CORE_LAUNCH = ("cluster", "np", "nb", "kc", "ri", "wj")

# The fields of each kernel's plan a launch may pin (a config's
# ``block_plan``, a tuned cache entry, a wrapper's ``plan=``); the planner
# chooses the fields left unpinned. The kind a launch is counted as
# (``launch_kind``) names its kernel.
PLAN_FIELDS = {"block": ("cluster", "chain", "rows_f", "rows_i"),
               "wgrad": ("cluster", "chain", "rows_f", "cols"),
               "core": CORE_LAUNCH}
_KERNEL_OF = {"wgrad": "wgrad", "spectral_wgrad": "wgrad", "core": "core"}


def kernel_of(kind: str) -> str:
    """The kernel ("block", "wgrad" or "core") a launch kind runs."""
    return _KERNEL_OF.get(kind, "block")


@functools.lru_cache(maxsize=256)
def _core_plan(lib, code: int, dims: Tuple[int, ...], force: Tuple[int, ...]):
    """(fits, plan, dims and the launch's plan as the C entries take them)
    from the library, once per shape: a model's launches repeat a
    handful."""
    out = (ctypes.c_longlong * len(CORE_PLAN_FIELDS))()
    ok = lib.fused_core_plan(code, _ints(list(dims)), _ints(list(force)),
                             out)
    plan = dict(zip(CORE_PLAN_FIELDS, out))
    return (bool(ok), plan, _ints(list(dims)),
            _ints([plan[k] for k in CORE_LAUNCH]))


def _core_launch(lib, dtype: torch.dtype, b: int, h: int, o: int, n1: int,
                 k1: int, p: int, per_mode: bool, k2: int,
                 pins: Optional[Dict[str, int]] = None):
    """(plan, dims, launch plan) of ``core_plan``; the last two as the C
    entries take them. `pins` fixes fields of ``CORE_LAUNCH`` (a refused
    pin raises ``PlanRefused`` naming the pinned fields); ``FORCED["core"]``
    wins over them."""
    force = FORCED.get("core") or {}
    unknown = set(force) - set(CORE_LAUNCH)
    if unknown:
        raise ValueError(f"FORCED['core'] pins only {CORE_LAUNCH}, got "
                         f"{sorted(unknown)}")
    force = {**(pins or {}), **force}
    ok, plan, dims, pl = _core_plan(
        lib, _DTYPE_CODES[dtype], (b, h, o, n1, k1, p, int(per_mode), k2 or p),
        tuple(int(force.get(k, 0)) for k in CORE_LAUNCH))
    if not ok:
        msg = (f"fused core kernel has no plan within {_SMEM_LIMIT} B of "
               f"shared memory and the grid's limits for B={b} hidden={h} "
               f"out={o} s_1={n1} k_1={k1} P={p} (last tried {plan})")
        if pins:
            raise PlanRefused(",".join(k for k in CORE_LAUNCH if k in pins),
                              f"{msg} with {pins} pinned")
        raise PlanRefused(None, f"{msg}; this shape needs a tiled kernel")
    return plan, dims, pl


def core_plan(lib, dtype: torch.dtype, b: int, h: int, o: int, n1: int,
              k1: int, p: int, per_mode: bool = False,
              k2: int = 0, pins: Optional[Dict[str, int]] = None
              ) -> Dict[str, int]:
    """The core kernel's launch plan, as the library computes it
    (``fused_core_plan``, the one source of its shared-memory layout): the
    cluster and its hidden / out slices, the samples and spectrum columns
    of a tile, the modes k_1 of a CGEMM chunk, the s_1 rows of a forward
    chunk, the points of an inverse chunk, the tiles (sample groups ×
    column tiles), a block's shared memory and the weight bytes a launch
    reads. b samples; p = Π K_R..K_2 and k2 = K_2 (per-mode W's column
    order; p by default). `pins` (and, over them, ``FORCED["core"]``) fix
    fields of ``CORE_LAUNCH``. Raises ValueError where no plan fits a block
    and the grid."""
    return _core_launch(lib, dtype, b, h, o, n1, k1, p, per_mode, k2,
                        pins)[0]


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


def _modes_contiguous(t: torch.Tensor) -> bool:
    """Whether t's axes after the first two are contiguous (from the
    strides alone: the wrappers check every launch's operands)."""
    step = 1
    for n, stride in zip(t.shape[:1:-1], t.stride()[:1:-1]):
        if n > 1 and stride != step:
            return False
        step *= n
    return True


def _check_tensors(what, x, ops, views=()):
    """dtype, device and grad checks of every operand: those of `ops` must
    be contiguous, `views` (spectral weights, which may be seen through
    swapped out and hidden axes) contiguous over their modes."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if not (all(t.is_contiguous() for t in ops)
            and all(_modes_contiguous(t) for t in views)):
        raise ValueError(f"{what} operands must be contiguous")
    for t in (*ops, *views):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{what} operands must share x's dtype and "
                            f"device ({x.dtype}, {x.device}), got "
                            f"{t.dtype} on {t.device}")
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


def _check_weights(what, wr, wi, o, h, modes):
    """Shared [O,H] or per-mode [O,H,k_1..k_R] spectral weights, the modes
    those of the operand bundle; returns True for per-mode weights."""
    shared, per_mode = (o, h), (o, h) + tuple(modes)
    for name, t in (("wr", wr), ("wi", wi)):
        if tuple(t.shape) not in (shared, per_mode):
            raise ValueError(f"{what}: {name} must be shared [O,H]={shared} "
                             f"or per-mode [O,H,k_1..k_R]={per_mode} (the "
                             f"operands' modes), got {tuple(t.shape)}")
    if wr.shape != wi.shape or wr.stride() != wi.stride():
        raise ValueError(f"{what}: wr and wi must share shape and strides")
    return wr.ndim > 2


def _check_ends(x, h, o, lift, proj):
    """The end MLPs' engine-layout operands; returns (C_in, L, Lp, C_out),
    0 for an absent end."""
    dims = [x.shape[1], 0, 0, 0]
    if lift is not None:
        if len(lift) != 4:
            raise ValueError("lift is (l1w [L,C_in], l1b [L,1], l2w [H,L], "
                             "l2b [H,1])")
        dims[1] = lift[0].shape[0]
        want = ((dims[1], x.shape[1]), (dims[1], 1), (h, dims[1]), (h, 1))
        for name, t, w in zip(("l1w", "l1b", "l2w", "l2b"), lift, want):
            if tuple(t.shape) != w:
                raise ValueError(f"lift {name} must be {w}, got "
                                 f"{tuple(t.shape)}")
    if proj is not None:
        if len(proj) != 4:
            raise ValueError("proj is (p1w [Lp,O], p1b [Lp,1], p2w [C_out,Lp],"
                             " p2b [C_out,1])")
        dims[2], dims[3] = proj[0].shape[0], proj[2].shape[0]
        want = ((dims[2], o), (dims[2], 1), (dims[3], dims[2]), (dims[3], 1))
        for name, t, w in zip(("p1w", "p1b", "p2w", "p2b"), proj, want):
            if tuple(t.shape) != w:
                raise ValueError(f"proj {name} must be {w}, got "
                                 f"{tuple(t.shape)}")
    return tuple(dims)


def _check(x, wr, wi, wb, bias, mats, act, gy, out_dtype, lift=None,
           proj=None):
    """Returns (spatial, modes, per_mode)."""
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
    ends = tuple(lift or ()) + tuple(proj or ())
    if ends and (act != "gelu" or wb is None or bias is None):
        raise ValueError("the model ends fold into a block forward: "
                         "act='gelu' with wb and bias")
    h = lift[2].shape[0] if lift is not None else x.shape[1]
    o = wr.shape[0]
    spatial = tuple(x.shape[2:])
    modes = _check_mats(mats, spatial, inverse=True)
    per_mode = _check_weights("fused block", wr, wi, o, h, modes)
    _check_ends(x, h, o, lift, proj)
    extra = tuple(t for t in (wb, bias, gy) if t is not None)
    _check_tensors("fused block", x, (x, *extra, *ends, *mats), (wr, wi))
    if wb is not None and tuple(wb.shape) != (o, h):
        raise ValueError(f"wb must be [O,H]=({o},{h}), got "
                         f"{tuple(wb.shape)}")
    if bias is not None and tuple(bias.shape) != (o, 1):
        raise ValueError(f"bias must be [O,1]=({o},1), got "
                         f"{tuple(bias.shape)}")
    if gy is not None and tuple(gy.shape) != (x.shape[0], o) + spatial:
        raise ValueError(f"gy must be [B,O,s…]={(x.shape[0], o) + spatial}, "
                         f"got {tuple(gy.shape)}")
    return spatial, modes, per_mode


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
    """Returns True for per-mode weights [O,H,K_1,K_2..K_R]."""
    if zr.ndim < 3:
        raise ValueError(f"z must be [B,H,s_1,K_R..K_2], got shape "
                         f"{tuple(zr.shape)}")
    _check_tensors("fused core", zr, (zr, zi, wr, wi, fr, fi, gr, gi))
    h, n1 = zr.shape[1], zr.shape[2]
    o, k1 = wr.shape[0], fr.shape[1]
    per_mode = _check_weights("fused core", wr, wi, o, h,
                              (k1,) + tuple(zr.shape[3:][::-1]))
    for name, t, want in (("zi", zi, tuple(zr.shape)), ("fr", fr, (n1, k1)),
                          ("fi", fi, (n1, k1)), ("gr", gr, (k1, n1)),
                          ("gi", gi, (k1, n1))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    return per_mode


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


def _pick(plan_fn: Callable, occupancy: Optional[Callable], batch: int,
          hidden: int, out: int, spatial, modes,
          per_mode: bool) -> Dict[str, int]:
    """The rule for the cluster: clusters of 16 blocks halve a sample's
    time but the card holds fewer of them at once, so take 16 when the
    whole batch fits in one wave of 16-block clusters (`occupancy(cluster,
    smem)`, asked of the card), else the portable 8 — unless the portable 8
    cannot hold the shape (hidden 128: more than 8 out channels per block),
    when the plan is 16 and a batch larger than one wave runs in waves.
    Without a card to ask (occupancy None) the portable plan."""
    plan = plan_fn(hidden, out, spatial, modes, _PORTABLE_CLUSTER, per_mode)
    try:
        big = plan_fn(hidden, out, spatial, modes, _MAX_CLUSTER, per_mode)
    except ValueError:  # pinned fields that hold at the portable size only
        return plan
    if big["cluster"] <= plan["cluster"] or occupancy is None:
        return plan
    return big if batch <= occupancy(big["cluster"], big["smem"]) else plan


def _exact_cluster(plan_fn: Callable, cluster: int, hidden: int, out: int,
                   spatial, modes, per_mode: bool) -> Dict[str, int]:
    """`plan_fn` at a pinned cluster size; ``PlanRefused`` naming "cluster"
    where the planner would take another."""
    try:
        plan = plan_fn(hidden, out, spatial, modes, cluster, per_mode)
    except PlanRefused as exc:
        if exc.field is not None:
            raise
        raise PlanRefused("cluster", f"cluster={cluster}: {exc}") from None
    if plan["cluster"] != cluster:
        raise PlanRefused("cluster", (
            f"cluster={cluster} cannot hold hidden={hidden} out={out} "
            f"spatial={tuple(spatial)} modes={tuple(modes)}: the planner "
            f"takes clusters of {plan['cluster']} there"))
    return plan


def plan_launch(kind: str, dtype: torch.dtype, batch: int, hidden: int,
                out: int, spatial, modes, per_mode: bool = False,
                pins: Optional[Dict[str, Any]] = None, *, lib=None,
                ends: Optional[Tuple[int, int, int, int]] = None
                ) -> Dict[str, Any]:
    """The plan of one launch of `kind` (``launch_kind``'s names) with the
    fields of `pins` that its kernel has (``PLAN_FIELDS``) fixed and the
    planner's choice for the rest: the block kernel's (``launch_plan``,
    `ends` as its), the wgrad kernel's (``wgrad_plan``) or the core's
    (``core_plan``, from `lib`, its library). An unpinned cluster follows
    ``_pick``'s rule, asking `lib`'s card how many clusters it holds (the
    portable plan without a library). Raises ``PlanRefused`` naming a
    pinned field the planner refuses. ``tuning.resolve_plan`` decides the
    pins."""
    kernel = kernel_of(kind)
    pins = {k: v for k, v in (pins or {}).items()
            if k in PLAN_FIELDS[kernel] and v}
    if kernel == "core":
        if lib is None:
            raise ValueError("the core's plan comes from its library "
                             "(fused_core_plan): pass lib")
        p = 1
        for k in modes[1:]:
            p *= k
        return dict(core_plan(lib, dtype, batch, hidden, out, spatial[0],
                              modes[0], p, per_mode,
                              modes[1] if len(modes) > 1 else 1, pins))
    cluster = pins.pop("cluster", 0)
    if kernel == "block":
        plan_fn, prefix = launch_plan, "fused_block"
        if ends is not None:
            plan_fn = functools.partial(launch_plan, ends=ends)
    else:
        plan_fn, prefix = wgrad_plan, "fused_wgrad"
    if pins:
        plan_fn = functools.partial(plan_fn, **pins)
    if cluster:
        return _exact_cluster(plan_fn, cluster, hidden, out, spatial, modes,
                              per_mode)
    occupancy = None if lib is None else functools.partial(
        _max_clusters, lib, prefix, _DTYPE_CODES[dtype], len(spatial))
    return _pick(plan_fn, occupancy, batch, hidden, out, spatial, modes,
                 per_mode)


_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


def pick_plan(lib, dtype_code: int, batch: int, hidden: int, out: int,
              spatial, modes, per_mode: bool = False,
              ends: Optional[Tuple[int, int, int, int]] = None,
              kind: Optional[str] = None, plan=None) -> Dict[str, int]:
    """The block kernel's plan for this batch on this card, as
    ``tuning.resolve_plan`` resolves it field by field: `plan` (an
    override, ``FNOConfig.block_plan``'s (field, value) pairs), then a
    fresh tuned entry for `kind` (the launch's ``launch_kind``; None or an
    untuned kind: none), then the rule planner; ``FORCED`` over all of
    them. `ends` as ``launch_plan``'s (the card's cluster occupancy is
    asked of the kernel without the ends, which at the presets' ends plans
    is the same: one block an SM)."""
    from repro_torch.tuning import resolve
    plan_fn = (launch_plan if ends is None
               else functools.partial(launch_plan, ends=ends))
    got = resolve.resolve_plan(
        kind or "block_fwd", _CODE_DTYPES[dtype_code], batch, hidden, out,
        spatial, modes, per_mode, plan, lib=lib, ends=ends,
        use_cache=kind is not None).plan
    return _forced(plan_fn, got, hidden, out, spatial, modes, per_mode)


def pick_wgrad_plan(lib, dtype_code: int, batch: int, hidden: int,
                    out: int, spatial, modes, per_mode: bool = False,
                    kind: Optional[str] = None, plan=None) -> Dict[str, int]:
    """The weight-gradient kernel's plan for this batch on this card,
    resolved as ``pick_plan``'s (`kind` "wgrad" is tuned)."""
    from repro_torch.tuning import resolve
    got = resolve.resolve_plan(
        kind or "wgrad", _CODE_DTYPES[dtype_code], batch, hidden, out,
        spatial, modes, per_mode, plan, lib=lib,
        use_cache=kind is not None).plan
    return _forced(wgrad_plan, got, hidden, out, spatial, modes, per_mode)


# What ``pick_plan`` and ``pick_wgrad_plan`` force on the plans they pick,
# for the measurements and tests that run a plan the planner does not pick;
# it wins over a config's override and the tuned cache alike:
# "chain" replans phase 1's chain at the picked cluster (ValueError where it
# does not fit); "core" (a dict of ``CORE_LAUNCH`` fields) pins those fields
# of ``core_plan``'s plans; any other key lowers that field of the plans
# that have it to at most its value (fewer rows or columns a piece need no
# more shared memory). Empty: the planner's plans. Set by ``forced_chain``.
FORCED: Dict[str, Any] = {}


def _forced(plan_fn: Callable, plan: Dict[str, int], hidden: int, out: int,
            spatial, modes, per_mode: bool) -> Dict[str, int]:
    if not FORCED:
        return plan
    if FORCED.get("chain") is not None:
        plan = plan_fn(hidden, out, spatial, modes, plan["cluster"],
                       per_mode, chain=FORCED["chain"])
    return {k: min(v, FORCED[k]) if k in FORCED and k != "chain" else v
            for k, v in plan.items()}


@contextlib.contextmanager
def forced_chain(chain: Optional[str] = None, **fields: int):
    """Within the block, ``FORCED`` holds `chain` ("tc" or "fma"; None keeps
    the planner's) and `fields` (``core={...}`` the core's): how
    ``block_phases.py``, ``chip_smoke.py`` and the tests run the plan the
    planner does not pick."""
    saved = dict(FORCED)
    FORCED.clear()
    FORCED.update(fields, chain=chain)
    try:
        yield
    finally:
        FORCED.clear()
        FORCED.update(saved)


def _ints(v):
    return (ctypes.c_int * len(v))(*v)


def _dims(b, h, o, spatial, modes):
    r = len(spatial)
    return _ints([b, h, o] + list(spatial) + [1] * (3 - r)
                 + list(modes) + [1] * (3 - r))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(lib, x, wr, wi, wb, bias, mats, spatial, modes, stream, *,
            act="gelu", gy=None, out_dtype=None, lift=None, proj=None,
            adjoint=False, plan=None):
    """Allocate y and launch the block kernel through the C entry (no
    checks), at the plan ``pick_plan`` resolves for the launch's kind."""
    b = x.shape[0]
    o, h = wr.shape[:2]
    per_mode = wr.ndim > 2
    code = _DTYPE_CODES[x.dtype]
    edims = (_check_ends(x, h, o, lift, proj)
             if lift is not None or proj is not None else None)
    kind = launch_kind(wb, act, adjoint, edims is not None)
    plan = pick_plan(lib, code, b, h, o, spatial, modes, per_mode, edims,
                     kind=kind, plan=plan)
    od = out_dtype or x.dtype
    oc = edims[3] if proj is not None else o
    y = torch.empty((b, oc) + tuple(spatial), dtype=od, device=x.device)
    pl = _ints([plan["cluster"], plan["hs"], plan["os"], plan["rows_f"],
                plan["rows_i"], plan["smem"], plan.get("ep", 0),
                CHAINS.index(plan["chain"]), plan["wl"], plan["dp"]])
    # The weights' element strides of their out and hidden axes (dx takes
    # a transposed view, without a copy); per-mode, the modes are
    # contiguous.
    wl = _ints([int(per_mode), wr.stride(0), wr.stride(1)])
    ptrs = (ctypes.c_void_p * len(mats))(*[m.data_ptr() for m in mats])
    eptrs = edv = None
    if edims is not None:
        ends = tuple(lift or (None,) * 4) + tuple(proj or (None,) * 4)
        eptrs = (ctypes.c_void_p * 8)(*[_ptr(t) for t in ends])
        edv = _ints(list(edims))
    err = lib.fused_block_forward(
        code, len(spatial), _ACT_CODES[act], int(od == _F32), x.data_ptr(),
        wr.data_ptr(), wi.data_ptr(), _ptr(wb), _ptr(bias), _ptr(gy),
        ptrs, y.data_ptr(), _dims(b, h, o, spatial, modes), pl, wl, eptrs,
        edv, stream)
    if err != 0:
        msg = lib.fused_block_error_string(err).decode()
        raise RuntimeError(f"fused block kernel launch failed: {msg} "
                           f"(cudaError {err}, plan {plan})")
    return y


def _launch_wgrad(lib, x, gz, mats, spatial, modes, stream,
                  per_mode=False, with_bypass=True, plan=None):
    """Allocate the outputs and scratch and launch the weight-gradient
    kernel through the C entry (no checks) at the plan ``pick_wgrad_plan``
    resolves; returns (dwr, dwi, dwb, dbias), or (dwr, dwi) without the
    bypass."""
    b, h = x.shape[:2]
    o = gz.shape[1]
    code = _DTYPE_CODES[x.dtype]
    plan = pick_wgrad_plan(lib, code, b, h, o, spatial, modes, per_mode,
                           kind="wgrad" if with_bypass else "spectral_wgrad",
                           plan=plan)
    chunk = wgrad_mode_chunk(plan, b, modes) if per_mode else 0
    dev = x.device
    kk = 1
    for m in modes:
        kk *= m
    # Per sample: the dW partials (shared W), the dW_b and dbias partials
    # (with the bypass), then the spectra A [2][H][K] and Ĝ [2][O][K] for
    # the batch reduction (per-mode W).
    wsn = ((2 * (h + o) * kk if per_mode else 2 * o * h)
           + (o * h + o if with_bypass else 0))
    ws = torch.empty((b, wsn), dtype=_F32, device=dev)
    tickets = torch.zeros((plan["cluster"],), dtype=torch.int32, device=dev)
    dw = (o, h) + (tuple(modes) if per_mode else ())
    outs = [torch.empty(dw, dtype=_F32, device=dev) for _ in range(2)]
    if with_bypass:
        outs.append(torch.empty((o, h), dtype=_F32, device=dev))
        outs.append(torch.empty((o, 1), dtype=_F32, device=dev))
    pl = _ints([plan["cluster"], plan["hs"], plan["os"], plan["rows_f"],
                plan["cols"], plan["smem"], int(per_mode), chunk,
                int(with_bypass), CHAINS.index(plan["chain"])])
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


def core_max_clusters(lib, dtype: torch.dtype, b: int, h: int, o: int,
                      n1: int, k1: int, p: int, per_mode: bool = False,
                      k2: int = 0) -> int:
    """How many clusters of the core's launch at this shape (its plan as
    ``core_plan``'s) the card runs at once (``fused_core_max_clusters``)."""
    _, dims, pl = _core_launch(lib, dtype, b, h, o, n1, k1, p, per_mode, k2)
    n = ctypes.c_int(0)
    err = lib.fused_core_max_clusters(_DTYPE_CODES[dtype], dims, pl,
                                      ctypes.byref(n))
    if err != 0:
        msg = lib.fused_core_error_string(err).decode()
        raise RuntimeError(f"fused core occupancy query failed: {msg}")
    return n.value


def _launch_core(lib, zr, zi, wr, wi, fr, fi, gr, gi, stream, plan=None,
                 spatial=None):
    """Allocate the y pair and launch the core kernel through the C entry
    (no checks) at the plan ``tuning.resolve_plan`` resolves: `plan` (an
    override), then, where `spatial` (the block's extents, which the tuned
    cache keys by) is given, a fresh tuned entry, then the library's."""
    from repro_torch.tuning import resolve
    b, h, n1 = zr.shape[:3]
    spec = tuple(zr.shape[3:])
    o, k1 = wr.shape[0], fr.shape[1]
    per_mode = wr.ndim > 2
    p = 1
    for k in spec:
        p *= k
    # Per-mode weights [O,H,K_1,K_2..K_R]: K_2 decodes p = (k_R..k_2).
    k2 = spec[-1] if spec else 1
    modes = (k1,) + spec[::-1]
    got = resolve.resolve_plan(
        "core", zr.dtype, b, h, o, spatial or (n1,) + spec[::-1], modes,
        per_mode, plan, lib=lib, use_cache=spatial is not None).plan
    plan, dims, pl = _core_launch(lib, zr.dtype, b, h, o, n1, k1, p,
                                  per_mode, k2,
                                  {k: got[k] for k in CORE_LAUNCH})
    shape = (b,) + spec + (o, n1)
    yr = torch.empty(shape, dtype=zr.dtype, device=zr.device)
    yi = torch.empty(shape, dtype=zr.dtype, device=zr.device)
    ptrs = (ctypes.c_void_p * 8)(*[t.data_ptr() for t in
                                   (zr, zi, wr, wi, fr, fi, gr, gi)])
    err = lib.fused_core(_DTYPE_CODES[zr.dtype], ptrs, yr.data_ptr(),
                         yi.data_ptr(), dims, pl, stream)
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
                out_dtype: Optional[torch.dtype] = None,
                adjoint: bool = False,
                lift: Optional[Sequence[torch.Tensor]] = None,
                proj: Optional[Sequence[torch.Tensor]] = None,
                plan=None) -> torch.Tensor:
    """One FNO block kernel launch in one of its three epilogue modes.

    x: [B,H,s_1..s_R] float32 or bfloat16; wr/wi: shared [O,H] or
    per-mode [O,H,k_1..k_R] (the operands' modes; any strides over O and
    H, so dx can take a transposed view, contiguous over the modes);
    wb: [O,H] (wb=None: the bare spectral layer, with act="linear" and no
    bias); bias: [O,1] or
    None; mats: the 4R operands of ``core.spectral.operand_tensors`` (R
    forward-slot stages [n,k], axis s_R first, then R inverse-slot stages
    [k,n], axis s_1 first; the "adjoint" bundle for dx), all at x's dtype
    and contiguous. act: "gelu" (y), "gelu_vjp" (gz from gy [B,O,s…]) or
    "linear" (z). Returns [B,O,s_1..s_R] at `out_dtype` (x's dtype by
    default). adjoint=True marks a linear launch as a backward's dx
    (the block's, "dx_adjoint", or without wb the bare layer's,
    "spectral_dx"); the operands make it one, and the kind it is counted
    as is ``launch_kind``'s.

    The model's ends (act="gelu" with wb and bias; counted "block_ends"):
    lift=(l1w [L,C_in], l1b [L,1], l2w [H,L], l2b [H,1]) takes x as the
    raw input [B,C_in,s…] and forms the hidden channels
    l2·gelu_tanh(l1·x + b1) + b2 inside the launch; proj=(p1w [Lp,O],
    p1b [Lp,1], p2w [C_out,Lp], p2b [C_out,1]) returns the model's output
    p2·gelu_tanh(p1·y + b1) + b2 [B,C_out,s…] of the activated block
    output y. Either or both; all at x's dtype and contiguous.

    plan: an override of the launch's plan, (field, value) pairs of
    ``PLAN_FIELDS["block"]`` (``FNOConfig.block_plan``); the tuned cache
    and the rule planner fill the rest (``tuning.resolve_plan``).

    A CPU tensor runs ``fused_block_plain``; a CUDA tensor launches the
    kernel or raises.
    """
    spatial, modes, _ = _check(x, wr, wi, wb, bias, mats, act, gy,
                               out_dtype, lift, proj)
    if adjoint and act != "linear":
        raise ValueError("adjoint=True marks a backward's dx, which takes "
                         "act='linear'")
    if not _on_card(x, "fused block"):
        return fused_block_plain(x, wr, wi, wb, bias, mats, act=act, gy=gy,
                                 out_dtype=out_dtype, lift=lift, proj=proj)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        y = _launch(build.load_fused_block(), x, wr, wi, wb, bias, mats,
                    spatial, modes, stream, act=act, gy=gy,
                    out_dtype=out_dtype, lift=lift, proj=proj,
                    adjoint=adjoint, plan=plan)
    ends = lift is not None or proj is not None
    LAUNCHES[(launch_kind(wb, act, adjoint, ends),
              _dtype_name(x.dtype))] += 1
    return y


def fused_wgrad(x: torch.Tensor, gz: torch.Tensor,
                mats: Sequence[torch.Tensor], *, per_mode: bool = False,
                with_bypass: bool = True,
                plan=None) -> Tuple[torch.Tensor, ...]:
    """The block's (or the bare spectral layer's) weight gradients in one
    kernel launch.

    x: [B,H,s_1..s_R] float32 or bfloat16 (the block input); gz:
    [B,O,s_1..s_R] (the pre-activation cotangent); mats: the 4R operands of
    ``core.spectral.operand_tensors(kind="wgrad")`` (R forward stages for x,
    then R adjoint-forward stages for gz, each [n,k], axis s_R first), all
    at x's dtype and contiguous. Returns float32 (dwr, dwi, dwb [O,H],
    dbias [O,1]), or (dwr, dwi) with with_bypass=False (the bare spectral
    layer's backward, counted "spectral_wgrad"); with per_mode, dwr and
    dwi are one per mode, in the parameter layout [O,H,k_1..k_R]. plan: an
    override of ``PLAN_FIELDS["wgrad"]``, as ``fused_block``'s. A CPU
    tensor runs ``fused_wgrad_plain``; a CUDA tensor launches the kernel
    or raises.
    """
    spatial, modes = _check_wgrad(x, gz, mats)
    if not _on_card(x, "fused wgrad"):
        return fused_wgrad_plain(x, gz, mats, per_mode=per_mode,
                                 with_bypass=with_bypass)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        outs = _launch_wgrad(build.load_fused_wgrad(), x, gz, mats, spatial,
                             modes, stream, per_mode, with_bypass, plan)
    kind = "wgrad" if with_bypass else "spectral_wgrad"
    LAUNCHES[(kind, _dtype_name(x.dtype))] += 1
    return outs


def fused_core(zr: torch.Tensor, zi: torch.Tensor, wr: torch.Tensor,
               wi: torch.Tensor, fr: torch.Tensor, fi: torch.Tensor,
               gr: torch.Tensor, gi: torch.Tensor, *, plan=None,
               spatial: Optional[Sequence[int]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial variant's fused middle in one kernel launch: truncated
    cDFT along s_1 → CGEMM over hidden → padded icDFT along s_1.

    z: the pair [B,H,s_1,K_R..K_2] (outer axes already transformed),
    float32 or bfloat16; wr/wi: shared [O,H] or per-mode [O,H,K_1..K_R];
    fr/fi: [s_1,K_1] (forward cDFT); gr/gi: [K_1,s_1] (padded inverse),
    all at z's dtype and contiguous. Returns the y pair
    [B,K_R..K_2,O,s_1] at z's dtype with either weights (the reference's
    shared layout; its per-mode kernel emits [K_R..K_2,B,O,s_1]; the
    caller transposes). plan: an override of ``CORE_LAUNCH``'s fields, as
    ``fused_block``'s; spatial: the block's extents s_1..s_R, which the
    tuned cache keys the core's plan by (without them the launch takes the
    override and the library's plan). A CPU tensor runs
    ``fused_core_plain``; a CUDA tensor launches the kernel or raises.
    """
    _check_core(zr, zi, wr, wi, fr, fi, gr, gi)
    if not _on_card(zr, "fused core"):
        return fused_core_plain(zr, zi, wr, wi, fr, fi, gr, gi)
    with torch.cuda.device(zr.device):
        stream = torch.cuda.current_stream(zr.device).cuda_stream
        y = _launch_core(build.load_fused_core(), zr, zi, wr, wi, fr, fi,
                         gr, gi, stream, plan,
                         tuple(spatial) if spatial is not None else None)
    LAUNCHES[("core", _dtype_name(zr.dtype))] += 1
    return y
