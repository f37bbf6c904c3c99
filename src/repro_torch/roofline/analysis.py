"""The port's roofline: the model's counts over the H100's peaks, and the
least time of each kernel launch (counterpart of
``repro/roofline/analysis.py``).

Two groups of functions:

* the model's counts, held equal to the reference's: ``fno_model_flops``
  (useful operations of an FNO step), ``lm_model_flops`` (an LM step's),
  ``fno_model_bytes`` (the FNO's modelled device-memory traffic),
  ``fno_collective_bytes`` (the TP collectives' wire bytes), and
  ``fno_roofline``, a ``Roofline`` of compute / memory / collective ms
  from them over ``hw`` (the reference's ``Roofline`` without its HLO
  parsing: the port has no compiled module to read);
* the per-launch bounds ``chip_smoke.py`` holds each kernel's time
  against: ``bound_parts`` / ``bound_ms`` (a launch of a kind at a block's
  shape), ``cgemm_bound_parts`` / ``cgemm_bound``, and the counts under
  them (``block_flops``, ``wgrad_flops``, ``fft_flops``,
  ``partial_work``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.roofline import hw

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8,
                "f32": 4, "bf16": 2}

# The partial variant's launches (``partial_work`` counts them).
PARTIAL_LAUNCHES = ("rdft", "cdft", "icdft", "irdft", "core")


def dtype_bytes(name: str) -> int:
    """Bytes per element of a policy dtype name ("float32", "bfloat16")."""
    return _DTYPE_BYTES[name]


# ---------------------------------------------------------------------------
# The model's counts (the reference's formulas, term for term)
# ---------------------------------------------------------------------------
def fno_model_flops(cfg, batch: int, *, training: bool = True) -> float:
    """Useful operations of the truncated-DFT FNO layer algebra over a
    batch: each forward DFT stage transforms one axis n_j→k_j over the
    pencils of the other (partly transformed) axes, 4 real-product
    operations a point for the real first stage and 8 for complex ones;
    the CGEMM 8·Πk·H·O; the inverse chain mirrors the forward with O
    channels; a block adds the bypass (2·H·O a point) and the pointwise
    epilogue (12·O a point); the lift and projection MLPs 2 a
    multiply-add. training=True is 3× the forward (forward and backward),
    False the serving forward. Fusion does not change the count."""
    h = o = cfg.hidden
    sp = math.prod(cfg.spatial)
    lift = cfg.lifting_dim or 2 * h
    r = cfg.ndim
    spatial, modes = list(cfg.spatial), list(cfg.modes)
    cur = list(spatial)

    def stage(ch, ax, real):
        pencils = math.prod(cur) // cur[ax]
        return (4 if real else 8) * ch * pencils * spatial[ax] * modes[ax]

    spectral = stage(h, r - 1, True)  # rDFT along s_R (real input)
    cur[r - 1] = modes[r - 1]
    for ax in range(r - 2, -1, -1):  # cDFT along s_{R-1}…s_1
        spectral += stage(h, ax, False)
        cur[ax] = modes[ax]
    spectral += 8 * math.prod(modes) * h * o  # CGEMM over hidden
    for ax in range(r - 1):  # icDFT along s_1…s_{R-1}
        spectral += stage(o, ax, False)
        cur[ax] = spatial[ax]
    spectral += stage(o, r - 1, True)  # irDFT along s_R (real output)
    per_layer = spectral + 2 * sp * h * o + 12 * sp * o
    lifting = 2 * sp * (cfg.in_channels * lift + lift * h)
    proj = 2 * sp * (h * lift + lift * cfg.out_channels)
    fwd = batch * (cfg.num_layers * per_layer + lifting + proj)
    return (3.0 if training else 1.0) * fwd


def lm_model_flops(cfg, shape_kind: str, seq_len: int, global_batch: int
                   ) -> float:
    """Useful operations of an LM step: 6·N_active·tokens for training
    (shape_kind "train"), 2·N_active·tokens for inference ("prefill"; one
    token a row for "decode"), N_active the parameters a token reaches
    (``ModelConfig.param_count(active_only=True)``)."""
    n_active = cfg.param_count(active_only=True)
    tokens = global_batch * (seq_len if shape_kind != "decode" else 1)
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n_active * tokens


def fno_model_bytes(cfg, batch: int, *, variant: str = "full",
                    training: bool = True,
                    fuse_block: bool = None) -> float:
    """Modelled device-memory bytes of one FNO step at the config's
    precision: activations and kernel I/O at the compute dtype, DFT
    operands at the spectral dtype, dW and AdamW's master update at the
    param dtype.

    Whole-block fusion (fuse_block, default cfg.fuse_block, full variant)
    moves each operand once a launch: x, W, W_b and bias read, y written;
    training adds the gz recompute, the dx adjoint and the wgrad (x and gz
    read, dW, dW_b, dbias written). Otherwise the staged block: the
    spectral layer (with the partial variant's complex pairs written and
    read between its launches), the bypass GEMM, the sum and the GELU, and
    in training their backward. Lift, projection, the model's input and
    output, and in training AdamW (read params, two moments and grads;
    write params and moments) complete the step."""
    pol = cfg.precision
    cb = dtype_bytes(pol.compute_dtype)
    pb = dtype_bytes(pol.param_dtype)
    sb = dtype_bytes(pol.spectral_dtype)
    if fuse_block is None:
        fuse_block = getattr(cfg, "fuse_block", False)
    h = o = cfg.hidden
    sp = math.prod(cfg.spatial)
    lift = cfg.lifting_dim or 2 * h
    act = batch * h * sp  # one hidden activation tensor (elements)
    wmul = math.prod(cfg.modes) if cfg.weight_mode == "per_mode" else 1
    wc = 2 * h * o * wmul  # complex spectral weight (re+im)
    byp_w = h * o + o  # bypass 1x1 weight + bias
    mats = 4 * sum(n * k for n, k in zip(cfg.spatial, cfg.modes))

    spectral_fwd = (act + wc + act) * cb + mats * sb
    if variant == "partial" and cfg.ndim >= 2:
        kout = math.prod(cfg.modes[1:])
        inter = 2 * batch * (h + o) * cfg.spatial[0] * kout  # complex pairs
        spectral_fwd += 2 * inter * cb  # write + re-read between launches

    if fuse_block and variant == "full":
        per_layer = (2 * act + wc + byp_w) * cb + mats * sb
        if training:
            per_layer += (3 * act + wc + byp_w) * cb + mats * sb
            per_layer += (2 * act + wc + h * o) * cb + mats * sb
            per_layer += 2 * act * cb + (wc + byp_w) * pb
    else:
        per_layer = (spectral_fwd + (2 * act + byp_w) * cb
                     + 3 * act * cb + 2 * act * cb)
        if training:
            per_layer += spectral_fwd + 2 * act * cb + wc * pb
            per_layer += 3 * act * cb
            per_layer += (2 * act + h * o) * cb
            per_layer += 2 * act * cb + byp_w * pb

    io = batch * sp * (cfg.in_channels + cfg.out_channels) * cb
    lift_proj = (2 * batch * sp * (2 * lift + h)
                 + cfg.in_channels * lift + lift * h
                 + h * lift + lift * cfg.out_channels) * cb
    total = cfg.num_layers * per_layer + lift_proj + io
    if training:
        total += 7 * cfg.param_count() * pb
    return float(total)


def fno_collective_bytes(cfg, dp: int, tp: int, *, scattered: bool = True,
                         batch: int = 8) -> Dict[str, float]:
    """Per-rank wire bytes of the TP collectives in one sharded FNO forward
    on a ring of tp ranks, as the reference models them.

    Each fused block's sharded hidden contraction leaves every rank a
    partial of the full hidden activation, T = (batch/dp)·hidden·∏spatial
    ·compute bytes. An all-reduce ("psum") moves 2·(tp-1)/tp·T per rank;
    the scattered layout's reduce-scatter moves (tp-1)/tp·T and emits the
    next layer's shard (the ring of ``tp_overlap`` moves the same bytes in
    tp-1 hops). scattered=True: num_layers-1 interior reduce-scatters and
    the last layer's psum; scattered=False: num_layers psums. TP folds
    away (no bytes) where tp <= 1 or hidden % tp != 0, as ``make_context``
    folds it. The lift and projection MLPs' collectives are not counted,
    as the reference does not count them."""
    if tp <= 1 or cfg.hidden % tp != 0:
        return {"interior_per_layer": 0.0, "final": 0.0, "total": 0.0}
    cb = dtype_bytes(cfg.precision.compute_dtype)
    t = (batch / max(dp, 1)) * cfg.hidden * math.prod(cfg.spatial) * cb
    psum = 2.0 * (tp - 1) / tp * t
    interior = ((tp - 1) / tp * t) if scattered else psum
    n_interior = max(cfg.num_layers - 1, 0)
    final = psum if cfg.num_layers > 0 else 0.0
    return {"interior_per_layer": interior, "final": final,
            "total": n_interior * interior + final}


@dataclasses.dataclass
class Roofline:
    """Compute, memory and collective time of one FNO step on `chips`
    H100s from the model's counts (per card: the counts over the chips)
    and the card's peaks at the step's dtype."""

    arch: str
    shape: str
    mesh: str
    chips: int
    dtype: str          # the compute dtype ("float32" / "bfloat16")
    model_flops: float  # the whole step's useful operations
    model_bytes: float  # the whole step's modelled device-memory bytes
    coll_bytes: float   # per card

    @property
    def t_compute(self) -> float:
        return self.model_flops / self.chips / hw.peak_flops(self.dtype)

    @property
    def t_memory(self) -> float:
        return self.model_bytes / self.chips / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / hw.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def share(self, step_s: float) -> float:
        """The share of the roofline a measured step time reaches."""
        return self.t_bound / step_s if step_s > 0 else 0.0


def fno_roofline(cfg, batch: int, *, training: bool = True,
                 variant: str = "full", dp: int = 1, tp: int = 1,
                 fuse_block: bool = None) -> Roofline:
    """The ``Roofline`` of one step of `cfg` at a global batch on a dp×tp
    mesh (training or the serving forward). Its collective term is the
    forward's TP collectives as ``fno_collective_bytes`` models them; the
    backward's and the DP gradient reduction's are not modelled, as the
    reference does not model them."""
    coll = fno_collective_bytes(cfg, dp, tp,
                                scattered=cfg.tp_layout == "scatter",
                                batch=batch)["total"]
    return Roofline(
        arch=cfg.name, shape=f"b{batch}/{'train' if training else 'serve'}",
        mesh=f"dp{dp}xtp{tp}", chips=dp * tp,
        dtype=cfg.precision.compute_dtype,
        model_flops=fno_model_flops(cfg, batch, training=training),
        model_bytes=fno_model_bytes(cfg, batch, variant=variant,
                                    training=training,
                                    fuse_block=fuse_block),
        coll_bytes=coll)


# ---------------------------------------------------------------------------
# The least time of each kernel launch
# ---------------------------------------------------------------------------
def block_flops(b, h, o, spatial, modes) -> float:
    """Least operations of one fused block forward: a real FFT of each input
    and each output channel (2.5·N·log2 N for N points), the CGEMM (8 per
    complex multiply-add) and the bypass (2 per multiply-add)."""
    pts, kk = math.prod(spatial), math.prod(modes)
    fft = 2.5 * pts * math.log2(pts)
    return b * ((h + o) * fft + 8 * o * h * kk + 2 * o * h * pts)


def dense_dft_flops(b, h, o, spatial, modes) -> int:
    """Operations of one fused block forward as the kernel computes it:
    dense truncated-DFT stages, CGEMM, padded inverse stages, bypass."""
    r = len(spatial)
    macs = 0
    cur = list(spatial)  # forward: axis s_R first, real input then complex
    for i, ax in enumerate(range(r - 1, -1, -1)):
        rest = math.prod(n for j, n in enumerate(cur) if j != ax)
        macs += h * rest * spatial[ax] * modes[ax] * (2 if i == 0 else 4)
        cur[ax] = modes[ax]
    macs += o * h * math.prod(modes) * 4  # CGEMM
    cur = list(modes)  # inverse: axis s_1 first, real output last
    for ax in range(r):
        rest = math.prod(n for j, n in enumerate(cur) if j != ax)
        macs += o * rest * modes[ax] * spatial[ax] * (2 if ax == r - 1 else 4)
        cur[ax] = spatial[ax]
    macs += o * h * math.prod(spatial)  # bypass
    return 2 * b * macs


def wgrad_flops(b, h, o, spatial, modes) -> float:
    """Least operations of the weight gradients: a real FFT of each x and
    each gz channel, the spectral reduction (8 per complex multiply-add),
    the dW_b reduction (2 per multiply-add) and dbias (1 per add)."""
    return block_flops(b, h, o, spatial, modes) + b * o * math.prod(spatial)


def fft_flops(n: int, real: bool) -> float:
    """Least operations of one FFT of n points: 2.5·n·log2 n for real
    input or output, 5·n·log2 n complex (the convention of
    ``block_flops``)."""
    return (2.5 if real else 5.0) * n * math.log2(n) if n > 1 else 0.0


def partial_work(kind, b, h, o, spatial, modes, per_mode=False):
    """(least operations, elements moved) of one partial-variant launch at
    a block of B=b, H=h, O=o: each row read once and each output written
    once (operands too), against FFTs of the transformed axes.

    rdft: the b·h·s_1 rows over the outer axes s_2..s_R (one real FFT of
    all outer points each), reading the per-axis factor pairs the launch
    takes (2·Σ n_j·k_j elements: the one-axis operand at rank 2, never the
    Kronecker operand at rank 3); irdft: the b·o·s_1 rows back; cdft / icdft:
    the s_1 stage as a row launch over b·h·P (b·o·P) rows of s_1 points
    (complex FFTs; P = Πk_2..k_R); core: z and y pairs, W, both s_1
    operands, an s_1 FFT of every (b, channel, p) column each way and the
    CGEMM (8 per complex multiply-add); per-mode W holds 2·O·H·K_1·P
    elements."""
    n1, k1 = spatial[0], modes[0]
    n_out, p = math.prod(spatial[1:]), math.prod(modes[1:])
    factors = 2 * sum(n * k for n, k in zip(spatial[1:], modes[1:]))
    if kind == "rdft":
        rows = b * h * n1
        return (rows * fft_flops(n_out, True),
                rows * (n_out + 2 * p) + factors)
    if kind == "irdft":
        rows = b * o * n1
        return (rows * fft_flops(n_out, True),
                rows * (2 * p + n_out) + factors)
    if kind in ("cdft", "icdft"):
        rows = b * (h if kind == "cdft" else o) * p
        return rows * fft_flops(n1, False), rows * 2 * (n1 + k1) + 2 * n1 * k1
    w = 2 * o * h * (k1 * p if per_mode else 1)
    return (b * p * ((h + o) * fft_flops(n1, False) + 8 * o * h * k1),
            2 * b * p * n1 * (h + o) + w + 4 * n1 * k1)


def bound_parts(kind, b, h, o, spatial, modes, elem_bytes, peak_flops,
                per_mode=False, ends=None):
    """(ms by bytes, ms by operations) of one launch of `kind` on the card:
    each input read once and each output written once over the memory
    rate, and the least operations over the peak rate for the element
    type.

    block_fwd reads x, the weights and the operands and writes y;
    block_linear (the TP-partial block) does the same and writes y in
    f32; gz_recompute reads gy too and writes gz; dx_adjoint reads gz and
    writes dx (the same work with H and O swapped); wgrad reads x and gz
    and writes the f32 weight gradients; the bare layer's spectral_fwd,
    spectral_dx and spectral_wgrad do the same without the bypass, the
    bias and dW_b;
    the partial variant's launches as ``partial_work`` counts them;
    block_ends (a block with the model's end MLPs, ends=(C_in, L, Lp,
    C_out), L=0 without the lift, Lp=0 without the projection) reads the
    raw input [B,C_in,s…] with the lift and writes [B,C_out,s…] with the
    projection, reads the MLPs' weights once, and adds their
    multiply-adds (2 operations each; the tanh of their GELUs is not
    counted).
    Spectral weights count 2·O·H elements shared and 2·O·H·ΠK per-mode
    (read once, and written once by wgrad);
    the operations are the same for both, as a shared W is applied at
    every mode too."""
    pts, kk = math.prod(spatial), math.prod(modes)
    mats = sum(2 * 2 * n * k for n, k in zip(spatial, modes))  # 4R operands
    act_in, act_out = b * h * pts, b * o * pts
    spec_w = 2 * o * h * (kk if per_mode else 1)
    weights = spec_w + o * h + o
    flops = block_flops(b, h, o, spatial, modes)
    if kind == "block_fwd":
        nbytes = elem_bytes * (act_in + act_out + weights + mats)
    elif kind == "block_linear":
        nbytes = elem_bytes * (act_in + weights + mats) + 4 * act_out
    elif kind == "gz_recompute":
        nbytes = elem_bytes * (act_in + 2 * act_out + weights + mats)
    elif kind == "dx_adjoint":
        nbytes = elem_bytes * (act_out + act_in + spec_w + o * h + mats)
    elif kind in ("spectral_fwd", "spectral_dx"):  # no bypass, no bias
        nbytes = elem_bytes * (act_in + act_out + spec_w + mats)
        flops -= b * 2 * o * h * pts
    elif kind == "spectral_wgrad":  # dW only
        nbytes = elem_bytes * (act_in + act_out + mats) + 4 * spec_w
        flops -= b * 2 * o * h * pts
    elif kind == "block_ends":
        cin, lw, lp, cout = ends
        a_in = b * (cin if lw else h) * pts
        a_out = b * (cout if lp else o) * pts
        mlp = ((lw * cin + lw + h * lw + h if lw else 0)
               + (lp * o + lp + cout * lp + cout if lp else 0))
        nbytes = elem_bytes * (a_in + a_out + weights + mats + mlp)
        flops += 2 * b * pts * ((lw * (cin + h) if lw else 0)
                                + (lp * (o + cout) if lp else 0))
    elif kind in PARTIAL_LAUNCHES:
        flops, elems = partial_work(kind, b, h, o, spatial, modes, per_mode)
        nbytes = elem_bytes * elems
    else:
        nbytes = elem_bytes * (act_in + act_out + mats) + 4 * weights
        flops = wgrad_flops(b, h, o, spatial, modes)
    return 1e3 * nbytes / hw.HBM_BW, 1e3 * flops / peak_flops


def bound_ms(kind, b, h, o, spatial, modes, elem_bytes, peak_flops,
             per_mode=False, ends=None):
    """Least time for one launch of `kind` on the card, the larger of
    ``bound_parts``; returns (ms, "bytes"|"operations")."""
    t_bytes, t_ops = bound_parts(kind, b, h, o, spatial, modes, elem_bytes,
                                 peak_flops, per_mode, ends)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def cgemm_bound_parts(m, k, n, elem_bytes, peak_flops):
    """(ms by bytes, ms by operations) of one (M,K)·(K,N) complex product:
    the A, B and C planes each moved once, 8 operations per complex
    multiply-add."""
    nbytes = elem_bytes * 2 * (m * k + k * n + m * n)
    return 1e3 * nbytes / hw.HBM_BW, 1e3 * 8 * m * k * n / peak_flops


def cgemm_bound(m, k, n, elem_bytes, peak_flops):
    """Least time of the complex product, the larger of
    ``cgemm_bound_parts``; returns (ms, "bytes"|"operations")."""
    t_bytes, t_ops = cgemm_bound_parts(m, k, n, elem_bytes, peak_flops)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
