"""Path dispatch for the FNO spectral layer and block (counterpart of
``repro/kernels/ops.py``):

  path="ref"    — ``torch.fft`` staged oracle          (reference "ref")
  path="staged" — truncated-DFT matmuls, one per stage (reference "xla")
  path="fused"  — the CUDA kernels                    (reference "pallas")

The oracles accumulate in f32, never fuse, and differentiate through torch
autograd. On the fused path, the bare spectral layer
(``spectral_layer_nd``, the paper's FFT→CGEMM→iFFT fusion; the model runs
it with ``fuse_block`` off) is a ``torch.autograd.Function`` with one
forward launch (variant "full") or the partial variant's three, and two
backward launches: dx through the same kernel in adjoint mode, and the
bypass-free wgrad. The whole FNO block, with shared [O,H] or per-mode
[O,H,k_1..k_R] spectral weights, is another
``torch.autograd.Function`` with the reference's launch structure:

  variant="full"    one block-kernel launch forward;
  variant="partial" the paper's partial fusion (TurboFNO §4.3): a
                    truncated-rDFT row launch over the outer axes s_2..s_R,
                    the fused core cDFT_s1 → CGEMM → icDFT_s1, a padded
                    irDFT row launch, then the block tail (bypass, bias,
                    gelu) in PyTorch; rank 1 has no outer axes and runs the
                    bare spectral layer kernel before the tail;

and three launches backward for both (gz recompute, dx adjoint, fused
wgrad): partial and full compute the same function, so one adjoint serves
both. The linear block (``act="linear"``, the TP-sharded block's partial
pre-activation) has no gz recompute: two launches backward. A model's
first and last block with its end MLPs folded in (``fno_block_ends_nd``,
``cfg.fuse_ends``) is one launch forward; its backward is autograd of the
staged composition, recomputed, as the reference's. The standalone
transforms (``truncated_rdft`` …) and ``cgemm`` run their kernels on the
fused path. The kernels mask their own ragged edges, so nothing here
pads.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PrecisionPolicy, torch_dtype
from repro_torch.core import spectral
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import cgemm as cgemm_k
from repro_torch.kernels import dft, engine
from repro_torch.kernels import ref as ref_k

_F32 = torch.float32
PATHS = ("ref", "staged", "fused")
VARIANTS = ("full", "partial")


def _modes_key(modes) -> Tuple[int, ...]:
    return tuple(int(m) for m in modes)


def _default_policy(x: torch.Tensor) -> PrecisionPolicy:
    """Uniform policy at x's dtype (f32 accumulation)."""
    name = str(x.dtype).removeprefix("torch.")
    return PrecisionPolicy(param_dtype=name, compute_dtype=name,
                           spectral_dtype=name)


def _fnond_staged(x, wr, wi, modes, pol: Optional[PrecisionPolicy] = None):
    """Staged matmul formulation of the rank-R spectral layer.

    With a policy, operands are cast to the compute dtype first and the
    result is emitted at it; the stages accumulate in f32."""
    if pol is not None:
        cp = torch_dtype(pol.compute_dtype)
        x, wr, wi = x.to(cp), wr.to(cp), wi.to(cp)
    r = len(modes)
    spatial = x.shape[2:]
    per_mode = wr.ndim == 2 + r
    zr, zi = spectral.truncated_rdft(x, modes[-1])
    for j in range(1, r):  # cDFT along s_{R-1}…s_1 -> [B,H,K_R..K_1]
        zr = torch.movedim(zr, -(j + 1), -1)
        zi = torch.movedim(zi, -(j + 1), -1)
        zr, zi = spectral.truncated_cdft(zr, zi, modes[r - 1 - j])
    fwd = "uvw"[:r]           # K_1..K_R (the weight layout order)
    rev = fwd[::-1]           # K_R..K_1 (the spectrum layout order)
    eq = (f"oh{fwd},bh{rev}->bo{rev}" if per_mode
          else f"oh,bh{rev}->bo{rev}")
    w_r, w_i = wr.to(_F32), wi.to(_F32)
    yr = torch.einsum(eq, w_r, zr) - torch.einsum(eq, w_i, zi)
    yi = torch.einsum(eq, w_r, zi) + torch.einsum(eq, w_i, zr)
    for j in range(r - 1):  # icDFT along s_1…s_{R-1}
        yr, yi = spectral.padded_icdft(yr, yi, spatial[j])
        yr = torch.movedim(yr, -1, 2 + j)
        yi = torch.movedim(yi, -1, 2 + j)
    y = spectral.padded_irdft(yr, yi, spatial[-1])
    return y.to(x.dtype) if pol is not None else y


def spectral_layer_nd(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                      modes: Sequence[int], *, path: str = "staged",
                      variant: str = "full",
                      policy: Optional[PrecisionPolicy] = None
                      ) -> torch.Tensor:
    """The bare rank-R spectral layer y = Re iDFT(Σ_h DFT(x_h)·W[o,h(,k)]).

    x: [B,H,s_1..s_R]; w: [O,H] or [O,H,k_1..k_R]. path="fused" runs
    ``_SpectralLayer``: with variant="full" ONE kernel launch forward, with
    "partial" the paper's partial fusion (rdft → core → irdft; rank 1: the
    one launch), and two launches backward for both (dx through the
    adjoint, the bypass-free wgrad). "ref"/"staged" are the oracles
    (partial and full are one function). The result is at the policy's
    compute dtype (x's dtype without a policy; f32 on "ref" without one).
    """
    modes = _modes_key(modes)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    if path == "ref":
        if policy is not None:  # oracle runs in f32, emits at compute dtype
            y32 = ref_k.ref_fnond(x.to(_F32), wr.to(_F32), wi.to(_F32),
                                  modes)
            return y32.to(torch_dtype(policy.compute_dtype))
        return ref_k.ref_fnond(x, wr, wi, modes)
    if path == "staged":
        return _fnond_staged(x, wr, wi, modes, policy)
    _check_path(path)
    return _SpectralLayer.apply(x, wr, wi, modes,
                                policy or _default_policy(x), variant)


def spectral_layer_1d(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                      modes: int, *, path: str = "fused",
                      policy: Optional[PrecisionPolicy] = None
                      ) -> torch.Tensor:
    """Rank-1 spectral layer, x [B,H,N], w [O,H] or [O,H,modes]: one
    launch forward (rank 1 has no partial variant)."""
    _check_rank("spectral_layer_1d", x, 1)
    return spectral_layer_nd(x, wr, wi, (modes,), path=path, policy=policy)


def spectral_layer_2d(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                      modes: Tuple[int, int], *, path: str = "fused",
                      variant: str = "full",
                      policy: Optional[PrecisionPolicy] = None
                      ) -> torch.Tensor:
    """Rank-2 spectral layer, x [B,H,X,Y], w [O,H] or [O,H,kx,ky]."""
    _check_rank("spectral_layer_2d", x, 2)
    return spectral_layer_nd(x, wr, wi, modes, path=path, variant=variant,
                             policy=policy)


def spectral_layer_3d(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                      modes: Tuple[int, int, int], *, path: str = "fused",
                      variant: str = "full",
                      policy: Optional[PrecisionPolicy] = None
                      ) -> torch.Tensor:
    """Rank-3 spectral layer, x [B,H,X,Y,Z], w [O,H] or [O,H,kx,ky,kz]."""
    _check_rank("spectral_layer_3d", x, 3)
    return spectral_layer_nd(x, wr, wi, modes, path=path, variant=variant,
                             policy=policy)


def _check_rank(what, x, rank):
    if x.ndim != 2 + rank:
        raise ValueError(f"{what} takes x [B,H] + {rank} spatial axes, got "
                         f"shape {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# Standalone truncated-DFT transforms along the last axis (paper §3.3): the
# row kernels on the fused path, at the input's dtype (operand_dtype, the
# policy's spectral dtype on the partial path, must equal it there).
# ---------------------------------------------------------------------------
def _row_mats(kind, spatial, modes, like, operand_dtype):
    dt = operand_dtype or str(like.dtype).removeprefix("torch.")
    return spectral.row_operand_tensors(kind, spatial, modes, dt,
                                        like.device)


def _check_path(path):
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; known: {PATHS}")


def truncated_rdft(x: torch.Tensor, modes: int, *, path: str = "fused",
                   operand_dtype: Optional[str] = None):
    """rFFT along the last axis keeping `modes` bins: x [..., N] -> pair."""
    _check_path(path)
    if path == "ref":
        return ref_k.ref_truncated_rdft(x, modes)
    if path == "staged":
        return spectral.truncated_rdft(x, modes)
    mats = _row_mats("rdft", (x.shape[-1],), (modes,), x, operand_dtype)
    return dft.rdft(x.contiguous(), *mats)


def padded_irdft(xr: torch.Tensor, xi: torch.Tensor, n: int, *,
                 path: str = "fused",
                 operand_dtype: Optional[str] = None) -> torch.Tensor:
    """Inverse rFFT from the kept bins, zero-padded to length n."""
    _check_path(path)
    if path == "ref":
        return ref_k.ref_padded_irdft(xr, xi, n)
    if path == "staged":
        return spectral.padded_irdft(xr, xi, n)
    mats = _row_mats("irdft", (n,), (xr.shape[-1],), xr, operand_dtype)
    return dft.irdft(xr.contiguous(), xi.contiguous(), *mats)


def truncated_cdft(xr: torch.Tensor, xi: torch.Tensor, modes: int, *,
                   path: str = "fused",
                   operand_dtype: Optional[str] = None):
    """Complex DFT along the last axis keeping the first `modes` bins."""
    _check_path(path)
    if path == "ref":
        return ref_k.ref_truncated_cdft(xr, xi, modes)
    if path == "staged":
        return spectral.truncated_cdft(xr, xi, modes)
    mats = _row_mats("cdft", (xr.shape[-1],), (modes,), xr, operand_dtype)
    return dft.cdft(xr.contiguous(), xi.contiguous(), *mats)


def padded_icdft(xr: torch.Tensor, xi: torch.Tensor, n: int, *,
                 path: str = "fused", operand_dtype: Optional[str] = None):
    """Inverse complex DFT from the first-`modes` bins zero-padded to n."""
    _check_path(path)
    if path == "ref":
        return ref_k.ref_padded_icdft(xr, xi, n)
    if path == "staged":
        return spectral.padded_icdft(xr, xi, n)
    mats = _row_mats("icdft", (n,), (xr.shape[-1],), xr, operand_dtype)
    return dft.cdft(xr.contiguous(), xi.contiguous(), *mats)


def cgemm(ar: torch.Tensor, ai: torch.Tensor, br: torch.Tensor,
          bi: torch.Tensor, *, path: str = "fused"
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M,K)x(K,N) complex matmul of (re, im) planes. "ref"/"staged": the
    four f32 products; "fused": the CGEMM kernel (the plain version on a
    CPU tensor), emitted at ar's dtype."""
    _check_path(path)
    if path in ("ref", "staged"):
        return ref_k.ref_cgemm(ar, ai, br, bi)
    return cgemm_k.cgemm(*(t.contiguous() for t in (ar, ai, br, bi)))


# ---------------------------------------------------------------------------
# Paper-faithful partial fusion
# ---------------------------------------------------------------------------
def _outer_fwd_batched(x, spatial, modes, operand_dtype=None):
    """Both outer forward stages (axes s_2, s_3) in ONE row launch with the
    per-axis factors: x [B,H,s_1,s_2,s_3] real -> the pair
    [B,H,s_1,K_3,K_2]."""
    _check_outer_rank(spatial)
    f2 = _row_mats("cdft", spatial[1:2], modes[1:2], x, operand_dtype)
    f3 = _row_mats("cdft", spatial[2:], modes[2:], x, operand_dtype)
    return dft.outer_rdft(x.contiguous(), f2, f3)


def _outer_inv_batched(tr, ti, spatial, operand_dtype=None):
    """Both outer inverse stages in one row launch: the pair
    [B,O,s_1,K_3,K_2] -> real [B,O,s_1,s_2,s_3] through the padded complex
    inverse of s_2 and the hermitian-folded real inverse of s_3."""
    _check_outer_rank(spatial)
    k3, k2 = tr.shape[3:]
    e2 = _row_mats("icdft", spatial[1:2], (k2,), tr, operand_dtype)
    e3 = _row_mats("irdft", spatial[2:], (k3,), tr, operand_dtype)
    return dft.outer_irdft(tr.contiguous(), ti.contiguous(), e2, e3)


def _check_outer_rank(spatial):
    if len(spatial) != 3:
        raise ValueError(f"the outer row kernels take the two outer axes of "
                         f"a rank-3 field, got spatial {tuple(spatial)}")


def _fnond_partial(x, wr, wi, modes, pol: PrecisionPolicy):
    """The spectral layer as the paper's partial fusion, at x's dtype (the
    compute dtype): the outer forward transforms as a standalone row launch
    (a single rDFT along s_2 at rank 2, both outer axes s_2, s_3 in one
    launch at rank 3), the fused core [cDFT_s1 → CGEMM → icDFT_s1], and
    the mirrored inverse row launch. Rank 1 has no outer stages: the bare
    spectral layer in one block-kernel launch. Operands are at the policy's
    spectral dtype, detached and contiguous."""
    r = len(modes)
    spatial = tuple(x.shape[2:])
    mats = _mats(x, modes, pol, "forward")
    if r == 1:
        return engine.fused_block(x, wr, wi, None, None, mats, act="linear")
    sd = pol.spectral_dtype
    if r == 2:
        zr, zi = truncated_rdft(x, modes[-1], operand_dtype=sd)
    else:
        zr, zi = _outer_fwd_batched(x, spatial, modes, sd)
    # The core's operands: forward cDFT along s_1 (forward stage R-1) and
    # inverse cDFT along s_1 (inverse stage 0) of the block bundle.
    yr, yi = engine.fused_core(zr, zi, wr, wi, *mats[2 * r - 2:2 * r + 2])
    # [B,K_R..K_2,O,s_1] -> [B,O,s_1,K_R..K_2], with per-mode weights too:
    # the port's core keeps the shared layout where the reference's
    # per-mode kernel emits [K_R..K_2,B,O,s_1].
    s = r - 1
    perm = (0, s + 1, s + 2) + tuple(range(1, s + 1))
    tr, ti = yr.permute(perm), yi.permute(perm)
    if r == 2:
        return padded_irdft(tr, ti, spatial[-1], operand_dtype=sd)
    return _outer_inv_batched(tr, ti, spatial, sd)


def _block_tail(s, x, wb, bias, out_dtype, act="gelu"):
    """The staged block epilogue — bypass GEMM + bias + the activation
    (gelu, or none for act="linear") on a spectral output s; z accumulates
    in f32, the single down-cast is the return."""
    byp = torch.einsum("oh,bh...->bo...", wb.to(x.dtype).to(_F32),
                       x.to(_F32))
    z = (s.to(_F32) + byp
         + bias.to(_F32).reshape((1, -1) + (1,) * (x.ndim - 2)))
    if act == "gelu":
        z = F.gelu(z, approximate="tanh")
    return z.to(out_dtype)


def _fno_block_oracle(x, wr, wi, wb, bias, modes, path, pol, act="gelu"):
    """Staged parity oracle: spectral layer (ref/staged) + bypass + bias +
    activation — the exact math the one-kernel fused path computes."""
    s = spectral_layer_nd(x, wr, wi, modes, path=path, policy=pol)
    cp = torch_dtype(pol.compute_dtype) if pol is not None else x.dtype
    return _block_tail(s, x.to(cp), wb, bias, s.dtype, act)


def _mats(x, modes, pol, kind):
    return spectral.operand_tensors(tuple(x.shape[2:]), modes,
                                    pol.spectral_dtype, x.device, kind)


def _c(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous()


def _operands(x, wr, wi, wb, bias, pol):
    """The block's operands at the compute dtype, detached and contiguous;
    the bias is [O] here and [O,1] at the kernel."""
    cp = torch_dtype(pol.compute_dtype)
    return tuple(_c(a.to(cp)) for a in (x, wr, wi, wb, bias.reshape(-1, 1)))


class _SpectralLayer(torch.autograd.Function):
    """The bare spectral layer with the reference's custom VJP
    (``ops._spectral_layer_nd_pallas``, ``_fnond_vjp_fwd``/``_bwd``):
    forward is one bare block-kernel launch (variant "full") or the
    partial variant's three launches, and saves only the primals;
    backward, for both (they compute one linear map), is two launches —
    dx through the same kernel with the adjoint bundle and the weights'
    transposed view, emitted at the primal dtype, and dW from the wgrad
    kernel without its bypass phase, in f32, cast to the param dtype (per
    mode, in the parameter layout, for per-mode weights). Operands run at
    the compute dtype."""

    @staticmethod
    def forward(ctx, x, wr, wi, modes, pol, variant):
        ctx.save_for_backward(x, wr, wi)
        ctx.modes, ctx.pol = modes, pol
        cp = torch_dtype(pol.compute_dtype)
        xc, wrc, wic = (_c(a.to(cp)) for a in (x, wr, wi))
        if variant == "full":
            return engine.fused_block(xc, wrc, wic, None, None,
                                      _mats(xc, modes, pol, "forward"),
                                      act="linear")
        return _fnond_partial(xc, wrc, wic, modes, pol)

    @staticmethod
    def backward(ctx, gy):
        x, wr, wi = ctx.saved_tensors
        modes, pol = ctx.modes, ctx.pol
        cp = torch_dtype(pol.compute_dtype)
        xc, wrc, wic, gyc = (_c(a.to(cp)) for a in (x, wr, wi, gy))
        # dx = spectral_adjoint(gy): the bare kernel with the adjoint
        # bundle and (out, hidden)-swapped weights, read as a view.
        dx = engine.fused_block(gyc, wrc.transpose(0, 1),
                                wic.transpose(0, 1), None, None,
                                _mats(xc, modes, pol, "adjoint"),
                                act="linear", out_dtype=x.dtype,
                                adjoint=True)
        dwr, dwi = engine.fused_wgrad(xc, gyc, _mats(xc, modes, pol, "wgrad"),
                                      per_mode=wr.ndim > 2,
                                      with_bypass=False)
        return dx, dwr.to(wr.dtype), dwi.to(wi.dtype), None, None, None


class _FusedBlock(torch.autograd.Function):
    """The fused FNO block with the reference's custom VJP
    (``ops._fno_block_vjp_fwd``/``_bwd``): forward is one block-kernel
    launch (variant "full") or the partial variant's three launches and the
    staged tail, and saves only the primals (never z); backward, for both,
    is three launches — gz = gy·gelu'(z) with z recomputed, dx through the
    adjoint pipeline with transposed weights, and dW, dW_b, dbias from the
    wgrad kernel. With act="linear" (the TP-partial block: no activation,
    emitted at `out_dtype`) z is the output, so gz is gy and the backward
    is the last two launches. The compute-dtype casts live inside, so
    every grad comes back at its primal's dtype (f32 master params get
    f32 grads under bf16)."""

    @staticmethod
    def forward(ctx, x, wr, wi, wb, bias, modes, pol, variant, act,
                out_dtype):
        ctx.save_for_backward(x, wr, wi, wb, bias)
        ctx.modes, ctx.pol, ctx.act = modes, pol, act
        ops_ = _operands(x, wr, wi, wb, bias, pol)
        if variant == "full":
            return engine.fused_block(*ops_,
                                      _mats(ops_[0], modes, pol, "forward"),
                                      act=act, out_dtype=out_dtype)
        xc, wrc, wic, wbc, bc = ops_
        s = _fnond_partial(xc, wrc, wic, modes, pol)
        return _block_tail(s, xc, wbc, bc, out_dtype or xc.dtype, act)

    @staticmethod
    def backward(ctx, gy):
        x, wr, wi, wb, bias = ctx.saved_tensors
        modes, pol = ctx.modes, ctx.pol
        xc, wrc, wic, wbc, bc = _operands(x, wr, wi, wb, bias, pol)
        if ctx.act == "linear":  # z is the output: gz = gy, no recompute
            gz = _c(gy.to(xc.dtype))
        else:
            # (1) recompute z through the forward kernel; its epilogue
            # forms gz = gy·gelu'(z), so z never reaches device memory.
            gz = engine.fused_block(xc, wrc, wic, wbc, bc,
                                    _mats(xc, modes, pol, "forward"),
                                    act="gelu_vjp", gy=_c(gy.to(xc.dtype)))
        # (2) dx = spectral_adjoint(gz) + wbᵀ·gz: the same kernel with the
        # adjoint operands, (out, hidden)-swapped weights, no bias, linear
        # epilogue, emitted at the primal dtype. Axes 0 and 1 swap, without
        # conjugation, as the reference swaps them: a transposed view,
        # which the kernel reads through its strides (no 134 MB copy of
        # fno2d-large's per-mode W).
        dx = engine.fused_block(gz, wrc.transpose(0, 1),
                                wic.transpose(0, 1), _c(wbc.t()), None,
                                _mats(xc, modes, pol, "adjoint"),
                                act="linear", out_dtype=x.dtype,
                                adjoint=True)
        # (3) dW (per mode, in the parameter layout, for per-mode weights),
        # dW_b, dbias from one wgrad launch, in f32.
        dwr, dwi, dwb, db = engine.fused_wgrad(
            xc, gz, _mats(xc, modes, pol, "wgrad"), per_mode=wr.ndim > 2)
        return (dx, dwr.to(wr.dtype), dwi.to(wi.dtype), dwb.to(wb.dtype),
                db.reshape(bias.shape).to(bias.dtype), None, None, None,
                None, None)


class _AddBias(torch.autograd.Function):
    """y [B, C, *sp] + bias [C] cast to y's dtype. The reference broadcasts
    the bias BEFORE that cast, so the cast's backward upcasts the cotangent
    and the bias grad is summed over batch and space in f32 (a bf16 sum
    over a coherent cotangent field swamps). This gives that grad without
    a broadcast copy of the bias in the forward."""

    @staticmethod
    def forward(ctx, y, b):
        ctx.b_dtype = b.dtype
        return y + b.to(y.dtype).reshape((1, -1) + (1,) * (y.ndim - 2))

    @staticmethod
    def backward(ctx, g):
        dims = (0,) + tuple(range(2, g.ndim))
        return g, g.sum(dim=dims, dtype=torch.float32).to(ctx.b_dtype)


def pointwise(w: torch.Tensor, b: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Channel-pointwise dense layer of x [B, C, *sp] with w [C, D] and
    b [D] (``core.fno._dense``): follows x's dtype, the bias grad summed in
    f32."""
    y = torch.einsum("bc...,cd->bd...", x, w.to(x.dtype))
    return _AddBias.apply(y, b)


def fno_block_nd(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                 wb: torch.Tensor, bias: torch.Tensor,
                 modes: Sequence[int], *, path: str = "fused",
                 variant: str = "full",
                 policy: Optional[PrecisionPolicy] = None,
                 act: str = "gelu",
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One whole FNO block: y = act(spectral(x) + x·W_bᵀ + bias).

    x: [B,H,s_1..s_R]; wr/wi: shared [O,H] or per-mode [O,H,k_1..k_R];
    wb: [O,H] bypass (y_o += Σ_h x_h·wb[o,h]); bias: [O].
    path="fused" runs ``_FusedBlock``: with variant="full" ONE kernel launch
    forward, with "partial" the paper's partial fusion (rdft → core →
    irdft launches and the staged tail; rank 1: the bare spectral layer
    and the tail), and three launches backward for both; "ref"/"staged"
    are the staged parity oracles (partial and full are one function). The
    result is at the policy's compute dtype (x's dtype without a policy).

    act: "gelu" (the standard block) or "linear" (the pre-activation only:
    the TP-sharded block's partial, reduced over shards before the
    nonlinearity; its backward skips the gz recompute, two launches).
    out_dtype (fused path only) overrides the emitted dtype: the TP
    partial is emitted at the accumulator dtype, f32 under bf16.
    """
    modes = _modes_key(modes)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    if act not in ("gelu", "linear"):
        raise ValueError(f"act must be 'gelu' or 'linear', got {act!r}")
    if path in ("ref", "staged"):
        return _fno_block_oracle(x, wr, wi, wb, bias, modes, path, policy,
                                 act)
    if path != "fused":
        raise ValueError(f"unknown path {path!r}; known: {PATHS}")
    return _FusedBlock.apply(x, wr, wi, wb, bias, modes,
                             policy or _default_policy(x), variant, act,
                             out_dtype)


# ---------------------------------------------------------------------------
# The model's ends folded into the first and last block (cfg.fuse_ends):
# the lifting MLP runs inside the first block's launch and the projection
# MLP inside the last one's, so the lifted and projected activations never
# reach device memory. Forward is ONE launch; the backward is autograd of
# the staged composition, recomputed (the reference's ``_ends_vjp_bwd``):
# the reference has no backward kernel for the ends, and none is added.
# ---------------------------------------------------------------------------
def _ends_staged(x, wr, wi, wb, bias, lift, proj, modes, path, pol):
    """Staged lift → block → projection: the parity oracle of the
    ends-fused launch and its backward's recompute target. lift and proj
    are the model's (w, b, w, b) dense params or None."""
    h = x
    if lift is not None:
        l1w, l1b, l2w, l2b = lift
        h = pointwise(l2w, l2b, F.gelu(pointwise(l1w, l1b, h),
                                       approximate="tanh"))
    z = _fno_block_oracle(h, wr, wi, wb, bias, modes, path, pol, "gelu")
    if proj is not None:
        p1w, p1b, p2w, p2b = proj
        z = pointwise(p2w, p2b, F.gelu(pointwise(p1w, p1b, z),
                                       approximate="tanh"))
    return z


def _engine_end(end, cp):
    """A model end's (w1 [A,B], b1 [B], w2 [B,C], b2 [C]) in the kernel's
    layout at the compute dtype: (w1ᵀ [B,A], b1 [B,1], w2ᵀ [C,B],
    b2 [C,1])."""
    if end is None:
        return None
    w1, b1, w2, b2 = (t.detach().to(cp) for t in end)
    return (w1.t().contiguous(), b1.reshape(-1, 1).contiguous(),
            w2.t().contiguous(), b2.reshape(-1, 1).contiguous())


class _FusedEnds(torch.autograd.Function):
    """The block with the model's end MLPs folded in (the reference's
    ``_fno_block_ends_pallas``): forward is one "block_ends" launch and
    saves only the primals; backward recomputes the staged composition
    (``path="staged"``) and differentiates it with autograd, so it
    launches no kernel and every grad lands at its primal's dtype. The end
    params come as eight tensors (None where an end is absent)."""

    @staticmethod
    def forward(ctx, x, wr, wi, wb, bias, modes, pol, *ends):
        ctx.save_for_backward(x, wr, wi, wb, bias, *(
            t if t is not None else torch.empty(0) for t in ends))
        ctx.has = (ends[0] is not None, ends[4] is not None)
        ctx.modes, ctx.pol = modes, pol
        cp = torch_dtype(pol.compute_dtype)
        ops_ = _operands(x, wr, wi, wb, bias, pol)
        lift = None if ends[0] is None else ends[:4]
        proj = None if ends[4] is None else ends[4:]
        return engine.fused_block(*ops_,
                                  _mats(ops_[0], modes, pol, "forward"),
                                  lift=_engine_end(lift, cp),
                                  proj=_engine_end(proj, cp))

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        idx = [i for i in range(len(saved))
               if need[i if i < 5 else i + 2]]
        leaves = [t.detach().requires_grad_(i in idx)
                  for i, t in enumerate(saved)]
        lift = tuple(leaves[5:9]) if ctx.has[0] else None
        proj = tuple(leaves[9:13]) if ctx.has[1] else None
        with torch.enable_grad():
            y = _ends_staged(*leaves[:5], lift, proj, ctx.modes, "staged",
                             ctx.pol)
            got = torch.autograd.grad(
                y, [leaves[i] for i in idx],
                gy.to(torch_dtype(ctx.pol.compute_dtype)))
        grads = [None] * len(saved)
        for i, g in zip(idx, got):
            grads[i] = g
        return (*grads[:5], None, None, *grads[5:])


def fno_block_ends_nd(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                      wb: torch.Tensor, bias: torch.Tensor,
                      modes: Sequence[int], *,
                      lift: Optional[Tuple[torch.Tensor, ...]] = None,
                      proj: Optional[Tuple[torch.Tensor, ...]] = None,
                      path: str = "fused", variant: str = "full",
                      policy: Optional[PrecisionPolicy] = None
                      ) -> torch.Tensor:
    """``fno_block_nd`` with the model's end MLPs folded into the launch.

    lift = (l1w [C_in,L], l1b [L], l2w [L,H], l2b [H]), the model's
    lift1/lift2 params: x is then the RAW input [B,C_in,s…].
    proj = (p1w [H,Lp], p1b [Lp], p2w [Lp,C_out], p2b [C_out]), its
    proj1/proj2: the result is the model's output [B,C_out,s…]. Either may
    be None (the first or last block of a deeper model); both on a
    1-layer model. path="fused" runs ONE kernel launch forward (variant
    "full" only; "partial" raises) and differentiates through the staged
    composition; "ref"/"staged" are that composition.
    """
    modes = _modes_key(modes)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    if path in ("ref", "staged"):
        return _ends_staged(x, wr, wi, wb, bias, lift, proj, modes, path,
                            policy)
    if path != "fused":
        raise ValueError(f"unknown path {path!r}; known: {PATHS}")
    if variant != "full":
        raise ValueError("fused ends need the full-fusion variant (the "
                         "partial variant's blocks stay staged at the ends)")
    if lift is None and proj is None:
        raise ValueError("fno_block_ends_nd takes lift, proj or both; "
                         "without either use fno_block_nd")
    ends = tuple(lift or (None,) * 4) + tuple(proj or (None,) * 4)
    return _FusedEnds.apply(x, wr, wi, wb, bias, modes,
                            policy or _default_policy(x), *ends)


# ---------------------------------------------------------------------------
# The block on a DP×TP mesh (the reference's shard_map dispatch).
#
# DP: each rank holds its rows of the batch and runs the local block (with
# the model's ends where asked). TP: each rank holds its slice of the hidden
# axis — the k-loop contraction — of x, W and W_b, and runs the linear
# block (``act="linear"``, a zero bias, emitted at the accumulator dtype) to
# a partial pre-activation, completed over the model axis by
#
#   tp_layout="scatter": a reduce-scatter that leaves rank i chunk i of the
#     out channels, the next layer's hidden shard ((tp-1)/tp of the tensor
#     on the wire per rank); with tp_overlap the same sum as a ring of tp-1
#     point-to-point hops. Falls back to "psum" where tp does not divide O.
#   tp_layout="psum": an all-reduce (2(tp-1)/tp), replicated output. The
#     model's last layer always takes it: the projection reads all of
#     hidden.
#
# Bias (this rank's slice under "scatter") and GELU apply after the sum, in
# f32, and the one cast to the compute dtype is the return.
# ---------------------------------------------------------------------------
def fno_block_nd_sharded(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                         wb: torch.Tensor, bias: torch.Tensor,
                         modes: Sequence[int], *, ctx, variant: str = "full",
                         policy: Optional[PrecisionPolicy] = None,
                         act: str = "gelu", tp_layout: str = "psum",
                         tp_overlap: bool = False,
                         ends: Optional[Tuple] = None) -> torch.Tensor:
    """``fno_block_nd`` on the mesh of `ctx` (a multi-rank
    ``distributed.sharding.ShardingContext``); x holds this rank's rows.

    Without TP: the local ``fno_block_nd`` (``fno_block_ends_nd`` with
    `ends`, pure DP only). With TP: wr/wi/wb are this rank's hidden slices
    [O, H/tp(, k…)]; x is the full hidden [B, H, …] (its slice is taken
    here, the gradient all-gathered) or already this rank's slice
    [B, H/tp, …]; the result is [B, O/tp, …] under the scattered layout,
    else [B, O, …]. Differentiable: each rank's backward runs the block's
    dx and wgrad launches on its slice, and the collectives transpose
    (``sharding``)."""
    if tp_layout not in ("psum", "scatter"):
        raise ValueError(f"tp_layout must be 'psum' or 'scatter', got "
                         f"{tp_layout!r}")
    pol = policy or _default_policy(x)
    if ctx.model_axis is None:
        if ends is not None and any(e is not None for e in ends):
            return fno_block_ends_nd(x, wr, wi, wb, bias, modes,
                                     lift=ends[0], proj=ends[1],
                                     variant=variant, policy=pol)
        return fno_block_nd(x, wr, wi, wb, bias, modes, variant=variant,
                            policy=pol, act=act)
    if ends is not None and any(e is not None for e in ends):
        raise ValueError("the model's ends fold into the block only without "
                         "TP; under TP they run as sharded MLPs")
    mesh, m, tp = ctx.mesh, ctx.model_axis, ctx.tp
    if x.shape[1] != wr.shape[1]:
        x = shd.split(x, mesh, m, 1)
    o = wr.shape[0]
    acc = torch_dtype(pol.accum_dtype)
    z = fno_block_nd(x, wr, wi, wb, torch.zeros_like(bias), modes,
                     variant=variant, policy=pol, act="linear",
                     out_dtype=acc)
    if tp_layout == "scatter" and o % tp == 0:
        z = (shd.ring_scatter_sum if tp_overlap else shd.scatter_sum)(
            z, mesh, m, 1)
        bias = shd.split(bias, mesh, m, 0)
    else:
        z = shd.psum(z, mesh, m)
    z = z + bias.to(acc).reshape((1, -1) + (1,) * (z.ndim - 2))
    if act == "gelu":
        z = F.gelu(z, approximate="tanh")
    return z.to(torch_dtype(pol.compute_dtype))
