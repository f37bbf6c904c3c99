"""Path dispatch for the FNO spectral layer and block (counterpart of
``repro/kernels/ops.py``):

  path="ref"    — ``torch.fft`` staged oracle          (reference "ref")
  path="staged" — truncated-DFT matmuls, one per stage (reference "xla")
  path="fused"  — the CUDA kernels                    (reference "pallas")

The oracles accumulate in f32, never fuse, and differentiate through torch
autograd. The fused path is the whole FNO block, shared weights only, as a
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
both. The standalone transforms (``truncated_rdft`` …) run the row kernels
on the fused path. The kernels mask their own ragged edges, so nothing here
pads.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PrecisionPolicy, torch_dtype
from repro_torch.core import spectral
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
                      policy: Optional[PrecisionPolicy] = None
                      ) -> torch.Tensor:
    """The bare rank-R spectral layer on an oracle path ("ref"/"staged").
    x: [B,H,s_1..s_R]; w: [O,H] or [O,H,k_1..k_R]. Its fused kernel is not
    ported yet; on the fused path use the whole block (``fno_block_nd``).
    """
    modes = _modes_key(modes)
    if path == "ref":
        if policy is not None:  # oracle runs in f32, emits at compute dtype
            y32 = ref_k.ref_fnond(x.to(_F32), wr.to(_F32), wi.to(_F32),
                                  modes)
            return y32.to(torch_dtype(policy.compute_dtype))
        return ref_k.ref_fnond(x, wr, wi, modes)
    if path == "staged":
        return _fnond_staged(x, wr, wi, modes, policy)
    raise ValueError(f"spectral_layer_nd runs on 'ref' or 'staged', not "
                     f"{path!r}: the fused path fuses the whole block")


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


# ---------------------------------------------------------------------------
# Paper-faithful partial fusion
# ---------------------------------------------------------------------------
def _outer_fwd_batched(x, spatial, modes, operand_dtype=None):
    """All outer forward stages (axes s_2..s_R) in ONE row launch with the
    Kronecker-combined operand: x [B,H,s_1..s_R] real -> the pair
    [B,H,s_1,K_R..K_2]."""
    r = len(spatial)
    lead = tuple(x.shape[:3])
    mats = _row_mats("outer_fwd", tuple(spatial[1:]), tuple(modes[1:]), x,
                     operand_dtype)
    zr, zi = dft.rdft(x.contiguous().reshape(*lead, -1), *mats)
    shape = lead + tuple(modes[r - 1:0:-1])  # (K_R .. K_2)
    return zr.reshape(shape), zi.reshape(shape)


def _outer_inv_batched(tr, ti, spatial, operand_dtype=None):
    """All outer inverse stages in one row launch: the pair
    [B,O,s_1,K_R..K_2] -> real [B,O,s_1,s_2..s_R] through the combined
    padded inverse operand."""
    ok = tuple(tr.shape[3:][::-1])  # (K_R..K_2) -> (k_2..k_R)
    lead = tuple(tr.shape[:3])
    mats = _row_mats("outer_inv", tuple(spatial[1:]), ok, tr, operand_dtype)
    flat = lambda t: t.contiguous().reshape(*lead, -1)
    y = dft.irdft(flat(tr), flat(ti), *mats)
    return y.reshape(lead + tuple(spatial[1:]))


def _fnond_partial(x, wr, wi, modes, pol: PrecisionPolicy):
    """The spectral layer as the paper's partial fusion, at x's dtype (the
    compute dtype): the outer forward transforms as a standalone row launch
    (a single rDFT along s_2 at rank 2, one Kronecker-combined launch for
    s_2..s_R at rank 3), the fused core [cDFT_s1 → CGEMM → icDFT_s1], and
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
    # [B,K_R..K_2,O,s_1] -> [B,O,s_1,K_R..K_2]
    s = r - 1
    perm = (0, s + 1, s + 2) + tuple(range(1, s + 1))
    tr, ti = yr.permute(perm), yi.permute(perm)
    if r == 2:
        return padded_irdft(tr, ti, spatial[-1], operand_dtype=sd)
    return _outer_inv_batched(tr, ti, spatial, sd)


def _block_tail(s, x, wb, bias, out_dtype):
    """The staged block epilogue — bypass GEMM + bias + gelu on a spectral
    output s; z accumulates in f32, the single down-cast is the return."""
    byp = torch.einsum("oh,bh...->bo...", wb.to(x.dtype).to(_F32),
                       x.to(_F32))
    z = (s.to(_F32) + byp
         + bias.to(_F32).reshape((1, -1) + (1,) * (x.ndim - 2)))
    return F.gelu(z, approximate="tanh").to(out_dtype)


def _fno_block_oracle(x, wr, wi, wb, bias, modes, path, pol):
    """Staged parity oracle: spectral layer (ref/staged) + bypass + bias +
    gelu — the exact math the one-kernel fused path computes."""
    s = spectral_layer_nd(x, wr, wi, modes, path=path, policy=pol)
    cp = torch_dtype(pol.compute_dtype) if pol is not None else x.dtype
    return _block_tail(s, x.to(cp), wb, bias, s.dtype)


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


class _FusedBlock(torch.autograd.Function):
    """The fused FNO block with the reference's custom VJP
    (``ops._fno_block_vjp_fwd``/``_bwd``): forward is one block-kernel
    launch (variant "full") or the partial variant's three launches and the
    staged tail, and saves only the primals (never z); backward, for both,
    is three launches — gz = gy·gelu'(z) with z recomputed, dx through the
    adjoint pipeline with transposed weights, and dW, dW_b, dbias from the
    wgrad kernel. The compute-dtype casts live inside, so every grad comes
    back at its primal's dtype (f32 master params get f32 grads under
    bf16)."""

    @staticmethod
    def forward(ctx, x, wr, wi, wb, bias, modes, pol, variant):
        ctx.save_for_backward(x, wr, wi, wb, bias)
        ctx.modes, ctx.pol = modes, pol
        ops_ = _operands(x, wr, wi, wb, bias, pol)
        if variant == "full":
            return engine.fused_block(*ops_,
                                      _mats(ops_[0], modes, pol, "forward"))
        xc, wrc, wic, wbc, bc = ops_
        s = _fnond_partial(xc, wrc, wic, modes, pol)
        return _block_tail(s, xc, wbc, bc, xc.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, wr, wi, wb, bias = ctx.saved_tensors
        modes, pol = ctx.modes, ctx.pol
        xc, wrc, wic, wbc, bc = _operands(x, wr, wi, wb, bias, pol)
        # (1) recompute z through the forward kernel; its epilogue forms
        # gz = gy·gelu'(z), so z never reaches device memory.
        gz = engine.fused_block(xc, wrc, wic, wbc, bc,
                                _mats(xc, modes, pol, "forward"),
                                act="gelu_vjp", gy=_c(gy.to(xc.dtype)))
        # (2) dx = spectral_adjoint(gz) + wbᵀ·gz: the same kernel with the
        # adjoint operands, (out, hidden)-swapped weights, no bias, linear
        # epilogue, emitted at the primal dtype.
        dx = engine.fused_block(gz, _c(wrc.t()), _c(wic.t()), _c(wbc.t()),
                                None, _mats(xc, modes, pol, "adjoint"),
                                act="linear", out_dtype=x.dtype)
        # (3) dW, dW_b, dbias from one wgrad launch, in f32.
        dwr, dwi, dwb, db = engine.fused_wgrad(
            xc, gz, _mats(xc, modes, pol, "wgrad"))
        return (dx, dwr.to(wr.dtype), dwi.to(wi.dtype), dwb.to(wb.dtype),
                db.reshape(bias.shape).to(bias.dtype), None, None, None)


def fno_block_nd(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                 wb: torch.Tensor, bias: torch.Tensor,
                 modes: Sequence[int], *, path: str = "fused",
                 variant: str = "full",
                 policy: Optional[PrecisionPolicy] = None) -> torch.Tensor:
    """One whole FNO block: y = gelu(spectral(x) + x·W_bᵀ + bias).

    x: [B,H,s_1..s_R]; wr/wi: [O,H] (or [O,H,k_1..k_R] on the oracle
    paths); wb: [O,H] bypass (y_o += Σ_h x_h·wb[o,h]); bias: [O].
    path="fused" runs ``_FusedBlock``: with variant="full" ONE kernel launch
    forward, with "partial" the paper's partial fusion (rdft → core →
    irdft launches and the staged tail; rank 1: the bare spectral layer
    and the tail), and three launches backward for both; "ref"/"staged"
    are the staged parity oracles (partial and full are one function). The
    result is at the policy's compute dtype (x's dtype without a policy).
    """
    modes = _modes_key(modes)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    if path in ("ref", "staged"):
        return _fno_block_oracle(x, wr, wi, wb, bias, modes, path, policy)
    if path != "fused":
        raise ValueError(f"unknown path {path!r}; known: {PATHS}")
    if wr.ndim != 2:
        raise ValueError("the fused block kernel takes shared [O,H] "
                         "weights; per-mode weights are not ported yet")
    return _FusedBlock.apply(x, wr, wi, wb, bias, modes,
                             policy or _default_policy(x), variant)
