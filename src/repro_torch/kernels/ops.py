"""Path dispatch for the FNO spectral layer and block (counterpart of
``repro/kernels/ops.py``):

  path="ref"    — ``torch.fft`` staged oracle          (reference "ref")
  path="staged" — truncated-DFT matmuls, one per stage (reference "xla")
  path="fused"  — the CUDA block kernel                (reference "pallas")

The oracles accumulate in f32 and never fuse. The fused path is the whole
FNO block in one kernel launch, forward only, shared weights only; the
kernel masks its own ragged edges, so nothing here pads.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PrecisionPolicy, torch_dtype
from repro_torch.core import spectral
from repro_torch.kernels import engine
from repro_torch.kernels import ref as ref_k

_F32 = torch.float32
PATHS = ("ref", "staged", "fused")


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


def _fnond_fused(x, wr, wi, wb, bias, modes, pol):
    """Launch the fused block kernel (operands already at the compute
    dtype); the bias is [O] here and [O,1] at the kernel."""
    mats = spectral.operand_tensors(tuple(x.shape[2:]), modes,
                                    pol.spectral_dtype, x.device)
    return engine.fused_block(x.contiguous(), wr.contiguous(),
                              wi.contiguous(), wb.contiguous(),
                              bias.reshape(-1, 1).contiguous(), mats)


def fno_block_nd(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                 wb: torch.Tensor, bias: torch.Tensor,
                 modes: Sequence[int], *, path: str = "fused",
                 policy: Optional[PrecisionPolicy] = None) -> torch.Tensor:
    """One whole FNO block: y = gelu(spectral(x) + x·W_bᵀ + bias).

    x: [B,H,s_1..s_R]; wr/wi: [O,H] (or [O,H,k_1..k_R] on the oracle
    paths); wb: [O,H] bypass (y_o += Σ_h x_h·wb[o,h]); bias: [O].
    path="fused" is ONE kernel launch (forward only); "ref"/"staged" are
    the staged parity oracles. The result is at the policy's compute dtype
    (x's dtype without a policy).
    """
    modes = _modes_key(modes)
    if path in ("ref", "staged"):
        return _fno_block_oracle(x, wr, wi, wb, bias, modes, path, policy)
    if path != "fused":
        raise ValueError(f"unknown path {path!r}; known: {PATHS}")
    if wr.ndim != 2:
        raise ValueError("the fused block kernel takes shared [O,H] "
                         "weights; per-mode weights are not ported yet")
    pol = policy or _default_policy(x)
    cp = torch_dtype(pol.compute_dtype)
    x, wr, wi, wb, bias = (a.to(cp) for a in (x, wr, wi, wb, bias))
    return _fnond_fused(x, wr, wi, wb, bias, modes, pol)
