"""``torch.fft`` oracle (counterpart of ``repro/kernels/ref.py``).

Built on ``torch.fft``, NOT the matmul formulation, so the kernel tests
exercise a genuinely independent path. It is also the paper's PyTorch
baseline: each stage materializes its output (cuFFT → copy → cuBLAS →
copy → cuFFT).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def ref_fnond(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
              modes: Tuple[int, ...]) -> torch.Tensor:
    """Staged rank-R FNO spectral layer, TurboFNO truncation convention.

    x: [B, H, s_1..s_R]; keeps the LOW corner ``[:k_1, …, :k_R]`` only,
    unlike classic FNO's ± corners. W: [O, H] or [O, H, k_1..k_R].
    Returns float32 [B, O, s_1..s_R].
    """
    r = len(modes)
    spatial = x.shape[2:]
    xf = torch.fft.rfft(x.to(torch.float32), dim=-1)[..., :modes[-1]]
    for j in range(r - 1):  # FFT along s_{R-1}, …, s_1 (axes in place)
        ax = -2 - j
        xf = torch.fft.fft(xf, dim=ax).narrow(ax, 0, modes[r - 2 - j])
    w = torch.complex(wr.to(torch.float32), wi.to(torch.float32))
    ms = "uvw"[:r]
    eq = (f"oh{ms},bh{ms}->bo{ms}" if w.ndim > 2
          else f"oh,bh{ms}->bo{ms}")
    yf = torch.einsum(eq, w, xf)
    pad = [0, spatial[-1] // 2 + 1 - modes[-1]]  # F.pad lists last dim first
    for n, k in reversed(list(zip(spatial[:-1], modes[:-1]))):
        pad += [0, n - k]
    yf = F.pad(yf, pad)
    for j in range(r - 1):  # inverse FFT along s_1, …, s_{R-1}
        yf = torch.fft.ifft(yf, n=spatial[j], dim=2 + j)
    return torch.fft.irfft(yf, n=spatial[-1], dim=-1).to(torch.float32)


# Standalone transforms along the last axis (the separate truncation and
# padding copies of the staged pipeline), each in float32.
def ref_truncated_rdft(x: torch.Tensor, modes: int):
    """rFFT along the last axis, then the slice of the first `modes` bins."""
    xf = torch.fft.rfft(x.to(torch.float32), dim=-1)[..., :modes]
    return xf.real.contiguous(), xf.imag.contiguous()


def ref_padded_irdft(xr: torch.Tensor, xi: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Zero-pad to n//2+1 bins, then irFFT to length n."""
    xf = torch.complex(xr.to(torch.float32), xi.to(torch.float32))
    xf = F.pad(xf, [0, n // 2 + 1 - xr.shape[-1]])
    return torch.fft.irfft(xf, n=n, dim=-1)


def ref_truncated_cdft(xr: torch.Tensor, xi: torch.Tensor, modes: int):
    """Complex FFT along the last axis, keeping the first `modes` bins."""
    xf = torch.fft.fft(torch.complex(xr.to(torch.float32),
                                     xi.to(torch.float32)), dim=-1)
    xf = xf[..., :modes]
    return xf.real.contiguous(), xf.imag.contiguous()


def ref_padded_icdft(xr: torch.Tensor, xi: torch.Tensor, n: int):
    """Zero-pad the first-`modes` bins to n, then the inverse complex FFT."""
    xf = torch.complex(xr.to(torch.float32), xi.to(torch.float32))
    out = torch.fft.ifft(F.pad(xf, [0, n - xr.shape[-1]]), n=n, dim=-1)
    return out.real.contiguous(), out.imag.contiguous()
