"""Synthetic PDE data in torch (counterpart of ``repro/data/pde.py``).

* Burgers 1D:  u_t + u·u_x = ν·u_xx, periodic, spectral RK4 integrator.
* Darcy 2D:   -∇·(a(x)∇u) = f on the unit square, u=0 on ∂Ω; piecewise-
  constant a from a thresholded GRF; Jacobi-free CG on a finite-difference
  stencil with a fixed iteration count.
* Diffusion 3D: u_t = ν·Δu + r·u on the periodic unit cube, exact in
  Fourier space.

Every generator is factored in two: ``grf_*_from_normals`` takes its
standard-normal draws as arguments (so a test can feed the reference's own
draws), and ``grf_*`` draws them from an explicit ``torch.Generator`` on
the CPU. Batch i of a run is a pure function of (seed, i); torch and JAX
draw different numbers from the same seed, so the port's batches are not
the reference's. The draws are moved to `device` and everything after them
runs there.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

_F32 = torch.float32


def _generator(seed: int, index: int) -> torch.Generator:
    """The generator of batch `index` of a run seeded `seed`."""
    return torch.Generator().manual_seed((seed << 32) + index)


def _normals(gen: torch.Generator, shape, device):
    re = torch.randn(shape, generator=gen, dtype=_F32)
    im = torch.randn(shape, generator=gen, dtype=_F32)
    return re.to(device), im.to(device)


def _freq(n: int, device, real: bool = False) -> torch.Tensor:
    """Integer wavenumbers of an n-point (r)FFT, as f32."""
    fn = torch.fft.rfftfreq if real else torch.fft.fftfreq
    return fn(n, 1.0 / n, device=device, dtype=_F32)


# ---------------------------------------------------------------------------
# Gaussian random fields (periodic, power-law spectrum)
# ---------------------------------------------------------------------------
def grf_1d_from_normals(re: torch.Tensor, im: torch.Tensor, n: int,
                        alpha: float = 2.5, tau: float = 7.0
                        ) -> torch.Tensor:
    """re, im: [B, n//2+1] standard normals -> [B, n]."""
    k = _freq(n, re.device, real=True)
    spec = (k ** 2 + tau ** 2) ** (-alpha / 2.0)
    coef = torch.complex(re, im) * spec * n
    return torch.fft.irfft(coef, n=n, dim=-1)


def grf_1d(gen: torch.Generator, batch: int, n: int, alpha: float = 2.5,
           tau: float = 7.0, device="cpu") -> torch.Tensor:
    re, im = _normals(gen, (batch, n // 2 + 1), device)
    return grf_1d_from_normals(re, im, n, alpha, tau)


def grf_2d_from_normals(re: torch.Tensor, im: torch.Tensor, n: int,
                        alpha: float = 2.0, tau: float = 3.0
                        ) -> torch.Tensor:
    """re, im: [B, n, n//2+1] standard normals -> [B, n, n]."""
    kx = _freq(n, re.device)
    ky = _freq(n, re.device, real=True)
    k2 = kx[:, None] ** 2 + ky[None, :] ** 2
    spec = (k2 + tau ** 2) ** (-alpha / 2.0)
    coef = torch.complex(re, im) * spec * n
    return torch.fft.irfft2(coef, s=(n, n), dim=(-2, -1))


def grf_2d(gen: torch.Generator, batch: int, n: int, alpha: float = 2.0,
           tau: float = 3.0, device="cpu") -> torch.Tensor:
    re, im = _normals(gen, (batch, n, n // 2 + 1), device)
    return grf_2d_from_normals(re, im, n, alpha, tau)


def _k2_grid_3d(n: int, device) -> torch.Tensor:
    """|k|² over the rfftn layout [n, n, n//2+1] (integer wavenumbers)."""
    kf = _freq(n, device)
    kr = _freq(n, device, real=True)
    return (kf[:, None, None] ** 2 + kf[None, :, None] ** 2
            + kr[None, None, :] ** 2)


def grf_3d_from_normals(re: torch.Tensor, im: torch.Tensor, n: int,
                        alpha: float = 2.5, tau: float = 3.0
                        ) -> torch.Tensor:
    """re, im: [B, n, n, n//2+1] standard normals -> [B, n, n, n]."""
    spec = (_k2_grid_3d(n, re.device) + tau ** 2) ** (-alpha / 2.0)
    coef = torch.complex(re, im) * spec * n ** 1.5
    return torch.fft.irfftn(coef, s=(n, n, n), dim=(-3, -2, -1))


def grf_3d(gen: torch.Generator, batch: int, n: int, alpha: float = 2.5,
           tau: float = 3.0, device="cpu") -> torch.Tensor:
    re, im = _normals(gen, (batch, n, n, n // 2 + 1), device)
    return grf_3d_from_normals(re, im, n, alpha, tau)


def _std(x: torch.Tensor, dim=None, keepdim=False) -> torch.Tensor:
    """Population standard deviation (``jnp.std``'s default)."""
    if dim is None:
        return torch.std(x, correction=0)
    return torch.std(x, dim=dim, keepdim=keepdim, correction=0)


# ---------------------------------------------------------------------------
# Burgers 1D
# ---------------------------------------------------------------------------
def burgers_solve(u0: torch.Tensor, *, nu: float = 0.01,
                  t_final: float = 1.0, n: int = 256,
                  steps: int = 200) -> torch.Tensor:
    """Spectral RK4 for periodic Burgers. u0: [B, n] -> u(T): [B, n]."""
    dt = t_final / steps
    freq = _freq(n, u0.device, real=True)
    k = 2j * math.pi * freq
    dealias = torch.abs(freq) < (n // 3)

    def rhs(uh):
        u = torch.fft.irfft(uh, n=n, dim=-1)
        conv = torch.fft.rfft(0.5 * u * u, dim=-1) * dealias
        return -k * conv + nu * k ** 2 * uh

    uh = torch.fft.rfft(u0, dim=-1)
    for _ in range(steps):
        k1 = rhs(uh)
        k2 = rhs(uh + 0.5 * dt * k1)
        k3 = rhs(uh + 0.5 * dt * k2)
        k4 = rhs(uh + dt * k3)
        uh = uh + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return torch.fft.irfft(uh, n=n, dim=-1)


def burgers_batch(seed: int, index: int, batch: int, n: int = 256,
                  nu: float = 0.01, device="cpu") -> Dict[str, torch.Tensor]:
    """Batch `index` of a run: x = [B,1,n] u0, y = [B,1,n] u(T)."""
    u0 = grf_1d(_generator(seed, index), batch, n, device=device)
    u0 = u0 / (_std(u0, -1, keepdim=True) + 1e-6)
    ut = burgers_solve(u0, nu=nu, n=n)
    return {"x": u0[:, None, :].to(_F32), "y": ut[:, None, :].to(_F32)}


# ---------------------------------------------------------------------------
# Diffusion-reaction 3D (periodic cube, exact spectral propagator)
# ---------------------------------------------------------------------------
def diffusion3d_solve(u0: torch.Tensor, *, nu: float = 0.05, r: float = 1.0,
                      t_final: float = 0.25, n: int = 16) -> torch.Tensor:
    """u_t = ν·Δu + r·u on the periodic unit cube; each Fourier mode k
    evolves as exp((r − ν·|2πk|²)·T). u0: [B,n,n,n] -> u(T)."""
    decay = torch.exp((r - nu * (2.0 * math.pi) ** 2
                       * _k2_grid_3d(n, u0.device)) * t_final)
    uh = torch.fft.rfftn(u0, dim=(-3, -2, -1))
    return torch.fft.irfftn(uh * decay, s=(n, n, n), dim=(-3, -2, -1))


def diffusion3d_batch(seed: int, index: int, batch: int, n: int = 16,
                      nu: float = 0.05, device="cpu"
                      ) -> Dict[str, torch.Tensor]:
    """Batch `index`: x = [B,1,n,n,n] u0, y = [B,1,n,n,n] u(T)."""
    u0 = grf_3d(_generator(seed + 333, index), batch, n, device=device)
    u0 = u0 / (_std(u0.reshape(batch, -1), -1).reshape(batch, 1, 1, 1)
               + 1e-6)
    ut = diffusion3d_solve(u0, nu=nu, n=n)
    return {"x": u0[:, None].to(_F32), "y": ut[:, None].to(_F32)}


# ---------------------------------------------------------------------------
# Darcy 2D
# ---------------------------------------------------------------------------
def _darcy_apply(a: torch.Tensor, u: torch.Tensor, h: float) -> torch.Tensor:
    """-∇·(a∇u) with a 5-point harmonic-mean stencil; u=0 boundary."""
    up = F.pad(u, (1, 1, 1, 1))
    ap = F.pad(a, (1, 1, 1, 1), mode="replicate")
    hm = lambda x, y: 2 * x * y / (x + y + 1e-12)
    c = ap[:, 1:-1, 1:-1]
    ae = hm(c, ap[:, 1:-1, 2:])
    aw = hm(c, ap[:, 1:-1, :-2])
    an = hm(c, ap[:, 2:, 1:-1])
    as_ = hm(c, ap[:, :-2, 1:-1])
    flux = (ae * (up[:, 1:-1, 2:] - u) + aw * (up[:, 1:-1, :-2] - u)
            + an * (up[:, 2:, 1:-1] - u) + as_ * (up[:, :-2, 1:-1] - u))
    return -flux / h ** 2


def darcy_solve(a: torch.Tensor, f: torch.Tensor,
                iters: int = 200) -> torch.Tensor:
    """CG for -∇·(a∇u)=f with a fixed iteration count. a, f: [B, n, n] ->
    u: [B, n, n]."""
    n = a.shape[-1]
    h = 1.0 / (n + 1)
    dot = lambda p, q: torch.sum(p * q, dim=(-2, -1), keepdim=True)
    x = torch.zeros_like(f)
    r = f - _darcy_apply(a, x, h)
    p = r
    rs = dot(r, r)
    for _ in range(iters):
        ap = _darcy_apply(a, p, h)
        alpha = rs / (dot(p, ap) + 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = dot(r, r)
        p = r + (rs_new / (rs + 1e-30)) * p
        rs = rs_new
    return x


def darcy_from_field(g: torch.Tensor, iters: int = 200
                     ) -> Dict[str, torch.Tensor]:
    """The Darcy sample of a GRF g [B, n, n]: x = [B,3,n,n] (a/10, grid_x,
    grid_y), y = [B,1,n,n] u normalised by its standard deviation."""
    batch, n = g.shape[0], g.shape[-1]
    a = torch.where(g > 0, 12.0, 3.0).to(_F32)
    u = darcy_solve(a, torch.ones_like(a), iters=iters)
    xs = torch.linspace(0, 1, n, device=g.device, dtype=_F32)
    gx = xs[None, :, None].expand(batch, n, n)
    gy = xs[None, None, :].expand(batch, n, n)
    x = torch.stack([a / 10.0, gx, gy], dim=1)
    scale = 1.0 / (_std(u) + 1e-9)
    return {"x": x.to(_F32), "y": (u * scale)[:, None].to(_F32)}


def darcy_batch(seed: int, index: int, batch: int, n: int = 64,
                iters: int = 200, device="cpu") -> Dict[str, torch.Tensor]:
    """Batch `index` of a run: x = [B,3,n,n], y = [B,1,n,n]."""
    g = grf_2d(_generator(seed + 77, index), batch, n, device=device)
    return darcy_from_field(g, iters)
