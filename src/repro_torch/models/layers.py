"""Shared building blocks of the LM zoo: dense, norms, MLPs, RoPE
(counterpart of ``repro/models/layers.py``).

Params are nested dicts of tensors, as the reference's pytrees. Every init
takes a ``torch.Generator`` (None on the "meta" device, which draws
nothing), the dtype, the device and ``lead``, leading dims stacked in
front of each leaf (the transformer's ``[L, …]`` layer stack).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard_activation

_F32 = torch.float32


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype norms, RoPE, attention scores, routing and the SSD scan
    compute in: f32 for f32 and bf16 activations (the reference's), the
    activations' own for float64, so the same code run in float64 is an
    oracle of its f32 rounding."""
    return torch.float64 if dtype == torch.float64 else _F32


def normal(gen: Optional[torch.Generator], shape: Tuple[int, ...], dtype,
           device, scale: float = 1.0) -> torch.Tensor:
    """`scale` times a standard normal draw of `shape` from `gen` (an
    empty tensor on the "meta" device)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=_F32, device=device)
    return (x * scale).to(dtype)


def dense_init(gen, din: int, dout: int, dtype, device, bias: bool = False,
               lead: Tuple[int, ...] = ()):
    p = {"w": normal(gen, lead + (din, dout), dtype, device,
                     (1.0 / din) ** 0.5)}
    if bias:
        p["b"] = torch.zeros(lead + (dout,), dtype=dtype, device=device)
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# -- norms -------------------------------------------------------------------
def norm_init(d: int, kind: str, dtype, device, lead: Tuple[int, ...] = ()):
    p = {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    """RMSNorm or LayerNorm (population variance), computed in f32 and
    returned at x's dtype."""
    f = acc_dtype(x.dtype)
    xf, d = x.to(f), (x.shape[-1],)
    if kind == "rmsnorm":
        y = F.rms_norm(xf, d, p["scale"].to(f), eps)
    else:
        y = F.layer_norm(xf, d, p["scale"].to(f), p["bias"].to(f), eps)
    return y.to(x.dtype)


# -- MLP ---------------------------------------------------------------------
def mlp_init(gen, cfg: ModelConfig, dtype, device,
             lead: Tuple[int, ...] = ()):
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(gen, d, f, dtype, device, lead=lead)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, d, f, dtype, device, lead=lead)
    p["wo"] = dense_init(gen, f, d, dtype, device, lead=lead)
    return p


def activate(h: torch.Tensor, gate: Optional[torch.Tensor], kind: str
             ) -> torch.Tensor:
    """The MLP's nonlinearity on the up projection `h` (and the gate
    projection `gate` of the gated kinds). GELU is the tanh form, as
    ``jax.nn.gelu``'s default."""
    if kind == "swiglu":
        return F.silu(gate) * h
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * h
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")
    if kind == "relu2":
        return torch.square(F.relu(h))
    raise ValueError(kind)


def apply_mlp(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    gate = dense(p["wg"], x) if "wg" in p else None
    h = activate(dense(p["wi"], x), gate, kind)
    h = shard_activation(h, "ffn")
    return dense(p["wo"], h)


# -- RoPE --------------------------------------------------------------------
def rope_frequencies(head_dim: int, fraction: float, base: float,
                     device="cpu", dtype=_F32) -> torch.Tensor:
    """Inverse frequencies (f32) for the rotated sub-dimension."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=dtype, device=device) / rot
    return 1.0 / (base ** exps)


def rope_angles(positions: torch.Tensor, cfg: ModelConfig, dtype=_F32
                ) -> Optional[torch.Tensor]:
    """The rotations of ``apply_rope`` at `positions` [B, S]: e^{iθ} as a
    complex [B, S, 1, rot/2], θ = position × inverse frequency in `dtype`
    (``acc_dtype`` of the activations; None where the model has no RoPE).
    Computed once, they serve every layer's q and k."""
    if cfg.rope_style == "none":
        return None
    inv = rope_frequencies(cfg.head_dim, cfg.rope_fraction, cfg.rope_base,
                           positions.device, dtype)
    ang = positions[..., None].to(dtype) * inv  # [B, S, rot/2]
    return torch.polar(torch.ones_like(ang), ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
               angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (absolute). Rotates the first
    `rope_fraction` of D in interleaved pairs (x[..., 0::2] with
    x[..., 1::2]: the pair is a complex number times e^{iθ}), in f32;
    partial RoPE keeps the tail as is. `angles`: ``rope_angles`` of the
    positions, where the caller has them."""
    if cfg.rope_style == "none":
        return x
    f = acc_dtype(x.dtype)
    if angles is None:
        angles = rope_angles(positions, cfg, f)
    rot = 2 * angles.shape[-1]
    xr = x[..., :rot].to(f).reshape(*x.shape[:-1], rot // 2, 2)
    y = torch.view_as_real(torch.view_as_complex(xr.contiguous()) * angles)
    y = y.flatten(-2).to(x.dtype)
    return y if rot == x.shape[-1] else torch.cat([y, x[..., rot:]], dim=-1)
