"""Fourier Neural Operator models (1D / 2D / 3D) — counterpart of
``repro/core/fno.py``.

  lifting pointwise MLP → L × [spectral conv + 1x1 bypass conv + GELU]
  → projection pointwise MLP.

With ``cfg.fuse_block`` on the fused path each whole block runs as ONE
kernel launch; the staged composition stays the oracle and the only form on
the "ref"/"staged" paths. Params are a plain dict with the reference's
layout (``lift1``, ``lift2``, ``proj1``, ``proj2``, ``blocks``), so a JAX
param tree carries over leaf for leaf (``repro_torch.convert``).

Mixed precision: params stay at the param dtype; ``apply_fno`` casts the
input once to the compute dtype and the dense/bypass layers follow the
activation dtype. The loss is always reduced in f32.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FNOConfig, torch_dtype
from repro_torch.core import spectral_conv as sc


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _dense_init(gen: torch.Generator, din: int, dout: int,
                dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    scale = (2.0 / (din + dout)) ** 0.5
    w = scale * torch.randn((din, dout), generator=gen)
    return {"w": w.to(device=device, dtype=dtype),
            "b": torch.zeros((dout,), dtype=dtype, device=device)}


def _dense(p, x: torch.Tensor) -> torch.Tensor:
    """Pointwise over channels of x [B, C, *sp]; follows x's dtype."""
    y = torch.einsum("bc...,cd->bd...", x, p["w"].to(x.dtype))
    return y + p["b"].reshape((1, -1) + (1,) * (y.ndim - 2)).to(x.dtype)


def init_fno(gen: torch.Generator, cfg: FNOConfig,
             device="cpu") -> Dict[str, Any]:
    """Random params at the policy's param dtype, drawn from `gen`."""
    cfg.validate()
    dtype = torch_dtype(cfg.precision.param_dtype)
    lift = cfg.lifting_dim or 2 * cfg.hidden
    params: Dict[str, Any] = {
        "lift1": _dense_init(gen, cfg.in_channels, lift, dtype, device),
        "lift2": _dense_init(gen, lift, cfg.hidden, dtype, device),
        "proj1": _dense_init(gen, cfg.hidden, lift, dtype, device),
        "proj2": _dense_init(gen, lift, cfg.out_channels, dtype, device),
        "blocks": [],
    }
    for _ in range(cfg.num_layers):
        params["blocks"].append({
            "spectral": sc.init_spectral_nd(gen, cfg.hidden, cfg.hidden,
                                            cfg.modes, cfg.weight_mode,
                                            dtype, device),
            "bypass": _dense_init(gen, cfg.hidden, cfg.hidden, dtype,
                                  device),
        })
    return params


def apply_fno(params: Dict[str, Any], cfg: FNOConfig, x: torch.Tensor,
              *, path: str = None) -> torch.Tensor:
    """x: [B, in_channels, *spatial] -> [B, out_channels, *spatial], at the
    policy's compute dtype. The fused path needs ``cfg.fuse_block`` (its
    kernel is the whole block)."""
    path = path or cfg.path
    pol = cfg.precision
    fuse = path == "fused"
    if fuse and not cfg.fuse_block:
        raise ValueError("path='fused' runs whole-block kernels: set "
                         "cfg.fuse_block (configs.with_fuse_block)")
    x = x.to(torch_dtype(pol.compute_dtype))
    h = _gelu(_dense(params["lift1"], x))
    h = _dense(params["lift2"], h)
    for blk in params["blocks"]:
        if fuse:
            h = sc.apply_fno_block_nd(blk["spectral"], blk["bypass"], h,
                                      cfg.modes, path=path, policy=pol)
            continue
        s = sc.apply_spectral_nd(blk["spectral"], h, cfg.modes, path=path,
                                 policy=pol)
        h = _gelu(s.to(h.dtype) + _dense(blk["bypass"], h))
    return _dense(params["proj2"], _gelu(_dense(params["proj1"], h)))


def relative_l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean relative L2 loss over the batch, always reduced in f32."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    b = pred.shape[0]
    diff = torch.sqrt(torch.sum((pred - target).reshape(b, -1) ** 2, dim=-1))
    norm = torch.sqrt(torch.sum(target.reshape(b, -1) ** 2, dim=-1))
    return torch.mean(diff / torch.clamp(norm, min=1e-8))
