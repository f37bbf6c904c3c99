"""Fourier Neural Operator models (1D / 2D / 3D) — counterpart of
``repro/core/fno.py``.

  lifting pointwise MLP → L × [spectral conv + 1x1 bypass conv + GELU]
  → projection pointwise MLP.

With ``cfg.fuse_block`` on the fused path each whole block runs as ONE
kernel launch forward (``variant="full"``; ``"partial"`` runs the paper's
partial fusion, three launches and the staged tail) and three backward
(``kernels.ops.fno_block_nd``). Without it, the fused path fuses what the
paper fuses: each layer's spectral conv is one launch forward (three with
``"partial"``) and two backward (``kernels.ops.spectral_layer_nd``), and
the bypass, bias and GELU are PyTorch ops. The staged composition stays
the oracle and the only form on the "ref"/"staged" paths, where torch
autograd differentiates it. With ``cfg.fuse_ends`` (and ``fuse_block``,
on the fused path) the lifting MLP folds into the first block's launch
and the projection MLP into the last one's. Params are a plain dict with
the reference's layout (``lift1``, ``lift2``, ``proj1``, ``proj2``,
``blocks``), so a JAX param tree carries over leaf for leaf
(``repro_torch.convert``).

Mixed precision: params stay at the param dtype; ``apply_fno`` casts the
input once to the compute dtype and the dense/bypass layers follow the
activation dtype, so the cast's backward hands f32 grads to the f32 master
params. The loss is always reduced in f32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FNOConfig, torch_dtype
from repro_torch.core import spectral_conv as sc
from repro_torch.kernels import ops


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
    return ops.pointwise(p["w"], p["b"], x)


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
              *, path: str = None, variant: str = "full") -> torch.Tensor:
    """x: [B, in_channels, *spatial] -> [B, out_channels, *spatial], at the
    policy's compute dtype. On the fused path ``cfg.fuse_block`` runs each
    block as the whole-block kernels, and without it each spectral conv as
    the spectral-layer kernels with the rest of the block in PyTorch;
    `variant` picks full or partial fusion there (the oracle paths compute
    the same function either way)."""
    path = path or cfg.path
    pol = cfg.precision
    fuse = path == "fused" and cfg.fuse_block
    # cfg.fuse_ends: the lifting MLP runs inside the first block's launch
    # and the projection MLP inside the last one's (one launch for both
    # on a 1-layer model), so an L-layer forward is still L launches.
    ends_on = fuse and cfg.fuse_ends
    x = x.to(torch_dtype(pol.compute_dtype))
    if ends_on:
        h = x
    else:
        h = _gelu(_dense(params["lift1"], x))
        h = _dense(params["lift2"], h)
    last = len(params["blocks"]) - 1
    mlp = lambda a, b: (params[a]["w"], params[a]["b"], params[b]["w"],
                        params[b]["b"])
    for i, blk in enumerate(params["blocks"]):
        if fuse:
            ends = None
            if ends_on and i in (0, last):
                ends = (mlp("lift1", "lift2") if i == 0 else None,
                        mlp("proj1", "proj2") if i == last else None)
            h = sc.apply_fno_block_nd(blk["spectral"], blk["bypass"], h,
                                      cfg.modes, path=path, variant=variant,
                                      policy=pol, ends=ends)
            continue
        s = sc.apply_spectral_nd(blk["spectral"], h, cfg.modes, path=path,
                                 variant=variant, policy=pol)
        h = _gelu(s.to(h.dtype) + _dense(blk["bypass"], h))
    if ends_on:
        return h
    return _dense(params["proj2"], _gelu(_dense(params["proj1"], h)))


def relative_l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean relative L2 loss over the batch, always reduced in f32."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    b = pred.shape[0]
    diff = torch.sqrt(torch.sum((pred - target).reshape(b, -1) ** 2, dim=-1))
    norm = torch.sqrt(torch.sum(target.reshape(b, -1) ** 2, dim=-1))
    return torch.mean(diff / torch.clamp(norm, min=1e-8))


def fno_loss(params, cfg: FNOConfig, batch: Dict[str, torch.Tensor], *,
             path: Optional[str] = None,
             variant: str = "full") -> torch.Tensor:
    """Relative L2 loss of the model on batch {"x", "y"}."""
    return relative_l2(apply_fno(params, cfg, batch["x"], path=path,
                                 variant=variant), batch["y"])
