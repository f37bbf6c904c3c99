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

Inside a multi-rank ``sharding_context`` (``distributed/sharding.py``) x
holds this rank's rows and the params this rank's shards
(``sharding.shard_params``). Under TP the lifting MLP is column- then
row-parallel (its partial reduce-scattered into the first block's hidden
shard), each block runs ``ops.fno_block_nd_sharded`` with ``cfg.tp_layout``
between interior layers and an all-reduce after the last, and proj1 is
row-parallel over the replicated hidden (its partials all-reduced); the
ends fold into the blocks only without TP. Only the fused path runs under
such a context, and TP only with ``cfg.fuse_block``.

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
from repro_torch.distributed import sharding as shd
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


def abstract_params(cfg: FNOConfig) -> Dict[str, Any]:
    """``init_fno``'s tree at full shapes as tensors on the "meta" device
    (shapes and dtypes, no storage): what ``sharding.param_specs``
    places, the counterpart of ``jax.eval_shape`` of the init."""
    lift, h = cfg.lifting_dim or 2 * cfg.hidden, cfg.hidden
    dt = torch_dtype(cfg.precision.param_dtype)
    t = lambda *s: torch.empty(s, dtype=dt, device="meta")
    dense = lambda i, o: {"w": t(i, o), "b": t(o)}
    w = (h, h) + (tuple(cfg.modes) if cfg.weight_mode == "per_mode" else ())
    return {"lift1": dense(cfg.in_channels, lift), "lift2": dense(lift, h),
            "proj1": dense(h, lift), "proj2": dense(lift, cfg.out_channels),
            "blocks": [{"spectral": {"wr": t(*w), "wi": t(*w)},
                        "bypass": dense(h, h)}
                       for _ in range(cfg.num_layers)]}


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
    ctx = shd.active_context()
    if ctx is not None:
        sc.require_fused(path)
    tp_on = ctx is not None and ctx.model_axis is not None
    if tp_on and not fuse:
        raise ValueError("TP shards the whole-block kernels only: set "
                         "cfg.fuse_block, or fold the model axis into DP "
                         "(make_context(..., fno_strategy='dp'))")
    # cfg.fuse_ends: the lifting MLP runs inside the first block's launch
    # and the projection MLP inside the last one's (one launch for both
    # on a 1-layer model), so an L-layer forward is still L launches.
    ends_on = fuse and cfg.fuse_ends and not tp_on
    x = x.to(torch_dtype(pol.compute_dtype))
    if ends_on:
        h = x
    elif tp_on:
        h = _lift_tp(params, cfg, x, ctx)
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
            # Interior layers take cfg.tp_layout; the last all-reduces (the
            # projection reads all of hidden). No-op without TP.
            h = sc.apply_fno_block_nd(
                blk["spectral"], blk["bypass"], h, cfg.modes, path=path,
                variant=variant, policy=pol, ends=ends,
                tp_layout=cfg.tp_layout if i < last else "psum",
                tp_overlap=cfg.tp_overlap)
            continue
        s = sc.apply_spectral_nd(blk["spectral"], h, cfg.modes, path=path,
                                 variant=variant, policy=pol)
        h = _gelu(s.to(h.dtype) + _dense(blk["bypass"], h))
    if ends_on:
        return h
    if tp_on:
        return _proj_tp(params, h, ctx)
    return _dense(params["proj2"], _gelu(_dense(params["proj1"], h)))


def _partial(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x [B, C/tp, *sp] · w [C/tp, D], a row-parallel layer's partial, in
    f32 (the sum over ranks runs at the accumulator dtype)."""
    return torch.einsum("bc...,cd->bd...", x.to(torch.float32),
                        w.to(x.dtype).to(torch.float32))


def _add(z: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return z + b.to(z.dtype).reshape((1, -1) + (1,) * (z.ndim - 2))


def _lift_tp(params, cfg: FNOConfig, x: torch.Tensor, ctx) -> torch.Tensor:
    """The lifting MLP under TP: lift1 column-parallel (this rank's slice of
    the lifting dim), lift2 row-parallel, its partial reduce-scattered into
    this rank's hidden shard, the first block's input. Where the model axis
    does not divide the lifting dim both replicate (the full hidden, which
    the first block slices)."""
    l1, l2 = params["lift1"], params["lift2"]
    if (cfg.lifting_dim or 2 * cfg.hidden) % ctx.tp:
        return _dense(l2, _gelu(_dense(l1, x)))
    mesh, m = ctx.mesh, ctx.model_axis
    a = _gelu(_dense(l1, shd.shared_input(x, mesh, m, "lift")))
    h = shd.scatter_sum(_partial(l2["w"], a), mesh, m, 1, site="lift")
    h = _add(h, shd.split(l2["b"], mesh, m, 0, site="lift"))
    return h.to(x.dtype)


def _proj_tp(params, h: torch.Tensor, ctx) -> torch.Tensor:
    """The projection MLP under TP: proj1 row-parallel over this rank's
    slice of the replicated hidden, its partials all-reduced; proj2
    replicated."""
    mesh, m = ctx.mesh, ctx.model_axis
    p1 = params["proj1"]
    z = shd.psum(_partial(p1["w"], shd.split(h, mesh, m, 1, site="proj")),
                 mesh, m, site="proj")
    z = _gelu(_add(z, p1["b"]).to(h.dtype))
    return _dense(params["proj2"], z)


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
