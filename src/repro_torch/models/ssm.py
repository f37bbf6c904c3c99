"""Mamba2 / SSD (state-space duality) layer, chunked matmul form
(counterpart of ``repro/models/ssm.py``).

The forward is the SSD block decomposition (Dao & Gu 2024): an intra-chunk
"attention-like" term plus an inter-chunk state recurrence (a loop over
chunks). The reference's three-operand einsums run here as pairwise
products in an order that never forms a [B, c, i, j, H, P] tensor (8.6 GB
at hymba-1.5b's width, batch 4, 2048 tokens). Decode keeps an O(1)
recurrent state per layer: (conv window, SSM state [H, N, P]).

As the reference: ngroups = 1 (B/C shared across heads), and the short
causal conv + SiLU applies to the x branch only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard_activation
from repro_torch.models.layers import (acc_dtype, apply_norm, dense_init,
                                       norm_init, normal)

_MIN_DT = 1e-4
_F32 = torch.float32


def ssm_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=_F32))
    return {
        "in_x": dense_init(gen, d, di, dtype, device, lead=lead),
        "in_z": dense_init(gen, d, di, dtype, device, lead=lead),
        "in_b": dense_init(gen, d, n, dtype, device, lead=lead),
        "in_c": dense_init(gen, d, n, dtype, device, lead=lead),
        "in_dt": dense_init(gen, d, h, dtype, device, bias=True, lead=lead),
        "conv_w": normal(gen, lead + (cfg.ssm_conv_width, di), dtype, device,
                         0.1),
        "a_log": a_log.to(device=device, dtype=dtype).expand(
            lead + (h,)).clone(),
        "d": torch.ones(lead + (h,), dtype=dtype, device=device),
        "norm": norm_init(di, "rmsnorm", dtype, device, lead),
        "out": dense_init(gen, di, d, dtype, device, lead=lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq. x: [B,S,di]; w: [K,di].

    Returns (y [B,S,di], final window [B,K-1,di])."""
    kw = w.shape[0]
    if init_state is None:
        init_state = torch.zeros((x.shape[0], kw - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([init_state, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(kw))
    return y, (xp[:, -(kw - 1):] if kw > 1 else init_state)


def _proj_inputs(p, x: torch.Tensor, cfg: ModelConfig, conv_state=None):
    f = acc_dtype(x.dtype)
    xb = x @ p["in_x"]["w"]
    z = x @ p["in_z"]["w"]
    b_ = (x @ p["in_b"]["w"]).to(f)
    c_ = (x @ p["in_c"]["w"]).to(f)
    dt = F.softplus((x @ p["in_dt"]["w"]).to(f) + p["in_dt"]["b"]) + _MIN_DT
    xb, conv_out = _causal_conv(xb, p["conv_w"], conv_state)
    xb = F.silu(xb)
    xb = shard_activation(xb, "ssm_inner")
    return xb, z, b_, c_, dt, conv_out


def _gated_out(p, y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """norm(y · silu(z)) projected out."""
    y = apply_norm(p["norm"], (y * F.silu(z.to(y.dtype))).to(dtype),
                   "rmsnorm")
    return y @ p["out"]["w"]


def ssd_forward(p, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """x: [B, S, d] -> y [B, S, d] (and the final (conv, ssm) states)."""
    b, s, _ = x.shape
    hh, pp, nn = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    q = min(cfg.ssm_chunk, s)
    while s % q:
        q //= 2
    nc = s // q

    f = acc_dtype(x.dtype)
    xb, z, b_, c_, dt, conv_fin = _proj_inputs(p, x, cfg)
    xh = xb.reshape(b, nc, q, hh, pp).to(f)
    bch = b_.reshape(b, nc, q, nn)
    cch = c_.reshape(b, nc, q, nn)
    dtc = dt.reshape(b, nc, q, hh)
    a = -torch.exp(p["a_log"].to(f))  # [H]
    da = dtc * a  # [B,nc,Q,H]
    cum = torch.cumsum(da, dim=2)  # inclusive within chunk
    xdt = xh * dtc[..., None]

    # seg[i, j] = cum_i - cum_j = Σ_{j<k<=i} da_k, summed from j: the
    # difference of the two chunk-long sums loses the low digits (|cum|
    # reaches thousands at full width); the recurrent decode step forms no
    # such difference
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    strict = torch.tril(tri, -1)  # j < i
    seg = torch.cumsum(torch.where(strict[None, None, :, :, None],
                                   da[:, :, :, None, :],
                                   torch.zeros((), dtype=f,
                                               device=x.device)), dim=2)

    # intra-chunk: Y[i] += C_i·B_j · exp(seg[i, j]) · xdt_j  (j <= i)
    gb = torch.einsum("bcin,bcjn->bcij", cch, bch)  # [B,nc,Q,Q]
    # -inf before exp: the (j > i) entries of seg are 0, and their weight
    # must be 0, not 1
    m = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                              torch.full_like(seg, -torch.inf)))
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", gb[..., None] * m, xdt)

    # chunk-final local states: S_c = Σ_j exp(seg[last, j]) B_j ⊗ xdt_j
    dec_out = torch.exp(seg[:, :, -1])  # [B,nc,Q,H]
    s_loc = torch.einsum("bcjn,bcjhp->bchnp", bch, dec_out[..., None] * xdt)

    # inter-chunk recurrence over chunks
    dec_chunk = torch.exp(cum[:, :, -1, :])  # [B,nc,H]
    h = torch.zeros((b, hh, nn, pp), dtype=f, device=x.device)
    before = []
    for c in range(nc):
        before.append(h)
        h = dec_chunk[:, c, :, None, None] * h + s_loc[:, c]
    h_before = torch.stack(before, dim=1)  # [B,nc,H,N,P]

    y_inter = (torch.einsum("bcin,bchnp->bcihp", cch, h_before)
               * torch.exp(cum)[..., None])
    y = y_intra + y_inter + p["d"].to(f)[:, None] * xh
    out = _gated_out(p, y.reshape(b, s, -1), z, x.dtype)
    if return_state:
        return out, (conv_fin, h)
    return out


def ssd_decode_step(p, x: torch.Tensor,
                    state: Tuple[torch.Tensor, torch.Tensor],
                    cfg: ModelConfig):
    """One-token recurrent step. x: [B, 1, d]; state = (conv [B,K-1,di],
    h [B,H,N,P]). Returns (y [B,1,d], new state)."""
    conv_state, h = state
    b = x.shape[0]
    hh, pp = cfg.ssm_heads, cfg.ssm_head_dim
    f = acc_dtype(x.dtype)
    xb, z, b_, c_, dt, conv_new = _proj_inputs(p, x, cfg, conv_state)
    xh = xb.reshape(b, hh, pp).to(f)
    a = -torch.exp(p["a_log"].to(f))
    dt0 = dt[:, 0]  # [B,H]
    da = torch.exp(dt0 * a)
    upd = (dt0[:, :, None, None] * b_[:, 0][:, None, :, None]
           * xh[:, :, None, :])  # [B,H,N,P]
    h_new = da[..., None, None] * h + upd
    y = torch.einsum("bn,bhnp->bhp", c_[:, 0], h_new)
    y = y + p["d"].to(f)[:, None] * xh
    return _gated_out(p, y.reshape(b, 1, -1), z, x.dtype), (conv_new, h_new)
