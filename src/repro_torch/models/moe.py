"""Mixture-of-Experts layer: top-k routing with sort-based capacity
dispatch (counterpart of ``repro/models/moe.py``).

Dispatch never forms the [T, E, C] one-hot: a stable argsort over the
expert ids and per-expert prefix offsets give each (token, choice) its
slot, and an accumulating index write fills the [B, E, C, d] expert
buffer. Dispatch is per batch row (its indices never cross rows), with a
per-row capacity C = max(8, rup(ceil(S·k/E·cf), 8)); a choice past its
expert's capacity is dropped.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard_activation
from repro_torch.models.layers import acc_dtype, activate, dense_init, normal

_F32 = torch.float32


def moe_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    scale = (1.0 / d) ** 0.5
    experts = {
        "wi": normal(gen, lead + (e, d, f), dtype, device, scale),
        "wo": normal(gen, lead + (e, f, d), dtype, device,
                     scale / f ** 0.5 * d ** 0.5),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        experts["wg"] = normal(gen, lead + (e, d, f), dtype, device, scale)
    return {"router": dense_init(gen, d, e, dtype, device, lead=lead),
            "experts": experts}


def _expert_ffn(experts: Dict, buf: torch.Tensor, kind: str
                ) -> torch.Tensor:
    """buf: [B, E, C, d] -> [B, E, C, d]; batched over experts."""
    h = torch.einsum("becd,edf->becf", buf, experts["wi"])
    gate = (torch.einsum("becd,edf->becf", buf, experts["wg"])
            if "wg" in experts else None)
    h = activate(h, gate, kind)
    return torch.einsum("becf,efd->becd", h, experts["wo"])


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last dim and their indices, equal
    values lower index first, as ``jax.lax.top_k`` (a stable descending
    sort: ``torch.topk`` may break a tie the other way, and bf16 router
    logits do tie)."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


def capacity(cfg: ModelConfig, seq: int) -> int:
    """Slots per expert and batch row for a row of `seq` tokens."""
    cap = int(math.ceil(seq * cfg.top_k / cfg.num_experts
                        * cfg.capacity_factor))
    return max(8, (cap + 7) // 8 * 8)


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], the Switch load-balance aux loss)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    sk = s * k

    logits = (x @ params["router"]["w"]).to(acc_dtype(x.dtype))  # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    top_logit, top_idx = top_k(logits, k)  # [B, S, k]
    gates = torch.softmax(top_logit, dim=-1).to(x.dtype)

    # load-balance aux (Switch): E * mean(load_frac * prob_frac)
    load = torch.bincount(top_idx.reshape(-1), minlength=e).to(_F32) / (
        b * sk)
    importance = probs.mean((0, 1))
    aux = e * torch.sum(load * importance)

    # ---- sort-based per-row dispatch -----------------------------------
    cap = capacity(cfg, s)
    fe = top_idx.reshape(b, sk)
    order = torch.argsort(fe, dim=-1, stable=True)  # [B, sk]
    fe_s = torch.gather(fe, -1, order)
    tok_s = order // k  # source token within the row
    counts = torch.zeros((b, e), dtype=torch.long, device=x.device)
    counts.scatter_add_(1, fe_s, torch.ones_like(fe_s))
    starts = torch.cumsum(counts, dim=-1) - counts  # exclusive prefix
    slot = (torch.arange(sk, device=x.device)[None, :]
            - torch.gather(starts, -1, fe_s))
    keep = slot < cap
    slot_c = torch.where(keep, slot, torch.zeros_like(slot))

    rows_b = torch.arange(b, device=x.device)[:, None].expand(b, sk)
    x_sorted = torch.gather(x, 1, tok_s[..., None].expand(b, sk, d))
    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((rows_b, fe_s, slot_c),
                   torch.where(keep[..., None], x_sorted,
                               torch.zeros_like(x_sorted)),
                   accumulate=True)
    buf = shard_activation(buf, "experts")

    out_buf = _expert_ffn(params["experts"], buf, cfg.mlp)
    out_buf = shard_activation(out_buf, "experts")

    y_s = out_buf[rows_b, fe_s, slot_c] * keep[..., None].to(x.dtype)
    # unsort back to [B, sk, d], weight by gates, sum over the k choices
    y_flat = torch.zeros((b, sk, d), dtype=x.dtype, device=x.device)
    y_flat[rows_b, order] = y_s
    y = (y_flat.reshape(b, s, k, d) * gates[..., None]).sum(dim=2)
    return y, aux
