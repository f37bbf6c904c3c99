"""Unified LM-family transformer: one implementation, ten architectures
(counterpart of ``repro/models/transformer.py``).

Heterogeneous layer patterns (gemma3's 5 local : 1 global, hymba's three
global layers) group consecutive same-kind layers into SEGMENTS: within a
segment the attention window is fixed, so sliding-window layers take the
O(S·W) window-slice attention. Layer params are stacked ``[L, …]`` leaves,
as the reference's, so the two trees match path for path; a layer is the
slice ``[i]`` of each leaf.

KV caches are per segment: sliding-window segments hold RING buffers of
~window slots (token p in slot p % Sc), full-attention segments one slot a
position. SSM layers carry O(1) recurrent state. The cache tree:

    {"segments": [ {"k","v": [nl,B,Sc,Hkv,D]} | {"conv","ssm": ...} | both ],
     "len": 0-d int32 tensor (the next token's position)}

``decode_step`` writes the new token's keys, values and SSM states into
the stacked cache tensors in place (one slot a layer) and returns the same
tensors with ``len`` advanced; its positions stay on the device, so a step
never waits for the host.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.distributed.sharding import (effective_kv_heads, kv_rep,
                                              shard_activation)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (acc_dtype, apply_mlp, apply_norm,
                                       apply_rope, dense, dense_init,
                                       mlp_init, norm_init, normal,
                                       rope_angles)

_F32 = torch.float32

# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------
def layer_flags(cfg: ModelConfig) -> List[bool]:
    """Per-layer is_global flag (True = full attention, no window)."""
    n = cfg.num_layers
    if not cfg.has_attention or cfg.attention in ("full", "bidirectional"):
        return [True] * n
    if cfg.attention == "local_global":
        per = cfg.local_per_global + 1
        return [(i % per) == cfg.local_per_global for i in range(n)]
    # swa: windowed everywhere except explicit global layers
    return [i in cfg.global_layers for i in range(n)]


def segments(cfg: ModelConfig) -> List[Tuple[int, int, bool]]:
    """Contiguous (start, end, is_global) runs of layers."""
    flags = layer_flags(cfg)
    segs, s = [], 0
    for i in range(1, cfg.num_layers + 1):
        if i == cfg.num_layers or flags[i] != flags[s]:
            segs.append((s, i, flags[s]))
            s = i
    return segs


def _rup(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def ring_size(cfg: ModelConfig, is_global: bool, max_len: int) -> int:
    """Cache slots of a segment: every position for a global one, else the
    window plus one rounded up to 128 (at most max_len)."""
    if is_global or cfg.window_size <= 0:
        return max_len
    return min(max_len, _rup(cfg.window_size + 1, 128))


def _layers(layers) -> List[Dict[str, Any]]:
    """Each layer's params: the slices [i] of every stacked leaf (one
    ``unbind`` a leaf, not one index a leaf and layer)."""
    parts = [torch.unbind(t) for t in tree.leaves(layers)]
    return [tree.unflatten(layers, [p[i] for p in parts])
            for i in range(len(parts[0]))]


def _repeat_kv(t: torch.Tensor, r: int) -> torch.Tensor:
    """KV heads repeated r times each, in place (head h -> h*r … h*r+r-1),
    as ``jnp.repeat`` along the head axis."""
    return t.repeat_interleave(r, dim=2) if r > 1 else t


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_lm(gen: Optional[torch.Generator], cfg: ModelConfig, dtype=None,
            device="cpu") -> Dict[str, Any]:
    """Random params drawn from `gen` at `dtype` (default ``cfg.dtype``)
    on `device`; on the "meta" device the tree's shapes and dtypes alone
    (`gen` may be None)."""
    cfg.validate()
    dtype = dtype or torch_dtype(cfg.dtype)
    lead = (cfg.num_layers,)
    layers: Dict[str, Any] = {
        "ln1": norm_init(cfg.d_model, cfg.norm, dtype, device, lead)}
    if cfg.has_attention:
        layers["attn"] = attn.attn_init(gen, cfg, dtype, device, lead)
    if cfg.has_ssm:
        layers["ssm"] = ssm_mod.ssm_init(gen, cfg, dtype, device, lead)
    if cfg.d_ff > 0:
        if cfg.num_experts:
            layers["moe"] = moe_mod.moe_init(gen, cfg, dtype, device, lead)
            if cfg.dense_residual:
                layers["mlp"] = mlp_init(gen, cfg, dtype, device, lead)
        else:
            layers["mlp"] = mlp_init(gen, cfg, dtype, device, lead)
        layers["ln2"] = norm_init(cfg.d_model, cfg.norm, dtype, device, lead)
    params = {
        "embed": normal(gen, (cfg.vocab_size, cfg.d_model), dtype, device,
                        1.0 / cfg.d_model ** 0.5),
        "layers": layers,
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype, device)
    return params


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------
def _qkv(lp, h: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
         angles: Optional[torch.Tensor]):
    """Projected, rotated q [B,S,Hq,D] and k, v [B,S,Hkv·rep,D]."""
    b, s, _ = h.shape
    q = dense(lp["wq"], h).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = dense(lp["wk"], h).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = dense(lp["wv"], h).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg, angles)
    k = apply_rope(k, positions, cfg, angles)
    r = kv_rep()
    return shard_activation(q, "heads"), _repeat_kv(k, r), _repeat_kv(v, r)


def _attn_sublayer(lp, h: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, *, window: int, q_block: int,
                   kv_block: int, angles: Optional[torch.Tensor] = None):
    b, s, _ = h.shape
    q, k, v = _qkv(lp, h, cfg, positions, angles)
    k = shard_activation(k, "kv")
    v = shard_activation(v, "kv")
    o = attn.multihead_attention(
        q, k, v, causal=cfg.is_decoder, window=window,
        softcap=cfg.logit_softcap, q_block=q_block, kv_block=kv_block)
    out = dense(lp["wo"], o.reshape(b, s, -1))
    return out, (k, v)


def _mlp_sublayer(lp, x: torch.Tensor, cfg: ModelConfig):
    aux = torch.zeros((), dtype=_F32, device=x.device)
    if cfg.d_ff <= 0:
        return torch.zeros_like(x), aux
    h2 = apply_norm(lp["ln2"], x, cfg.norm)
    if cfg.num_experts:
        y, aux = moe_mod.apply_moe(lp["moe"], h2, cfg)
        if cfg.dense_residual:
            y = y + apply_mlp(lp["mlp"], h2, cfg.mlp)
    else:
        y = apply_mlp(lp["mlp"], h2, cfg.mlp)
    return y, aux


def _mix(parts: List[torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Attention and SSM outputs: their mean with hybrid_parallel, else
    their sum."""
    mix = parts[0]
    for part in parts[1:]:
        mix = mix + part
    return mix / len(parts) if cfg.hybrid_parallel else mix


def _layer_fwd(lp, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, *, window: int, q_block: int = 256,
               kv_block: int = 512, want_state: bool = False,
               angles: Optional[torch.Tensor] = None):
    """Full-sequence layer. Returns (x', aux, (k, v), ssm_state).
    `angles`: ``rope_angles(positions, cfg)``, where the caller has them."""
    h = apply_norm(lp["ln1"], x, cfg.norm)
    parts, kv, ssm_state = [], None, None
    if cfg.has_attention:
        o, kv = _attn_sublayer(lp["attn"], h, cfg, positions, window=window,
                               q_block=q_block, kv_block=kv_block,
                               angles=angles)
        parts.append(o)
    if cfg.has_ssm:
        if want_state:
            o, ssm_state = ssm_mod.ssd_forward(lp["ssm"], h, cfg,
                                               return_state=True)
        else:
            o = ssm_mod.ssd_forward(lp["ssm"], h, cfg)
        parts.append(o)
    x = x + _mix(parts, cfg)
    y, aux = _mlp_sublayer(lp, x, cfg)
    x = shard_activation(x + y, "embed")
    return x, aux, kv, ssm_state


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
class _Lookup(torch.autograd.Function):
    """``table[idx]``, whose backward sums each row's grads at
    ``acc_dtype`` and rounds once: the index's own backward adds a bf16
    table's rows in bf16, so a frequent token's row (a Zipf head token is
    hundreds of a 4096-token row) carries the rounding of every add
    (PERF.md §6)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.meta = (table.shape, table.dtype)
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        shape, dtype = ctx.meta
        acc = torch.zeros(shape, dtype=acc_dtype(dtype), device=g.device)
        acc.index_add_(0, idx.reshape(-1),
                       g.reshape(-1, shape[-1]).to(acc.dtype))
        return acc.to(dtype), None


def embed_inputs(params, cfg: ModelConfig, tokens=None, inputs_embeds=None,
                 prefix_embeds=None) -> torch.Tensor:
    """Token embeddings (tokens int32 [B,S]) or the given frame embeddings,
    with the prefix embeddings in front."""
    if inputs_embeds is not None:
        x = inputs_embeds
    else:
        x = _Lookup.apply(params["embed"], tokens.long())
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return shard_activation(x, "embed")


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = dense(params["lm_head"], x)
    return shard_activation(logits, "logits")


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(params, cfg: ModelConfig, tokens=None, inputs_embeds=None,
            prefix_embeds=None, q_block: int = 256, kv_block: int = 512,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [B,S,V], MoE aux loss).

    remat=True checkpoints each layer (``torch.utils.checkpoint``, the
    non-reentrant form): the backward keeps a layer's input alone and runs
    the layer again, as the reference's ``jax.checkpoint`` with the
    ``nothing_saveable`` policy — the memory / FLOP trade of the big archs
    at train_4k. The recompute is the same code on the same inputs, so it
    changes no bit where the forward is deterministic."""
    x = embed_inputs(params, cfg, tokens, inputs_embeds, prefix_embeds)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    angles = rope_angles(positions, cfg, acc_dtype(x.dtype))
    layers = _layers(params["layers"])
    aux_total = torch.zeros((), dtype=_F32, device=x.device)
    for (s, e, is_global) in segments(cfg):
        window = 0 if is_global else cfg.window_size

        def one_layer(lp, xx, window=window):
            return _layer_fwd(lp, xx, cfg, positions, window=window,
                              q_block=q_block, kv_block=kv_block,
                              angles=angles)[:2]

        for i in range(s, e):
            if remat:
                x, aux = checkpoint(one_layer, layers[i], x,
                                    use_reentrant=False)
            else:
                x, aux = one_layer(layers[i], x)
            aux_total = aux_total + aux
    return lm_logits(params, cfg, x), aux_total


# The attention's q and kv block in training. At the reference's 256 / 512
# a 4096-token step waits on the host: each block pair is a dozen ops,
# forward, recompute and backward (PERF.md §6). Serving keeps forward's.
TRAIN_BLOCK = 1024


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            aux_coef: float = 0.01, remat: bool = False) -> torch.Tensor:
    """The mean next-token NLL plus ``aux_coef`` times the MoE aux loss.

    batch: tokens [B,S] and labels [B,S] (-1 = ignore), or inputs_embeds
    [B,S,d] with labels; optional prefix_embeds, whose positions carry no
    loss. The logsumexp − gather form: the target logit is gathered at the
    logits' dtype (rounded to bf16 under bf16, as the reference's) and
    only then widened, and no full-vocabulary log-softmax is formed. The
    attention runs in blocks of ``TRAIN_BLOCK``."""
    logits, aux = forward(
        params, cfg, batch.get("tokens"), batch.get("inputs_embeds"),
        batch.get("prefix_embeds"), q_block=TRAIN_BLOCK,
        kv_block=TRAIN_BLOCK, remat=remat)
    labels = batch["labels"]
    npad = logits.shape[1] - labels.shape[1]
    if npad:  # prefix embeds: no loss on prefix positions
        logits = logits[:, npad:]
    f = acc_dtype(logits.dtype)
    mask = labels >= 0
    labels_c = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(logits.to(f), dim=-1)
    tgt = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    nll = lse - tgt.to(f)
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return loss + aux_coef * aux


def unread_leaves(cfg: ModelConfig, batch) -> Tuple[Tuple[str], ...]:
    """Key paths of the params ``lm_loss`` does not read on `batch`: the
    token table, where the batch brings frame embeddings in place of
    tokens and the head is a table of its own (hubert)."""
    if "tokens" not in batch and not cfg.tie_embeddings:
        return (("embed",),)
    return ()


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cpu") -> Dict[str, Any]:
    """Zero cache sized for `max_len` total positions."""
    dtype = dtype or torch_dtype(cfg.dtype)
    zeros = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=device)
    segs = []
    for (s, e, is_global) in segments(cfg):
        nl = e - s
        seg: Dict[str, Any] = {}
        if cfg.has_attention:
            sc = ring_size(cfg, is_global, max_len)
            kv = (nl, batch, sc, effective_kv_heads(cfg), cfg.head_dim)
            seg["k"], seg["v"] = zeros(*kv), zeros(*kv)
        if cfg.has_ssm:
            seg["conv"] = zeros(nl, batch, cfg.ssm_conv_width - 1,
                                cfg.d_inner)
            seg["ssm"] = zeros(nl, batch, cfg.ssm_heads, cfg.ssm_state,
                               cfg.ssm_head_dim, dt=acc_dtype(dtype))
        segs.append(seg)
    return {"segments": segs,
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def _to_ring(k: torch.Tensor, sc: int) -> torch.Tensor:
    """[B,S,...] full keys -> ring buffer [B,Sc,...] (token p at slot
    p % Sc)."""
    s = k.shape[1]
    if s <= sc:
        pad = torch.zeros((k.shape[0], sc - s) + tuple(k.shape[2:]),
                          dtype=k.dtype, device=k.device)
        return torch.cat([k, pad], dim=1)
    return torch.roll(k[:, -sc:], s % sc, dims=1)


def prefill(params, cfg: ModelConfig, tokens=None, inputs_embeds=None,
            prefix_embeds=None, max_len: Optional[int] = None,
            q_block: int = 256, kv_block: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (logits for the LAST position [B,V], the populated cache)."""
    x = embed_inputs(params, cfg, tokens, inputs_embeds, prefix_embeds)
    b, s = x.shape[:2]
    max_len = max_len or s
    positions = _positions(b, s, x.device)
    angles = rope_angles(positions, cfg, acc_dtype(x.dtype))
    layers = _layers(params["layers"])
    segs_out = []
    for (st, en, is_global) in segments(cfg):
        window = 0 if is_global else cfg.window_size
        sc = ring_size(cfg, is_global, max_len)
        seg: Dict[str, Any] = {}
        for j, i in enumerate(range(st, en)):
            x, _, kv, ssm_state = _layer_fwd(
                layers[i], x, cfg, positions, window=window,
                q_block=q_block, kv_block=kv_block, want_state=True,
                angles=angles)
            outs = {}
            if kv is not None:
                outs["k"], outs["v"] = (_to_ring(t, sc) for t in kv)
            if ssm_state is not None:
                outs["conv"], outs["ssm"] = ssm_state
            for name, t in outs.items():  # one stacked [nl, …] leaf each
                if name not in seg:
                    seg[name] = t.new_empty((en - st,) + tuple(t.shape))
                seg[name][j] = t
        segs_out.append(seg)
    logits = lm_logits(params, cfg, x[:, -1:])
    return logits[:, 0], {
        "segments": segs_out,
        "len": torch.tensor(s, dtype=torch.int32, device=x.device)}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _ring_positions(sc: int, cur_len: torch.Tensor) -> torch.Tensor:
    """Absolute token position held by each ring slot AFTER writing the
    token at position cur_len into slot cur_len % sc. Empty slots < 0.
    (``%`` on tensors is the floor modulo, as ``jnp``'s.)"""
    idx = torch.arange(sc, device=cur_len.device)
    p = cur_len - (cur_len - idx) % sc
    return torch.where(p <= cur_len, p, p - sc)


def decode_step(params, cfg: ModelConfig, cache: Dict[str, Any],
                token: Optional[torch.Tensor] = None,
                token_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. token: [B] int32 (or token_embeds [B,1,D]).
    Returns (logits [B,V], the cache): the new token's slot of every
    stacked cache tensor is written in place, and ``len`` advances."""
    cur = cache["len"]  # the new token's position
    if token_embeds is not None:
        x = token_embeds
    else:
        x = params["embed"][token.long()][:, None]
    x = shard_activation(x, "embed")
    b = x.shape[0]
    positions = cur.expand(b, 1)
    angles = rope_angles(positions, cfg, acc_dtype(x.dtype))
    layers = _layers(params["layers"])
    for seg_i, (st, en, is_global) in enumerate(segments(cfg)):
        window = 0 if is_global else cfg.window_size
        seg = cache["segments"][seg_i]
        if cfg.has_attention:
            scap = seg["k"].shape[2]
            slot = (cur % scap).long().reshape(1)
            penalty = attn.decode_penalty(_ring_positions(scap, cur), cur,
                                          window)
        for j, i in enumerate(range(st, en)):
            lp = layers[i]
            h = apply_norm(lp["ln1"], x, cfg.norm)
            parts = []
            if cfg.has_attention:
                q, k, v = _qkv(lp["attn"], h, cfg, positions, angles)
                # the in-place single-slot write into the stacked cache
                seg["k"][j].index_copy_(1, slot, k.to(seg["k"].dtype))
                seg["v"][j].index_copy_(1, slot, v.to(seg["v"].dtype))
                o = attn.decode_attention(q, seg["k"][j], seg["v"][j],
                                          penalty,
                                          softcap=cfg.logit_softcap)
                parts.append(dense(lp["attn"]["wo"], o.reshape(b, 1, -1)))
            if cfg.has_ssm:
                o, (conv_new, ssm_new) = ssm_mod.ssd_decode_step(
                    lp["ssm"], h, (seg["conv"][j], seg["ssm"][j]), cfg)
                parts.append(o)
                seg["conv"][j].copy_(conv_new)
                seg["ssm"][j].copy_(ssm_new)
            x = x + _mix(parts, cfg)
            y, _ = _mlp_sublayer(lp, x, cfg)
            x = x + y
    logits = lm_logits(params, cfg, x)
    return logits[:, 0], {"segments": cache["segments"], "len": cur + 1}
