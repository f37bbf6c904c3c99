"""GQA attention: blockwise online softmax for forward and prefill, dense
single-token attention over the KV cache for decode (counterpart of
``repro/models/attention.py``, whose attention is plain XLA: no TPU kernel
lies on this path, so these are plain PyTorch too).

Memory posture, as the reference's:
  * forward / prefill: an outer loop over query blocks, an inner loop over
    KV blocks with running (max, denom, acc) in f32 — the peak score
    tensor is [B, Hkv, G, q_block, kv_block] at any sequence length;
  * sliding window: a query block reads only the [window + q_block] KV
    slice before it (rounded up to whole KV blocks), so the work is
    O(S·W), not O(S²);
  * full causal attention also computes the masked blocks above the
    diagonal, as the reference does;
  * decode: one dense [B, Hkv, G, Sc] score row over the cache.

Query heads group as (Hkv, G), the KV head major. Masks are additive
(-1e30), built from absolute positions.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import acc_dtype, dense_init

_NEG = -1e30
_F32 = torch.float32


def attn_init(gen, cfg: ModelConfig, dtype, device, lead=()):
    d = cfg.d_model
    return {
        "wq": dense_init(gen, d, cfg.d_attn, dtype, device, cfg.qkv_bias,
                         lead),
        "wk": dense_init(gen, d, cfg.d_kv, dtype, device, cfg.qkv_bias,
                         lead),
        "wv": dense_init(gen, d, cfg.d_kv, dtype, device, cfg.qkv_bias,
                         lead),
        "wo": dense_init(gen, cfg.d_attn, d, dtype, device, False, lead),
    }


def _score_penalty(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
                   window: int, kv_len: Optional[int] = None
                   ) -> torch.Tensor:
    """[Sq, Sk] additive f32 penalty (0 valid / -1e30 masked)."""
    pq, pk = pos_q[:, None], pos_k[None, :]
    m = torch.ones(pq.shape[0], pk.shape[1], dtype=torch.bool,
                   device=pq.device)
    if causal:
        m &= pk <= pq
    if window > 0:
        m &= pk > pq - window
    if kv_len is not None:
        m &= pk < kv_len
    zero = torch.zeros((), dtype=_F32, device=pq.device)
    return torch.where(m, zero, torch.full_like(zero, _NEG))


def _visibility(pos_q: range, pos_k: range, causal: bool, window: int,
                kv_len: Optional[int]) -> str:
    """"none", "all" or "some" of the (query, key) pairs of a block are
    unmasked, from the positions alone (on the host)."""
    q0, q1, k0, k1 = pos_q[0], pos_q[-1], pos_k[0], pos_k[-1]
    if ((causal and k0 > q1) or (window > 0 and k1 <= q0 - window)
            or (kv_len is not None and k0 >= kv_len)):
        return "none"
    if ((not causal or k1 <= q0) and (window <= 0 or k0 > q1 - window)
            and (kv_len is None or k1 < kv_len)):
        return "all"
    return "some"


def _attend_block(qb: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                  pos_q: range, pos_k: range, causal: bool, window: int,
                  softcap: float, kv_len: Optional[int] = None,
                  kv_block: int = 512) -> torch.Tensor:
    """Online-softmax attention of one query block against a KV slice.

    qb: [B,Bq,Hkv,G,D]; ks/vs: [B,Sk,Hkv,D]; pos_q / pos_k: their absolute
    positions. Returns [B,Bq,Hkv,G,D]. A KV block whose pairs are all
    masked is skipped: the reference's masked block adds exp(-1e30 - m) = 0
    to every row that has seen a key, and one that has not is reset to
    zero by the first block it sees (its correction exp(-1e30 - m) is 0),
    so skipping it changes no bit. A block with no masked pair adds no
    penalty (adding zeros changes no bit either).
    """
    b, bq, hkv, g, dh = qb.shape
    sk = ks.shape[1]
    f = acc_dtype(qb.dtype)
    qf = qb.to(f) * dh ** -0.5
    m = torch.full((b, hkv, g, bq), _NEG, dtype=f, device=qb.device)
    l = torch.zeros((b, hkv, g, bq), dtype=f, device=qb.device)
    acc = torch.zeros((b, hkv, g, bq, dh), dtype=f, device=qb.device)
    for j in range(0, sk, kv_block):
        pk = pos_k[j:j + kv_block]
        seen = _visibility(pos_q, pk, causal, window, kv_len)
        if seen == "none":
            continue
        kb = ks[:, j:j + kv_block].to(f)
        vb = vs[:, j:j + kv_block].to(f)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb)
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        if seen == "some":
            dev = qb.device
            s = s + _score_penalty(
                torch.arange(pos_q.start, pos_q.stop, device=dev),
                torch.arange(pk.start, pk.stop, device=dev), causal,
                window, kv_len)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(qb.dtype)  # [B,Bq,Hkv,G,D]


def _rup(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0,
                        q_block: int = 256, kv_block: int = 512
                        ) -> torch.Tensor:
    """q: [B,Sq,Hq,D]; k/v: [B,Sk,Hkv,D] -> [B,Sq,Hq,D].

    Positions are absolute: query i has position q_offset + i; key j has
    position j. window>0 restricts each query to the last `window` keys
    (SWA). The blocks halve until they divide the sequence.
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    q_block = min(q_block, sq)
    while sq % q_block:
        q_block //= 2
    kv_block = min(kv_block, sk)
    while sk % kv_block:
        kv_block //= 2
    qg = q.reshape(b, sq, hkv, g, dh)
    wlen = _rup(window + q_block, kv_block)
    use_window_slice = window > 0 and sk > wlen

    outs = []
    for i in range(0, sq, q_block):
        qb = qg[:, i:i + q_block]
        pq = range(q_offset + i, q_offset + i + q_block)
        if not use_window_slice:
            outs.append(_attend_block(qb, k, v, pq, range(sk), causal,
                                      window, softcap, kv_block=kv_block))
            continue
        # the last key this block can see is its last query's position:
        # the slice [start, start + wlen) ends there, clipped to the keys
        start = min(max(pq[-1] + 1 - wlen, 0), sk - wlen)
        outs.append(_attend_block(
            qb, k[:, start:start + wlen], v[:, start:start + wlen], pq,
            range(start, start + wlen), causal, window, softcap,
            kv_block=kv_block))
    return torch.cat(outs, dim=1).reshape(b, sq, hq, dh)


def decode_penalty(pos_k: torch.Tensor, q_pos, window: int = 0
                   ) -> torch.Tensor:
    """[Sc] additive f32 penalty of a decode step's cache slots: 0 where
    the slot holds a key the query at q_pos sees, -1e30 elsewhere (empty
    slots, the future, outside the window). One serves every layer of a
    segment."""
    valid = (pos_k >= 0) & (pos_k <= q_pos)
    if window > 0:
        valid &= pos_k > q_pos - window
    zero = torch.zeros((), dtype=_F32, device=pos_k.device)
    return torch.where(valid, zero, torch.full_like(zero, _NEG))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, penalty: torch.Tensor, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """``decode_attention_pos`` with the slots' ``decode_penalty`` given."""
    b, _, hq, dh = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    f = acc_dtype(q.dtype)
    qf = q.reshape(b, hkv, g, dh).to(f) * dh ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.to(f))
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    p = torch.softmax(s + penalty, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(f))
    return o.reshape(b, 1, hq, dh).to(q.dtype)


def decode_attention_pos(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos_k: torch.Tensor, q_pos,
                         *, window: int = 0, softcap: float = 0.0
                         ) -> torch.Tensor:
    """Single-token attention over a (possibly ring) cache.

    q: [B,1,Hq,D]; caches: [B,Sc,Hkv,D]; pos_k: [Sc] absolute token
    position of each cache slot (< 0 = empty); q_pos: the query's absolute
    position (an int or a 0-d tensor). Dense over Sc: O(cache size) a step.
    """
    return decode_attention(q, k_cache, v_cache,
                            decode_penalty(pos_k, q_pos, window),
                            softcap=softcap)
