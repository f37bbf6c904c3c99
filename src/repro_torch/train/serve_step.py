"""Serving steps of the LM zoo: batched prefill, single-token decode and
the encoder's forward (counterpart of ``repro/train/serve_step.py``).

Each maker returns a plain function over the params tree; nothing is
captured or compiled. Tokens are int32 at the API.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def make_prefill_step(cfg: ModelConfig, max_len: Optional[int] = None):
    """(params, batch) -> (last-position logits [B,V], cache); `batch`
    holds "tokens" and/or the frontend's embeddings."""
    def prefill_step(params, batch):
        return tf.prefill(params, cfg, batch.get("tokens"),
                          batch.get("inputs_embeds"),
                          batch.get("prefix_embeds"), max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, sample: bool = False,
                     temperature: float = 1.0):
    """(params, cache, token [B] int32, gen=None) -> (next token [B] int32,
    logits [B,V], cache): greedy, or with `sample` a draw from
    softmax(logits / temperature) with the ``torch.Generator`` `gen`."""
    def decode_step(params, cache, token, gen: Optional[torch.Generator]
                    = None):
        logits, cache = tf.decode_step(params, cfg, cache, token)
        if sample:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32), logits, cache
    return decode_step


def make_encoder_step(cfg: ModelConfig):
    """Encoder-only (hubert) serving: one bidirectional forward, the
    logits [B,S,V]."""
    def encoder_step(params, batch):
        logits, _ = tf.forward(params, cfg, batch.get("tokens"),
                               batch.get("inputs_embeds"),
                               batch.get("prefix_embeds"))
        return logits
    return encoder_step
