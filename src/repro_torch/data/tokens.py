"""Synthetic LM token stream: deterministic, stateless, host-shardable
(counterpart of ``repro/data/tokens.py``).

Batch `i` is a pure function of (seed, i, shard): after a failover any
replacement host regenerates exactly its shard, so a checkpoint needs no
data-loader state beyond the step counter. Tokens follow a Zipf law
(``zipf_logits``: p(rank r) ∝ r^-1.1), so losses move as on text rather
than on uniform noise.

The drawing is factored in two, as ``data/pde.py``'s is:

* ``tokens_from_gumbels(gumbels, logits)`` is the reference's sampler,
  Gumbel-max (``jax.random.categorical`` is ``argmax(gumbel + logits)``):
  fed the reference's own noise it returns the reference's tokens bit for
  bit. It needs ``[b, S+1, V]`` noise, about 10 GB of f32 at qwen2's
  vocabulary, batch 4 and 4096 tokens, so only tests call it;
* ``token_batch`` samples the same law by inverse CDF: uniforms drawn on
  the CPU from an explicit ``torch.Generator`` seeded by (seed, index,
  shard), looked up in the cumulative probabilities (``torch.searchsorted``)
  and moved to `device`. It never forms a ``[.., V]`` tensor a token, and
  a batch is the same on every device. torch and JAX draw different
  numbers, so its tokens are not the reference's.

Tokens and labels are int32, as the reference's (the embedding lookup
takes any integer dtype).
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch


def zipf_logits(vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1)
    return (-1.1 * np.log(ranks)).astype(np.float32)


def tokens_from_gumbels(gumbels: torch.Tensor, logits: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    """The reference's batch from its Gumbel noise: `gumbels` [b, S+1, V]
    (``jax.random.gumbel`` of the batch's key) plus `logits` [V], the
    first maximum along V (``argmax`` in both packages), split into
    tokens [b, S] and next-token labels [b, S]."""
    toks = torch.argmax(gumbels + logits, dim=-1).to(torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@functools.lru_cache(maxsize=4)
def _cdf(vocab: int) -> torch.Tensor:
    """The Zipf law's cumulative probabilities [V] in float64 (the softmax
    of ``zipf_logits``), the last one exactly 1."""
    p = np.exp(zipf_logits(vocab).astype(np.float64))
    cdf = np.cumsum(p / p.sum())
    cdf[-1] = 1.0
    return torch.from_numpy(cdf)


def _generator(seed: int, index: int, shard: int) -> torch.Generator:
    """The generator of batch `index`, shard `shard`, of a run seeded
    `seed` (the three mixed by numpy's ``SeedSequence``)."""
    state = np.random.SeedSequence([seed, index, shard]).generate_state(
        2, dtype=np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


def token_batch(seed: int, index: int, batch: int, seq_len: int, vocab: int,
                shard: int = 0, num_shards: int = 1, device="cpu"
                ) -> Dict[str, torch.Tensor]:
    """{"tokens": [b, S], "labels": [b, S]} int32 for this host's shard
    (b = batch / num_shards) on `device`: S + 1 Zipf tokens a row, the
    labels the tokens shifted by one."""
    if batch % num_shards:
        raise ValueError(f"batch {batch} does not split into {num_shards} "
                         f"shards")
    b = batch // num_shards
    u = torch.rand((b, seq_len + 1), generator=_generator(seed, index, shard),
                   dtype=torch.float64)
    toks = torch.searchsorted(_cdf(vocab), u, right=True)
    toks = torch.clamp(toks, max=vocab - 1).to(torch.int32).to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
