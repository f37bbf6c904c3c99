"""Modality frontend stubs (counterpart of ``repro/models/frontend.py``):
the transformer backbone is the deliverable, and the frontends provide
precomputed embeddings.

* audio (hubert): frame embeddings [B, T, d] stand in for the conv
  waveform encoder's output;
* vision (internvl2): patch embeddings [B, P, d], prepended to the token
  sequence, stand in for InternViT and its MLP projector.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


def _shapes(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, tuple]:
    if cfg.frontend == "audio":
        return {"inputs_embeds": (batch, seq, cfg.d_model)}
    if cfg.frontend == "vision":
        return {"prefix_embeds": (batch, cfg.num_prefix_embeds, cfg.d_model)}
    return {}


def frontend_inputs(cfg: ModelConfig, shape: ShapeSpec,
                    dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Stand-ins for one batch's modality embeddings: tensors on the "meta"
    device (shape and dtype, no storage)."""
    return {k: torch.empty(s, dtype=dtype, device="meta")
            for k, s in _shapes(cfg, shape.global_batch,
                                shape.seq_len).items()}


def fake_frontend_arrays(cfg: ModelConfig, batch: int, seq: int,
                         gen: torch.Generator, dtype=torch.float32,
                         device="cpu") -> Dict[str, torch.Tensor]:
    """Random embeddings drawn from `gen`, for smoke tests and examples."""
    return {k: torch.randn(s, generator=gen, dtype=dtype, device=device)
            for k, s in _shapes(cfg, batch, seq).items()}
