"""Gradient compression: int8 quantization with error feedback
(counterpart of ``repro/distributed/compression.py``).

``compress`` / ``decompress`` give an int8 form of a tensor (a per-tensor
absmax scale, rounding half to even), equal to the reference's bit for
bit on the same f32 input. ``ef_psum`` wraps a sum over a mesh axis with
error-feedback residuals, so the quantization error is fed back into the
next step (1-bit-Adam-style guarantees). As in the reference, the
dequantised f32 tensor is what is summed (``sharding.all_reduce``, counted
in ``sharding.COLLECTIVES`` as ("psum", "ef")): the int8 form stands for
the wire format of a DCN pod axis; no int8 wire format is sent.

Scope, as the reference's: ``ef_psum`` is not wired into any train step.
``train/train_step.py``'s DP step averages the grads once
(``sharding.mean_over_batch``); an explicit ``ef_psum`` inside it would
reduce them twice. The hook is for a step whose caller owns the
reduction over a multi-pod axis, which no cell of this repo is.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh

_F32 = torch.float32


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 0-d): scale = max|g| / 127 + 1e-12, q =
    clip(round(g / scale), -127, 127)."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(_F32) * scale


def ef_psum(g: torch.Tensor, residual: torch.Tensor, mesh: Mesh,
            axis_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed sum of `g` over `axis_name` of `mesh`.

    Returns (the sum of every rank's dequantised g + residual, the new
    residual: what the quantization lost). Only for a reduction the caller
    owns (see the module docstring)."""
    g32 = g.to(_F32) + residual
    q, scale = compress(g32)
    deq = decompress(q, scale)
    return shd.all_reduce(deq, mesh, (axis_name,), "ef"), g32 - deq


def tree_ef_psum(grads: Any, residuals: Any, mesh: Mesh, axis_name: str
                 ) -> Tuple[Any, Any]:
    """``ef_psum`` of every leaf (one sum a leaf): (summed, residuals)."""
    pairs = [ef_psum(g, r, mesh, axis_name) for g, r in
             zip(tree.leaves(grads), tree.leaves(residuals))]
    return (tree.unflatten(grads, [p[0] for p in pairs]),
            tree.unflatten(residuals, [p[1] for p in pairs]))
