"""Batched FNO serving on one device: the forward step, the K-step rollout,
request bucketing, and the server (counterpart of
``repro/train/serve_fno_step.py``).

Each request batch is padded to a BUCKET size (a geometric ladder of the
fused kernel's batch block), so the kernel only ever sees a few batch
shapes. A rollout of K steps feeds step t's prediction back as step t+1's
state in a loop on the device: the carry never leaves device memory and
each step issues ``num_layers`` block-kernel launches.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FNOConfig, torch_dtype
from repro_torch.core import fno as fno_mod
from repro_torch.kernels.engine import BATCH_BLOCK


def make_fno_serve_step(cfg: FNOConfig, *, path: Optional[str] = None):
    """serve_step(params, batch{"x": [B,C_in,*spatial]}) -> y."""
    def fno_serve_step(params, batch: Dict[str, torch.Tensor]):
        return fno_mod.apply_fno(params, cfg, batch["x"],
                                 path=path or cfg.path)
    return fno_serve_step


def make_fno_rollout_step(cfg: FNOConfig, *, path: Optional[str] = None):
    """rollout(params, batch{"x": [B,C_in,*spatial]}, steps=K) -> y_K.

    Autoregressive rollout on the device: the prediction replaces the
    first ``out_channels`` channels of the state and the trailing
    conditioning channels (coordinate grids) persist across steps.
    Requires ``out_channels <= in_channels``."""
    if cfg.out_channels > cfg.in_channels:
        raise ValueError(
            f"rollout needs out_channels <= in_channels to feed step t's "
            f"output back as step t+1's state, got {cfg.out_channels} > "
            f"{cfg.in_channels} for {cfg.name}")
    keep = cfg.in_channels - cfg.out_channels

    def fno_rollout_step(params, batch: Dict[str, torch.Tensor], *,
                         steps: int) -> torch.Tensor:
        # Cast once so the carry dtype is invariant across steps.
        x = batch["x"].to(torch_dtype(cfg.precision.compute_dtype))
        for _ in range(steps):
            y = fno_mod.apply_fno(params, cfg, x, path=path or cfg.path)
            x = torch.cat([y, x[:, cfg.out_channels:]], 1) if keep else y
        return x[:, :cfg.out_channels]
    return fno_rollout_step


def bucket_sizes(max_batch: int, *, quantum: int = 1) -> Tuple[int, ...]:
    """Geometric bucket ladder (quantum, 2q, 4q, … ≥ max_batch)."""
    q = max(quantum, 1)
    sizes = [q]
    while sizes[-1] < max_batch:
        sizes.append(sizes[-1] * 2)
    return tuple(sizes)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n (the largest bucket for oversize batches — the
    caller chunks those)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def pad_to_bucket(x: torch.Tensor, bucket: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad the batch axis to `bucket`; returns (padded, n_valid)."""
    n = x.shape[0]
    if n == bucket:
        return x, n
    return F.pad(x, [0, 0] * (x.ndim - 1) + [0, bucket - n]), n


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "FNOServer serves on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions")
    return dev


class FNOServer:
    """Request-batched FNO inference on one device.

    Pads every request batch to a bucket (``bucket_sizes`` over the fused
    kernel's batch block), runs the forward (or a K-step rollout) on
    ``device`` — the GPU unless the caller asks for the CPU — and keeps
    request/sample/padding counts in ``stats``.
    """

    def __init__(self, cfg: FNOConfig, params, *, device="cuda",
                 path: Optional[str] = None, max_batch: int = 64):
        self.device = _device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.buckets = bucket_sizes(max_batch, quantum=BATCH_BLOCK)
        self.step_fn = make_fno_serve_step(cfg, path=path)
        self.rollout_step_fn = make_fno_rollout_step(cfg, path=path)
        self.stats = {"requests": 0, "samples": 0, "padded": 0}

    def _bucketed(self, xp: torch.Tensor, rollout_steps: int):
        if rollout_steps == 1:
            return self.step_fn(self.params, {"x": xp})
        return self.rollout_step_fn(self.params, {"x": xp},
                                    steps=rollout_steps)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, rollout_steps: int = 1):
        """Serve one request batch x [n, C_in, *spatial] -> [n, C_out, …]
        on the server's device. ``rollout_steps > 1`` returns the FINAL
        step of a K-step rollout. Oversize batches are chunked at the
        largest bucket; an empty batch returns an empty output."""
        if rollout_steps < 1:
            raise ValueError(f"rollout_steps must be >= 1, "
                             f"got {rollout_steps}")
        n = x.shape[0]
        if n == 0:
            return torch.zeros(
                (0, self.cfg.out_channels) + tuple(x.shape[2:]),
                dtype=torch_dtype(self.cfg.precision.compute_dtype),
                device=self.device)
        x = x.to(self.device)
        top = self.buckets[-1]
        ys = []
        for s in range(0, n, top):
            chunk = x[s:s + top]
            b = pick_bucket(chunk.shape[0], self.buckets)
            xp, m = pad_to_bucket(chunk, b)
            ys.append(self._bucketed(xp, rollout_steps)[:m])
            self.stats["padded"] += b - m
        self.stats["requests"] += 1
        self.stats["samples"] += n
        return torch.cat(ys, 0) if len(ys) > 1 else ys[0]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)
