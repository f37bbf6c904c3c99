"""The FNO train step (counterpart of the FNO branch of
``repro/train/train_step.py``): loss and grads, microbatch gradient
accumulation at ``grad_acc_dtype``, the AdamW update.

On ``fno_path="fused"`` every FNO block trains through the hand-written
kernels: one launch forward (``fno_variant="full"``; "partial" runs the
paper's partial fusion, three launches and the staged tail) and three
backward per block (``kernels.ops.fno_block_nd``). Mixed precision needs
nothing here: params stay f32 masters, the forward and backward run at the
compute dtype inside ``apply_fno`` and the kernels, the casts' backward
hands f32 grads to the params, and the AdamW update is f32.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import FNOConfig, torch_dtype
from repro_torch.core import fno as fno_mod
from repro_torch.optim.adamw import AdamW, global_norm


def make_loss_fn(cfg: FNOConfig, *, fno_path: str = "staged",
                 fno_variant: str = "full") -> Callable:
    def loss_fn(params, batch):
        return fno_mod.fno_loss(params, cfg, batch, path=fno_path,
                                variant=fno_variant)
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): the loss at `params` and its gradient tree, with
    `params` themselves left out of any graph."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree.unflatten(params, grads)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg: FNOConfig, optimizer: AdamW, *,
                    microbatches: int = 1, fno_path: str = "staged",
                    fno_variant: str = "full",
                    grad_acc_dtype: Optional[str] = None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "step"}).

    fno_variant: full or partial fusion of the blocks' forward on the fused
    path (the backward is the same three launches for both).
    grad_acc_dtype: dtype of the microbatch gradient accumulator (default
    the config policy's ``grad_acc_dtype``)."""
    loss_fn = make_loss_fn(cfg, fno_path=fno_path, fno_variant=fno_variant)
    acc_dt = torch_dtype(grad_acc_dtype or cfg.precision.grad_acc_dtype)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32)
            grads = tree.map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device), params)
            for mb in _split_microbatches(batch, microbatches):
                l, g = value_and_grad(loss_fn, params, mb)
                loss = loss.to(l.device) + l
                grads = tree.map(lambda a, b: a + b.to(acc_dt), grads, g)
            loss = loss / microbatches
            grads = tree.map(lambda g: g / microbatches, grads)
        new_params, new_state = optimizer.update(grads, opt_state, params)
        metrics = {"loss": loss, "grad_norm": global_norm(grads),
                   "step": new_state["step"]}
        return new_params, new_state, metrics

    return train_step
