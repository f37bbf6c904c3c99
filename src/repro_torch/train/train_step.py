"""Train-step factories for both model families, the FNO and the LM zoo
(counterpart of ``repro/train/train_step.py``): loss and grads, microbatch
gradient accumulation at ``grad_acc_dtype``, the AdamW update.

An LM config (``ModelConfig``) trains on ``models.transformer.lm_loss``,
``remat`` checkpointing each layer. Microbatches accumulate in the
reference's order: microbatch 0 first, onto zeros at the accumulator's
dtype (``g_acc + g.to(acc)``: under a bf16 accumulator every add rounds
to bf16), the loss summed in f32; both are divided by the count at their
own dtypes. The LM runs on one card: its placement rules are not ported
(ROADMAP Queue A item 5c), so a multi-rank context raises.

On ``fno_path="fused"`` every FNO block trains through the hand-written
kernels: one launch forward (``fno_variant="full"``; "partial" runs the
paper's partial fusion, three launches and the staged tail) and three
backward per block (``kernels.ops.fno_block_nd``). Mixed precision needs
nothing here: params stay f32 masters, the forward and backward run at the
compute dtype inside ``apply_fno`` and the kernels, the casts' backward
hands f32 grads to the params, and the AdamW update is f32.

On a DP×TP mesh (``ctx``, a multi-rank ``ShardingContext``) params and
optimizer state are this rank's shards (``sharding.shard_params``) and the
batch is the global one: each rank takes its DP rows, runs the forward and
backward inside the context, and the grads and the loss are averaged over
the batch axes in one all-reduce, so ``metrics["loss"]`` is the global
batch's; the clip's norm is the full gradient's (``global_norm`` under the
context).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import FNOConfig, torch_dtype
from repro_torch.core import fno as fno_mod
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamW, global_norm


def make_loss_fn(cfg, *, remat: bool = False, fno_path: str = "staged",
                 fno_variant: str = "full") -> Callable:
    """loss_fn(params, batch): ``fno_loss`` for an ``FNOConfig``, else the
    LM's ``lm_loss`` (`remat`: checkpoint each layer)."""
    if isinstance(cfg, FNOConfig):
        def loss_fn(params, batch):
            return fno_mod.fno_loss(params, cfg, batch, path=fno_path,
                                    variant=fno_variant)
        return loss_fn

    def loss_fn(params, batch):
        return tf.lm_loss(params, cfg, batch, remat=remat)
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch, unread=()):
    """(loss, grads): the loss at `params` and its gradient tree, with
    `params` themselves left out of any graph. `unread`: key paths of
    leaves the loss does not read, whose grads are zeros, as ``jax.grad``
    gives them (an LM's ``transformer.unread_leaves``); any other leaf
    the loss does not read raises, as autograd does."""
    unread = set(unread)
    leaves = [p.detach().requires_grad_(path not in unread)
              for path, p in zip(tree.paths(params), tree.leaves(params))]
    read = [p for p in leaves if p.requires_grad]
    with torch.enable_grad():
        loss = loss_fn(tree.unflatten(params, leaves), batch)
        it = iter(torch.autograd.grad(loss, read))
    grads = [next(it) if p.requires_grad else torch.zeros_like(p)
             for p in leaves]
    return loss.detach(), tree.unflatten(params, grads)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg, optimizer: AdamW, *, microbatches: int = 1,
                    remat: bool = False, fno_path: str = "staged",
                    fno_variant: str = "full",
                    grad_acc_dtype: Optional[str] = None,
                    ctx: Optional[shd.ShardingContext] = None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "step"}).

    ctx: a DP×TP sharding context (see the module docstring); params and
    state are then this rank's shards and batch the global batch.
    fno_variant: full or partial fusion of the blocks' forward on the fused
    path (the backward is the same three launches for both).
    grad_acc_dtype: dtype of the microbatch gradient accumulator (default
    the FNO policy's ``grad_acc_dtype``; f32 for an LM).
    remat: an LM's, as ``make_loss_fn`` takes it (an FNO ignores it)."""
    fno = isinstance(cfg, FNOConfig)
    loss_fn = make_loss_fn(cfg, remat=remat, fno_path=fno_path,
                           fno_variant=fno_variant)
    acc_dt = torch_dtype(grad_acc_dtype or (
        cfg.precision.grad_acc_dtype if fno else "float32"))
    ctx = ctx if ctx is not None and ctx.multi_rank else None
    if ctx is not None and not fno:
        raise NotImplementedError(
            f"{cfg.name}: an LM train step on a multi-rank mesh needs the "
            f"LM placement rules, not ported yet (ROADMAP Queue A item 5c)")
    specs = (shd.context_specs(cfg, ctx, fno_mod.abstract_params(cfg))
             if ctx is not None else None)

    def train_step(params, opt_state, batch):
        if ctx is not None:
            batch = {k: shd.local_rows(ctx, v) for k, v in batch.items()}
            with shd.sharding_context(ctx):
                loss, grads = _local_grads(params, batch)
            *flat, loss = shd.mean_over_batch(
                ctx, tree.leaves(grads) + [loss])
            grads = tree.unflatten(grads, flat)
        else:
            loss, grads = _local_grads(params, batch)
        gnorm = global_norm(grads, ctx, specs)
        new_params, new_state = optimizer.update(grads, opt_state, params,
                                                 gnorm)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "step": new_state["step"]}
        return new_params, new_state, metrics

    def _grads(params, batch):
        unread = () if fno else tf.unread_leaves(cfg, batch)
        return value_and_grad(loss_fn, params, batch, unread)

    def _local_grads(params, batch):
        if microbatches == 1:
            loss, grads = _grads(params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32)
            grads = tree.map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device), params)
            for mb in _split_microbatches(batch, microbatches):
                l, g = _grads(params, mb)
                loss = loss.to(l.device) + l
                grads = tree.map(lambda a, b: a + b.to(acc_dt), grads, g)
            loss = loss / microbatches
            grads = tree.map(lambda g: g / microbatches, grads)
        return loss, grads

    return train_step
