"""AdamW with global-norm clipping (counterpart of ``repro/optim/adamw.py``).

The reference's own update, not ``torch.optim.AdamW`` with
``clip_grad_norm_``: the clip scale is ``min(1, clip/max(‖g‖, 1e-12))``
(PyTorch's is ``max_norm/(‖g‖+1e-6)``), the bias corrections and decoupled
decay ``p − lr·(step + wd·p)`` follow the reference, and the update math is
f32 whatever the state dtype. Params, grads and moments are trees of
tensors (``repro_torch.tree``); ``update`` returns new trees and changes
nothing in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import torch_dtype
from repro_torch.distributed import sharding as shd

_F32 = torch.float32


def global_norm(grads, ctx=None, specs=None) -> torch.Tensor:
    """√(Σ g²) over every leaf, in f32. On a TP mesh (`ctx`, a
    ``distributed.sharding.ShardingContext``, with `specs` from
    ``sharding.param_specs``) `grads` are this rank's shards: the sharded
    leaves' squares are summed over the model axis in one all-reduce and
    each replicated leaf counts once, so every rank gets the norm of the
    full gradient."""
    sq = lambda g: torch.sum(torch.square(g.to(_F32)))
    leaves = tree.leaves(grads)
    if ctx is None or ctx.model_axis is None:
        return torch.sqrt(sum(sq(g) for g in leaves))
    flags = [s.sharded for s in tree.leaves(specs)]
    rep = sum(sq(g) for g, f in zip(leaves, flags) if not f)
    part = sum(sq(g) for g, f in zip(leaves, flags) if f)
    part = shd.all_reduce(part, ctx.mesh, (ctx.model_axis,), "norm")
    return torch.sqrt(rep + part)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Optional[str] = None  # None = like params; else e.g. bf16

    def init(self, params) -> Dict[str, Any]:
        dt = ((lambda p: p.dtype) if self.state_dtype is None
              else (lambda p: torch_dtype(self.state_dtype)))
        zeros = lambda p: torch.zeros(p.shape, dtype=dt(p), device=p.device)
        dev = tree.leaves(params)[0].device
        return {"m": tree.map(zeros, params), "v": tree.map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads, state, params,
               gnorm: Optional[torch.Tensor] = None
               ) -> Tuple[Any, Dict[str, Any]]:
        """New (params, state). `gnorm`, the clip's norm, defaults to
        ``global_norm(grads)``; a sharded step passes the full gradient's."""
        step = state["step"] + 1
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = (torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                             max=1.0)
                 if self.clip_norm else 1.0)
        lr = self.lr(step)
        b1, b2 = self.b1, self.b2
        stepf = step.to(_F32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=_F32, device=stepf.device),
                           stepf)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=_F32, device=stepf.device),
                           stepf)

        def upd(g, m, v, p):
            g = g.to(_F32) * scale
            m32 = b1 * m.to(_F32) + (1 - b1) * g
            v32 = b2 * v.to(_F32) + (1 - b2) * g * g
            step_ = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
            p32 = p.to(_F32)
            newp = p32 - lr * (step_ + self.weight_decay * p32)
            return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

        out = [upd(*a) for a in zip(*(tree.leaves(t) for t in (
            grads, state["m"], state["v"], params)))]
        pick = lambda src, i: tree.unflatten(src, [t[i] for t in out])
        return pick(params, 0), {"m": pick(state["m"], 1),
                                 "v": pick(state["v"], 2), "step": step}
