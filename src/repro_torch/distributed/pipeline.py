"""Pipeline parallelism: the GPipe schedule over a mesh axis on
``torch.distributed`` (counterpart of ``repro/distributed/pipeline.py``,
which runs it in ``shard_map`` with ``lax.ppermute``).

Stage s owns a contiguous slice of layers; microbatches stream through the
S stages in M + S − 1 ticks, its bubble fraction (S − 1)/(M + S − 1). At
tick t stage 0 takes microbatch min(t, M − 1) and every other stage what
arrived last tick; a stage whose tick is inactive (t − s outside
[0, M)) gives zeros; every stage passes its output one hop along the ring
s → s + 1 (``sharding.shift``: ``batch_isend_irecv``, staged through the
host under gloo on a card, counted ("p2p", "gpipe")); the last stage
records its finished microbatch t − s; a final ``sharding.psum`` over the
axis (("psum", "gpipe")) replicates the outputs, which only the last stage
holds.

The schedule is differentiable, as the reference's (``ppermute`` has a
transpose): the shift's backward hops the cotangent s → s − 1, and the
psum's passes it through (every rank computes the same loss). So that
every rank runs the same hops backward, the graph is the same on every
rank, as an SPMD program's is: the stage selection and the masks are
tensor ``where``s, and each stage runs ``stage_fn`` on every tick. The
last tick's hop carries nothing anyone reads, so no rank runs its
backward: a forward makes M + S − 1 hops a rank, its backward M + S − 2.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh

SITE = "gpipe"


def gpipe_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  stage_params: Any, x_mb: torch.Tensor, *, mesh: Mesh,
                  axis: str, num_stages: int) -> torch.Tensor:
    """This rank's part of the schedule over `axis` of `mesh`.

    stage_params: this stage's params; x_mb: [M, mb, ...] microbatches
    (the same on every rank; stage 0 reads them). Returns [M, mb, ...],
    the last stage's outputs, on every rank."""
    if mesh.axis_size((axis,)) != num_stages:
        raise ValueError(f"axis {axis!r} has {mesh.axis_size((axis,))} "
                         f"ranks, not {num_stages} stages")
    s = mesh.axis_index((axis,))
    m = x_mb.shape[0]
    flag = lambda b: torch.tensor(bool(b), device=x_mb.device)
    first, last = flag(s == 0), s == num_stages - 1
    buf = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(m)]
    for t in range(m + num_stages - 1):
        # stage 0 ingests microbatch t; the others what arrived last tick
        inp = torch.where(first, x_mb[min(t, m - 1)], buf)
        y = stage_fn(stage_params, inp)
        active = 0 <= t - s < m
        y = torch.where(flag(active), y, torch.zeros_like(y))
        buf = shd.shift(y, mesh, axis, SITE)
        k = min(max(t - s, 0), m - 1)
        outs[k] = torch.where(flag(last and active), y, outs[k])
    return shd.psum(torch.stack(outs), mesh, axis, SITE)


def make_gpipe_fn(stage_fn: Callable, *, mesh: Mesh, axis: str,
                  num_stages: int) -> Callable:
    """f(stacked_stage_params, x_mb) -> outputs: the stacked params'
    leaves are [S·n, ...] (stage s's the s-th of S equal chunks along dim
    0, the reference's ``P(axis)`` spec); each rank keeps its stage's
    chunk (a view, so their grads reach the stacked leaves) and runs
    ``gpipe_forward``."""
    idx = mesh.axis_index((axis,))

    def fn(stacked: Any, x_mb: torch.Tensor) -> torch.Tensor:
        local = tree.map(lambda t: t.chunk(num_stages, 0)[idx], stacked)
        return gpipe_forward(stage_fn, local, x_mb, mesh=mesh, axis=axis,
                             num_stages=num_stages)

    return fn
