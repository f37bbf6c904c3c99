"""DP×TP placement and collectives of the FNO (counterpart of the FNO
branch of ``repro/distributed/sharding.py``).

DP shards the batch over the context's batch axes; TP shards the HIDDEN
axis — the fused block's k-loop contraction — over ``"model"`` whenever
the model axis divides ``cfg.hidden``. Each TP rank runs the block kernel
on its hidden slice (``act="linear"``) and the partial pre-activations are
completed by a collective (``kernels.ops.fno_block_nd_sharded``); without
TP the model axis folds into the batch axes and the weights replicate.

The placement is pure: ``make_context``, ``param_specs`` and
``guard_spec`` read only the mesh's shape (``launch.mesh.Mesh``), so a
mesh without a process group serves them. Specs are ``P`` entries, one a
dim: None (replicated), an axis name or a tuple of axis names.

The collectives are ``torch.autograd.Function``s whose backward is the
transpose of the forward under the SPMD convention that every TP rank
computes the same loss from replicated downstream values:

  * ``psum``: all-reduce forward; identity backward (each rank already
    holds the whole cotangent of the sum);
  * ``scatter_sum``: reduce-scatter along a dim forward (rank i keeps chunk
    i of the sum); a tiled all-gather backward;
  * ``ring_scatter_sum``: the same sum as tp-1 point-to-point hops
    (``batch_isend_irecv``), rank i ending with chunk i; the same
    all-gather backward;
  * ``split``: this rank's chunk of a replicated tensor forward; an
    all-gather backward (the whole gradient on every rank);
  * ``shared_input``: identity forward; an all-reduce backward (the
    gradient of a replicated input read by column-parallel weights);
  * ``shift``: one ring hop i -> i+1 forward (``ring_shift``, the GPipe
    schedule's ``ppermute``); the hop i -> i-1 backward.

``COLLECTIVES`` counts every collective a rank issues by (kind, site),
as ``engine.LAUNCHES`` counts kernel launches: kind "psum"
(all-reduce), "reduce_scatter", "all_gather" or "p2p" (one ring hop);
site "block" (a block's TP reduction), "lift", "proj", "grad" (the DP
mean of the grads and the loss), "norm" (the grad norm's TP sum),
"batch" (a server's outputs), "gather" (``gather_params``), "gpipe"
(``distributed.pipeline``'s shifts) or "ef" (``compression.ef_psum``).
Under gloo on a card (``Mesh.host_staged``) each collective copies its
operand to the host and back.

The LM zoo runs on one card: ``shard_activation`` and ``kv_rep`` are the
identity and 1 outside a context and raise under one.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Any, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.launch.mesh import Mesh

COLLECTIVES: collections.Counter = collections.Counter()


class P:
    """A partition spec: one entry a dim (None, an axis, or a tuple of
    axes); equal to another spec, or to a tuple, entry for entry."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self) -> Iterator:
        return iter(self.entries)

    def __eq__(self, other) -> bool:
        return tuple(self) == tuple(other)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"

    @property
    def sharded(self) -> bool:
        return any(e is not None for e in self.entries)


def _axes_of(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


# ---------------------------------------------------------------------------
# The context
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardingContext:
    mesh: Mesh
    batch_axes: Tuple[str, ...]  # ("data",), ("pod", "data"), + "model"
    model_axis: Optional[str] = "model"  # None: TP off (folded into DP)

    @property
    def multi_rank(self) -> bool:
        return self.mesh.size > 1

    @property
    def tp(self) -> int:
        return self.mesh.shape.get(self.model_axis, 1) if self.model_axis \
            else 1

    @property
    def dp(self) -> int:
        return self.mesh.axis_size(self.batch_axes)


_TLS = threading.local()


def current_context() -> Optional[ShardingContext]:
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def sharding_context(ctx: Optional[ShardingContext]):
    prev = current_context()
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


def active_context() -> Optional[ShardingContext]:
    """The current context when it spans more than one rank, else None."""
    ctx = current_context()
    return ctx if ctx is not None and ctx.multi_rank else None


def make_context(cfg, mesh: Mesh, *, kind: str = "train",
                 fno_strategy: Optional[str] = None) -> ShardingContext:
    """The FNO's context on `mesh`: DP over the batch axes, TP over
    "model" when the model axis divides ``cfg.hidden`` (``fno_strategy``
    None or "auto"). ``fno_strategy="dp"`` folds the model axis into the
    batch axes instead (weights replicated, no per-layer collective), and
    an indivisible hidden folds it the same way. ``kind`` ("train" or
    "serve") does not change the FNO's placement."""
    if kind not in ("train", "serve"):
        raise ValueError(f"kind must be 'train' or 'serve', got {kind!r}")
    tp = mesh.shape.get("model", 1)
    batch: Tuple[str, ...] = (("pod", "data") if "pod" in mesh.shape
                              else ("data",))
    tp_on = ((fno_strategy or "auto") != "dp" and tp > 1
             and cfg.hidden % tp == 0)
    if not tp_on and "model" in mesh.shape:
        batch = batch + ("model",)
    return ShardingContext(mesh=mesh, batch_axes=batch,
                           model_axis="model" if tp_on else None)


# ---------------------------------------------------------------------------
# Parameter specs (path-based)
# ---------------------------------------------------------------------------
def _div(n: int, tp: int) -> bool:
    return tp > 0 and n % tp == 0


def _fno_leaf_spec(pstr: str, shape, cfg, tp: int) -> P:
    """TP shards the contraction (hidden) axis: spectral wr/wi [O,H(,k…)]
    shard H, the bypass w [H_in,H_out] its H_in; the lifting MLP is
    column-parallel then row-parallel around the lifting dim, proj1
    row-parallel over hidden; proj2 and the other biases replicate."""
    m = "model"
    h_m = m if _div(cfg.hidden, tp) else None
    lift = cfg.lifting_dim or 2 * cfg.hidden
    l_m = m if _div(lift, tp) else None
    pad = (None,) * max(len(shape) - 2, 0)
    if "spectral" in pstr:
        return P(None, h_m, *pad)
    if "bypass" in pstr:
        return P(h_m, None) if pstr.endswith("/w") else P(None)
    if "lift1" in pstr:
        return P(None, l_m) if pstr.endswith("/w") else P(l_m)
    if "lift2" in pstr:
        return P(l_m, None) if pstr.endswith("/w") else P(None)
    if "proj1" in pstr:
        return P(h_m, None) if pstr.endswith("/w") else P(None)
    return P(*([None] * len(shape)))


def param_specs(cfg, mesh: Mesh, params, fno_tp: bool = True) -> Any:
    """A spec tree with the structure of `params` (tensors at their FULL
    shapes; ``core.fno.abstract_params`` gives them without storage).
    fno_tp=False replicates every leaf (the pure-DP strategy); pass
    ``ctx.model_axis is not None`` from a context-driven caller."""
    tp = mesh.shape.get("model", 1) if fno_tp else 0
    paths = ["/".join(str(k) for k in p) for p in tree.paths(params)]
    specs = [guard_spec(_fno_leaf_spec(pstr, leaf.shape, cfg, tp),
                        leaf.shape, mesh)
             for pstr, leaf in zip(paths, tree.leaves(params))]
    return tree.unflatten(params, specs)


def context_specs(cfg, ctx: ShardingContext, params) -> Any:
    """``param_specs`` as the context places them."""
    return param_specs(cfg, ctx.mesh, params,
                       fno_tp=ctx.model_axis is not None)


def guard_spec(spec: P, shape, mesh: Mesh) -> P:
    """Drop the entries whose axes' product does not divide their dim:
    such a dim replicates (it does not raise)."""
    entries = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            entries.append(None)
            continue
        size = mesh.axis_size(_axes_of(entry))
        entries.append(entry if dim % size == 0 else None)
    return P(*entries)


def shard_params(full, specs, mesh: Mesh) -> Any:
    """This rank's shard of every leaf of `full` (full shapes), as fresh
    contiguous tensors on the mesh's device."""
    def shard(t: torch.Tensor, spec: P) -> torch.Tensor:
        t = torch.as_tensor(t)
        for d, entry in enumerate(spec):
            if entry is not None:
                axes = _axes_of(entry)
                t = t.chunk(mesh.axis_size(axes), d)[mesh.axis_index(axes)]
        return t.to(mesh.device, copy=True).contiguous()
    return tree.map(shard, full, specs)


def gather_params(local, specs, mesh: Mesh) -> Any:
    """The full leaves from every rank's shards (an all-gather over each
    sharded dim's axes); replicated leaves come back as they are."""
    def gather(t: torch.Tensor, spec: P) -> torch.Tensor:
        for d, entry in enumerate(spec):
            if entry is not None:
                t = all_gather(t, d, mesh, _axes_of(entry), "gather")
        return t
    return tree.map(gather, local, specs)


# ---------------------------------------------------------------------------
# The LM zoo on one card
# ---------------------------------------------------------------------------
LM_UNSHARDED = ("the LM zoo runs on one card only: its sharding "
                "(activation specs, KV-head replication, cache specs) is "
                "not ported yet (ROADMAP Queue A item 5)")


def shard_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The LM's activation placement at a layer boundary (`kind`: "embed",
    "heads", "kv", "ffn", "experts", "ssm_inner" or "logits"): the
    identity outside a sharding context; under one it raises, since the
    LM's placement is not ported."""
    if current_context() is not None:
        raise NotImplementedError(f"shard_activation({kind!r}): "
                                  f"{LM_UNSHARDED}")
    return x


def kv_rep() -> int:
    """KV-head replication factor for TP: 1 outside a sharding context;
    under one it raises (LM sharding is not ported)."""
    if current_context() is not None:
        raise NotImplementedError(f"kv_rep: {LM_UNSHARDED}")
    return 1


def effective_kv_heads(cfg) -> int:
    """KV heads a rank holds in its cache (``cfg.num_kv_heads`` times
    ``kv_rep``)."""
    return cfg.num_kv_heads * kv_rep()


# ---------------------------------------------------------------------------
# Batch rows
# ---------------------------------------------------------------------------
def local_rows(ctx: ShardingContext, x: torch.Tensor) -> torch.Tensor:
    """This rank's DP rows of a global batch; every row on every rank
    where the DP degree does not divide the batch (guard_spec's rule)."""
    dp = ctx.dp
    if dp == 1 or x.shape[0] % dp:
        return x
    return x.chunk(dp, 0)[ctx.mesh.axis_index(ctx.batch_axes)]


def gather_rows(ctx: ShardingContext, y: torch.Tensor,
                rows: int) -> torch.Tensor:
    """The global batch of `rows` rows from every rank's ``local_rows``
    output (an all-gather over the batch axes where the rows were split)."""
    dp = ctx.dp
    if dp == 1 or rows % dp:
        return y
    return all_gather(y, 0, ctx.mesh, ctx.batch_axes, "batch")


def mean_over_batch(ctx: ShardingContext, tensors: Sequence[torch.Tensor]
                    ) -> list:
    """Each tensor averaged over the batch axes' ranks in ONE all-reduce
    (in f32), returned at its own dtype."""
    if ctx.dp == 1:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])
    flat = all_reduce(flat, ctx.mesh, ctx.batch_axes, "grad") / ctx.dp
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


# ---------------------------------------------------------------------------
# The collectives (counted; staged through the host under gloo on a card)
# ---------------------------------------------------------------------------
def _single(name: str, old: str):
    # torch >= 2.13 names the single-tensor collectives *_single.
    return getattr(dist, name, None) or getattr(dist, old)


def _host(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The collective's operand: contiguous, and on the host under gloo on
    a card."""
    t = t.detach()
    if mesh.host_staged:
        t = t.cpu()
    return t.contiguous()


def all_reduce(t: torch.Tensor, mesh: Mesh, axes: Sequence[str],
               site: str) -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return t
    buf = _host(t, mesh).clone()
    dist.all_reduce(buf, group=mesh.group(axes))
    COLLECTIVES[("psum", site)] += 1
    return buf.to(t.device)


def all_gather(t: torch.Tensor, dim: int, mesh: Mesh, axes: Sequence[str],
               site: str) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    src = _host(t.movedim(dim, 0), mesh)
    bits = src.dtype == torch.bfloat16  # gathered as bytes: no arithmetic
    if bits:
        src = src.view(torch.uint8)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _single("all_gather_single", "all_gather_into_tensor")(
        out, src, group=mesh.group(axes))
    COLLECTIVES[("all_gather", site)] += 1
    if bits:
        out = out.view(torch.bfloat16)
    return out.to(t.device).movedim(0, dim)


def reduce_scatter(t: torch.Tensor, dim: int, mesh: Mesh,
                   axes: Sequence[str], site: str) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    src = _host(t.movedim(dim, 0), mesh)
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _single("reduce_scatter_single", "reduce_scatter_tensor")(
        out, src, group=mesh.group(axes))
    COLLECTIVES[("reduce_scatter", site)] += 1
    return out.to(t.device).movedim(0, dim)


def ring_reduce_scatter(t: torch.Tensor, dim: int, mesh: Mesh,
                        axes: Sequence[str], site: str) -> torch.Tensor:
    """``reduce_scatter`` as a ring: rank i starts from the chunk furthest
    (ring-wise) from its own and, over n-1 hops, passes its running sum to
    the next rank while adding the chunk the arriving sum stands for; after
    the last hop it holds chunk i of the sum."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    idx = mesh.axis_index(axes)
    ranks = mesh.group_ranks(axes)
    nxt, prv = ranks[(idx + 1) % n], ranks[(idx - 1) % n]
    group = mesh.group(axes)
    chunks = t.detach().chunk(n, dim)
    acc = chunks[(idx + n - 1) % n].contiguous()
    for s in range(2, n + 1):
        send = _host(acc, mesh)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        COLLECTIVES[("p2p", site)] += 1
        acc = recv.to(t.device) + chunks[(idx + n - s) % n]
    return acc


def ring_shift(t: torch.Tensor, mesh: Mesh, axes: Sequence[str],
               site: str, offset: int = 1) -> torch.Tensor:
    """Every rank of the group over `axes` sends `t` to the rank `offset`
    places on (ring-wise) and returns what the rank `offset` places back
    sent it: one hop of ``batch_isend_irecv`` (``lax.ppermute`` with the
    permutation i -> i + offset)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return t
    idx = mesh.axis_index(axes)
    ranks = mesh.group_ranks(axes)
    send = _host(t, mesh)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[(idx + offset) % n],
                      mesh.group(axes)),
           dist.P2POp(dist.irecv, recv, ranks[(idx - offset) % n],
                      mesh.group(axes))]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    COLLECTIVES[("p2p", site)] += 1
    return recv.to(t.device)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, site, offset):
        ctx.args = (mesh, axes, site, -offset)
        return ring_shift(x, mesh, axes, site, offset)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, *ctx.args), None, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, mesh, axes, site):
        return all_reduce(z, mesh, axes, site)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, mesh, axes, dim, site, ring):
        ctx.args = (dim, mesh, axes, site)
        fn = ring_reduce_scatter if ring else reduce_scatter
        return fn(z, dim, mesh, axes, site)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, site):
        ctx.args = (dim, mesh, axes, site)
        n = mesh.axis_size(axes)
        return x.chunk(n, dim)[mesh.axis_index(axes)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None, None


class _SharedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, site):
        ctx.args = (mesh, axes, site)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, *ctx.args), None, None, None


def psum(z: torch.Tensor, mesh: Mesh, axis_name: str = "model",
         site: str = "block") -> torch.Tensor:
    """All-reduce over `axis_name`; the backward passes the cotangent
    through (every TP rank holds all of it)."""
    return _Psum.apply(z, mesh, (axis_name,), site)


def shift(x: torch.Tensor, mesh: Mesh, axis_name: str, site: str,
          offset: int = 1) -> torch.Tensor:
    """``ring_shift`` of `x` along `axis_name`, differentiable: the
    backward shifts the cotangent the other way (``ppermute``'s
    transpose). Every rank must run the same shifts, backward too."""
    return _Shift.apply(x, mesh, (axis_name,), site, offset)


def scatter_sum(z: torch.Tensor, mesh: Mesh, axis_name: str = "model",
                axis: int = 1, site: str = "block") -> torch.Tensor:
    """Reduce-scatter `z` over `axis_name` along `axis` (tiled): rank i
    keeps chunk i of the cross-rank sum; the backward is the all-gather."""
    return _ScatterSum.apply(z, mesh, (axis_name,), axis, site, False)


def ring_scatter_sum(z: torch.Tensor, mesh: Mesh, axis_name: str = "model",
                     axis: int = 1, site: str = "block") -> torch.Tensor:
    """``scatter_sum`` as tp-1 point-to-point hops of 1/tp of `z` each."""
    return _ScatterSum.apply(z, mesh, (axis_name,), axis, site, True)


def split(x: torch.Tensor, mesh: Mesh, axis_name: str = "model",
          axis: int = 1, site: str = "block") -> torch.Tensor:
    """This rank's chunk of a replicated `x` along `axis`; the backward
    all-gathers the chunks' gradients."""
    if mesh.axis_size((axis_name,)) == 1:
        return x
    return _Split.apply(x, mesh, (axis_name,), axis, site)


def shared_input(x: torch.Tensor, mesh: Mesh, axis_name: str = "model",
                 site: str = "lift") -> torch.Tensor:
    """`x` itself; its gradient is all-reduced over `axis_name` (each rank
    holds the part its shard of the weights contributes)."""
    return _SharedInput.apply(x, mesh, (axis_name,), site)
