"""Batched FNO serving on one device: the forward step, the K-step rollout,
request bucketing, and the server (counterpart of
``repro/train/serve_fno_step.py``).

Each request batch is padded to a BUCKET size (a geometric ladder of the
fused kernel's batch block), so the kernel only ever sees a few batch
shapes. A rollout of K steps feeds step t's prediction back as step t+1's
state on the device: the carry never leaves device memory and each step
issues ``num_layers`` block-kernel launches.

On the card the fused path is served through CUDA graphs, the torch
counterpart of the reference's jitted step and its one ``lax.scan``
rollout: ``FNOServer`` captures one graph per (bucket, K, input dtype,
request shape) at first use, so a served forward (K=1) or a whole K-step rollout is one
replay, with no Python dispatch between its launches.

On a DP×TP mesh (``FNOServer(ctx=)``) every rank receives the same request:
each pads it to a bucket (a multiple of the DP degree), runs its DP rows
inside the sharding context (TP over the hidden axis where the context has
it) and all-gathers the outputs over the batch axes. Such a server runs
eagerly: capturing the collectives in a graph is later work.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.configs.base import FNOConfig, torch_dtype
from repro_torch.core import fno as fno_mod
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import engine
from repro_torch.roofline.analysis import fno_collective_bytes


def make_fno_serve_step(cfg: FNOConfig, *, path: Optional[str] = None,
                        variant: str = "full"):
    """serve_step(params, batch{"x": [B,C_in,*spatial]}) -> y."""
    def fno_serve_step(params, batch: Dict[str, torch.Tensor]):
        return fno_mod.apply_fno(params, cfg, batch["x"],
                                 path=path or cfg.path, variant=variant)
    return fno_serve_step


def make_fno_rollout_step(cfg: FNOConfig, *, path: Optional[str] = None,
                          variant: str = "full"):
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
            y = fno_mod.apply_fno(params, cfg, x, path=path or cfg.path,
                                  variant=variant)
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


def serve_quantum(quantum: Optional[int] = None) -> int:
    """The serving bucket quantum, validated against the fused kernel's
    batch block (``engine.BATCH_BLOCK``), as the reference validates it
    against the tuned plan (``tuning.serve_quantum``): None takes the batch
    block itself; an explicit quantum must be a positive multiple of it, or
    the bucket ladder would misalign with the kernel's grid."""
    bb = engine.BATCH_BLOCK
    if quantum is None:
        return bb
    if (isinstance(quantum, bool) or not isinstance(quantum, int)
            or quantum < 1 or quantum % bb != 0):
        raise ValueError(
            f"serve quantum {quantum!r} is not a positive multiple of the "
            f"fused kernel's batch block {bb} (engine.BATCH_BLOCK); use a "
            f"multiple of {bb} or pass quantum=None")
    return quantum


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "FNOServer serves on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions")
    return dev


@dataclasses.dataclass
class _Graph:
    """One captured bucket: the graph, its static input and output, and the
    kernel launches one replay runs, by ``engine.LAUNCHES`` key."""

    graph: "torch.cuda.CUDAGraph"
    x: torch.Tensor
    y: torch.Tensor
    launches: collections.Counter


class FNOServer:
    """Request-batched FNO inference on one device.

    Pads every request batch to a bucket (``bucket_sizes`` over
    ``serve_quantum(quantum)``), runs the forward (or a K-step rollout) on
    ``device`` — the GPU unless the caller asks for the CPU — and keeps
    request/sample/padding counts in ``stats``. ``variant="partial"``
    serves the paper's partial fusion on the fused path.

    **CUDA graphs.** On a CUDA device the fused path (``path`` or
    ``cfg.path`` "fused") is served through one CUDA graph per (bucket, K,
    input dtype, sample shape), captured at first use, so a request at
    another resolution gets graphs of its own: K=1 is the served forward, K>1 the
    whole K-step rollout as one replay. Before the capture the bucket runs
    once eagerly on a side stream, which builds the kernels, plans their
    launches and copies the DFT operands to the device (none of which a
    capture can do). Each bucket keeps a static input buffer: the request
    is copied in and the padding rows are zeroed. A replay overwrites the
    graph's output, so the rows are cloned out before they are returned.
    All graphs of a server share one memory pool. ``engine.LAUNCHES``
    counts in Python and a replay passes through no wrapper, so each graph
    records the launches its capture added, takes them back out (a capture
    runs nothing), and adds them again at every replay: the counts are the
    launches the card ran, the eager warm-up's included. The staged and ref
    oracles, and any path on the CPU, run eagerly: the staged transforms
    copy their operands from the host on every call, which a capture cannot
    hold. There is no switch that turns the graphs off on the card;
    ``step_fn`` and ``step_with`` are the eager forward.

    A graphed server owns its params (a device copy); see ``params``.

    **A mesh.** With ``ctx``, a multi-rank ``ShardingContext``, `params`
    are this rank's shards, the device is the rank's, the quantum is
    multiplied by the DP degree, and every rank serves every request: its
    DP rows inside the context, the outputs all-gathered over the batch
    axes. It runs eagerly (``graphed`` is False).
    """

    def __init__(self, cfg: FNOConfig, params, *, device="cuda",
                 path: Optional[str] = None, variant: str = "full",
                 max_batch: int = 64, quantum: Optional[int] = None,
                 ctx: Optional[shd.ShardingContext] = None):
        self.ctx = ctx if ctx is not None and ctx.multi_rank else None
        self.device = (self.ctx.mesh.device if self.ctx is not None
                       else _device(device))
        self.cfg = cfg
        self.path = path or cfg.path
        q = serve_quantum(quantum)
        step = make_fno_serve_step(cfg, path=path, variant=variant)
        roll = make_fno_rollout_step(cfg, path=path, variant=variant)
        if self.ctx is not None:
            q *= self.ctx.dp  # every bucket splits over the DP ranks
            step, roll = _on_mesh(self.ctx, step), _on_mesh(self.ctx, roll)
        self.buckets = bucket_sizes(max_batch, quantum=q)
        self.step_fn, self.rollout_step_fn = step, roll
        self.graphed = (self.device.type == "cuda" and self.path == "fused"
                        and self.ctx is None)
        self._graphs: Dict[Tuple[int, int, torch.dtype, Tuple[int, ...]],
                           _Graph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self._params = _to_device(params, self.device, copy=self.graphed)
        self.stats = {"requests": 0, "samples": 0, "padded": 0}

    def collective_plan(self) -> Dict[str, object]:
        """The served forward's TP collectives as metadata (the reference's
        ``collective_plan``): the layout, whether the interior
        reduce-scatter runs as the ring (``cfg.tp_overlap``), the per-layer
        kinds, the modeled wire bytes a rank per forward at the smallest
        bucket (``roofline.analysis.fno_collective_bytes``), the backend
        (None on one rank; gloo on a card stages through the host) and
        whether the server replays CUDA graphs."""
        ctx, cfg = self.ctx, self.cfg
        tp_on = ctx is not None and ctx.model_axis is not None
        dp = ctx.dp if ctx is not None else 1
        tp = ctx.tp if tp_on else 1
        layout = cfg.tp_layout if tp_on else None
        scattered = layout == "scatter"
        wire = fno_collective_bytes(cfg, dp, tp, scattered=scattered,
                                    batch=self.buckets[0])
        interior = ("none" if not tp_on else
                    ("ppermute-ring" if scattered and cfg.tp_overlap
                     else "psum_scatter" if scattered else "psum"))
        return {
            "tp_layout": layout, "tp_overlap": tp_on and cfg.tp_overlap,
            "dp": dp, "tp": tp,
            "interior_collective": interior,
            "final_collective": "psum" if tp_on else "none",
            "wire_bytes_per_fwd": wire["total"],
            "wire_bytes_interior_layer": wire["interior_per_layer"],
            "backend": ctx.mesh.backend if ctx is not None else None,
            "graphed": self.graphed,
        }

    @property
    def params(self):
        """The served params (the server's own tensors on its device).

        Assigning new params copies their values into the captured tensors
        in place when the tree's paths, shapes and dtypes match the served
        ones, so the captured graphs go on serving, now with the new
        values; otherwise the graphs are dropped and captured again at next
        use. Either way the next request serves the new params. A graphed
        server copies the caller's tensors and never aliases them."""
        return self._params

    @params.setter
    def params(self, new) -> None:
        new = _to_device(new, self.device)
        if self._graphs and _same_layout(self._params, new):
            with torch.no_grad():
                for dst, src in zip(tree.leaves(self._params),
                                    tree.leaves(new)):
                    dst.copy_(src)
            return
        self._graphs.clear()
        self._params = _to_device(new, self.device, copy=self.graphed)

    def _eager(self, params, xp: torch.Tensor, rollout_steps: int):
        if rollout_steps == 1:
            return self.step_fn(params, {"x": xp})
        return self.rollout_step_fn(params, {"x": xp}, steps=rollout_steps)

    def _capture(self, bucket: int, rollout_steps: int, dtype: torch.dtype,
                 sample: Tuple[int, ...]) -> _Graph:
        x = torch.zeros((bucket,) + sample, dtype=dtype, device=self.device)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):  # warm-up: builds, plans, operands
            self._eager(self._params, x, rollout_steps)
        main.wait_stream(side)
        before = collections.Counter(engine.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            y = self._eager(self._params, x, rollout_steps)
        launches = collections.Counter(engine.LAUNCHES) - before
        engine.LAUNCHES -= launches  # the capture ran nothing
        return _Graph(graph, x, y, launches)

    def _replay(self, chunk: torch.Tensor, bucket: int,
                rollout_steps: int) -> torch.Tensor:
        key = (bucket, rollout_steps, chunk.dtype, tuple(chunk.shape[1:]))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(*key)
        m = chunk.shape[0]
        g.x[:m].copy_(chunk)
        g.x[m:].zero_()
        g.graph.replay()
        engine.LAUNCHES.update(g.launches)
        return g.y[:m].clone()  # the next replay overwrites g.y

    def _bucketed(self, chunk: torch.Tensor, bucket: int,
                  rollout_steps: int) -> torch.Tensor:
        if self.graphed:
            return self._replay(chunk, bucket, rollout_steps)
        xp, m = pad_to_bucket(chunk, bucket)
        return self._eager(self._params, xp, rollout_steps)[:m]

    @torch.no_grad()
    def step_with(self, params, x: torch.Tensor,
                  rollout_steps: int = 1) -> torch.Tensor:
        """One bucketed step (or K-step rollout) with EXPLICIT params
        (instead of ``self.params``), padded as the server pads it and run
        eagerly, never through a graph: the canary hook, through which the
        resilient runtime (``train/serve_runtime.py``) probes candidate
        reload params before it swaps them in, and the eager yardstick of
        the graphs (``step_with(server.params, x, k)``)."""
        b = pick_bucket(x.shape[0], self.buckets)
        xp, m = pad_to_bucket(x.to(self.device), b)
        return self._eager(_to_device(params, self.device), xp,
                           rollout_steps)[:m]

    def warm(self, rollout_steps: Sequence[int] = (1,)) -> None:
        """Serve a float32 zero batch of every bucket at each rollout
        depth: the kernels build and, on the card, every graph is captured
        ahead of traffic."""
        shape = (self.cfg.in_channels,) + tuple(self.cfg.spatial)
        for k in rollout_steps:
            for b in self.buckets:
                self(torch.zeros((b,) + shape, device=self.device),
                     rollout_steps=k)

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
            ys.append(self._bucketed(chunk, b, rollout_steps))
            self.stats["padded"] += b - chunk.shape[0]
        self.stats["requests"] += 1
        self.stats["samples"] += n
        return torch.cat(ys, 0) if len(ys) > 1 else ys[0]


def _on_mesh(ctx: shd.ShardingContext, fn):
    """`fn` (a serve or rollout step) on this rank's DP rows of the padded
    batch, inside the context, its output all-gathered over the batch
    axes."""
    def step(params, batch, **kw):
        x = batch["x"]
        with shd.sharding_context(ctx):
            y = fn(params, {"x": shd.local_rows(ctx, x)}, **kw)
        return shd.gather_rows(ctx, y, x.shape[0])
    return step


def _same_layout(a, b) -> bool:
    """Same key paths, shapes and dtypes, leaf for leaf."""
    la, lb = tree.leaves(a), tree.leaves(b)
    return (tree.paths(a) == tree.paths(b)
            and all(x.shape == y.shape and x.dtype == y.dtype
                    for x, y in zip(la, lb)))


def _to_device(params, device, copy: bool = False):
    """`params` on `device`; ``copy`` makes fresh tensors even where a leaf
    is already there."""
    return tree.map(lambda t: t.to(device, copy=copy), params)
