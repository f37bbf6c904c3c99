"""Meshes over ``torch.distributed`` (counterpart of ``repro/launch/mesh.py``).

A mesh lays the world's ranks out row-major over named axes: ``("data",
"model")`` for DP×TP, ``("pod", "data", "model")`` with a leading pod axis
that composes with data parallelism. DP shards the batch over the batch
axes and TP shards the FNO's hidden axis over ``"model"``
(``distributed/sharding.py``). Every rank holds one process group for each
set of axes: the ranks that differ from it only along those axes (for
``("model",)`` its data row, the TP group; for ``("data",)`` its model
column, the DP group).

The backend is explicit. ``"nccl"`` runs the collectives on CUDA tensors
and needs a card for each rank of the host: two ranks on one card raise,
naming ``"gloo"``, and nothing switches on its own. ``"gloo"`` runs them on
host tensors, so a mesh whose ranks live on a card stages every collective
through the host (``Mesh.host_staged``), a property of the backend that
``collective_plan()["backend"]`` names. A rank's device is
``cuda:{local_rank % device_count}``, or the CPU when asked.

``Mesh(shape)`` alone, without a process group, is a shape: the placement
rules (``sharding.make_context``, ``param_specs``, ``guard_spec``) read
nothing else. ``make_mesh`` joins the world (rank, world size and local
rank from the environment that ``python -m torch.distributed.run`` sets,
or passed in) and builds the groups; ``spawn`` runs a function on ranks of
fresh processes of this host, as the tests and ``chip_smoke.py`` do.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
AXES = ("pod", "data", "model")
TIMEOUT_S = 120.0  # a collective that waits longer than this fails


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named axes over the world's ranks (row-major, last axis fastest).

    ``shape`` maps each axis to its size in mesh order. Without a
    ``backend`` the mesh is a shape only: rank 0, no groups."""

    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def host_staged(self) -> bool:
        """gloo on a card: each collective copies through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(a for a in self.shape if a in axes)

    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        out, r = {}, self.rank
        for a in reversed(list(self.shape)):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return dict(reversed(list(out.items())))

    def axis_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes: Sequence[str]) -> int:
        """This rank's index in the group over `axes` (row-major)."""
        c, i = self.coords(), 0
        for a in self._axes(axes):
            i = i * self.shape[a] + c[a]
        return i

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only
        along `axes`."""
        key = self._axes(axes)
        if self.backend is None:
            raise RuntimeError(f"mesh {self.shape} is a shape only; it has "
                               f"no process groups (use make_mesh)")
        return self.groups[key]

    def group_ranks(self, axes: Sequence[str]) -> List[int]:
        """The world ranks of ``group(axes)``, in group order."""
        return _members(self.shape, self._axes(axes), self.coords())


def _members(shape: Dict[str, int], axes: Tuple[str, ...],
             coords: Dict[str, int]) -> List[int]:
    names = list(shape)
    ranks = []
    for sub in itertools.product(*(range(shape[a]) for a in axes)):
        c = dict(coords, **dict(zip(axes, sub)))
        r = 0
        for a in names:
            r = r * shape[a] + c[a]
        ranks.append(r)
    return ranks


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return given
    if name not in os.environ:
        raise RuntimeError(
            f"make_mesh: {name} is not set; run under python -m "
            f"torch.distributed.run or pass it")
    return int(os.environ[name])


def rank_device(device: str, local_rank: int) -> torch.device:
    """``cuda:{local_rank % device_count}`` for "cuda", the CPU for "cpu"."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh on 'cuda' needs a CUDA device; pass "
                           "device='cpu' to run the plain versions")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def check_backend(backend: str, device: torch.device,
                  local_world: int) -> None:
    """Refuse what the backend cannot do: nccl needs a card for each rank
    of the host and CUDA tensors."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError("backend 'nccl' runs on CUDA tensors; use 'gloo' "
                         "for a mesh on the CPU")
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise ValueError(
            f"backend 'nccl' needs a card for each rank: {local_world} "
            f"ranks of this host share {cards} card(s); use backend "
            f"'gloo' (collectives staged through the host) or fewer ranks")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, backend: str,
              device: str = "cuda", rank: Optional[int] = None,
              world_size: Optional[int] = None,
              local_rank: Optional[int] = None,
              init_method: Optional[str] = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """Join the world (unless this process already has) and lay its ranks
    out as `shape` over `axes`. Rank, world size and local rank come from
    the environment ``torch.distributed.run`` sets (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/PORT) unless passed; ``init_method`` defaults
    to ``env://``. The product of `shape` must be the world size."""
    axes = tuple(axes)
    if len(axes) != len(shape) or any(a not in AXES for a in axes):
        raise ValueError(f"axes {axes} must name {len(shape)} of {AXES}")
    rank = _env_int("RANK", rank)
    world = _env_int("WORLD_SIZE", world_size)
    local = (local_rank if local_rank is not None
             else int(os.environ.get("LOCAL_RANK", rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    dev = rank_device(device, local)
    check_backend(backend, dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    mesh = Mesh(dict(zip(axes, shape)), rank=rank, device=dev,
                backend=backend)
    # Every rank creates every group, in the same order.
    for k in range(1, len(axes)):
        for sub in itertools.combinations(axes, k):
            others = [a for a in axes if a not in sub]
            lists = [_members(mesh.shape, sub, dict(zip(others, c)))
                     for c in itertools.product(
                         *(range(mesh.shape[a]) for a in others))]
            mine, _ = dist.new_subgroups_by_enumeration(lists,
                                                        backend=backend)
            mesh.groups[sub] = mine
    mesh.groups[axes] = dist.group.WORLD
    return mesh


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0) -> Mesh:
    """A ``(data, model)`` mesh (``(pod, data, model)`` with `pod`) as a
    shape only, for the placement rules; ``make_mesh`` joins a world."""
    shape = (pod, data, model) if pod else (data, model)
    return Mesh(dict(zip(AXES if pod else AXES[1:], shape)))


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def n_chips(mesh: Mesh) -> int:
    return mesh.size


def close() -> None:
    """Leave the world (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Ranks of fresh processes on this host
# ---------------------------------------------------------------------------
def free_port() -> int:
    """A free TCP port of the loopback interface (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, init_method: str, out, target,
               args) -> None:
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    torch.set_num_threads(1)  # as torch.distributed.run's OMP default
    try:
        result = target(rank, world, init_method, *args)
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 — sent to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
    finally:
        close()


def spawn(target: Callable, world: int, *args,
          timeout_s: float = 300.0) -> List[Any]:
    """Run ``target(rank, world, init_method, *args)`` on `world` ranks,
    each a fresh process of this host (the ``spawn`` start method) with
    one intra-op thread, and return their results in rank order. `target`
    must be importable by path and its results picklable. A rank that
    raises fails the call with its traceback; a rank that has not
    answered within `timeout_s` fails it too, and every process is
    stopped either way."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init, out, target, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    errors: List[str] = []
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, payload = out.get(timeout=max(min(left, 5.0), 0.1))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and not errors:
                    errors.append(f"rank process exited with code "
                                  f"{dead[0].exitcode} without an answer")
                if errors or left <= 0:
                    break
                continue
            if ok:
                results[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
    finally:
        for p in procs:
            p.join(timeout=10 if not errors and len(results) == world
                   else 0.1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
    if len(results) < world:
        raise TimeoutError(f"{world - len(results)} of {world} ranks did "
                           f"not answer within {timeout_s} s")
    return [results[r] for r in range(world)]
