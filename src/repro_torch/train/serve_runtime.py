"""Fault-tolerant FNO serving runtime (counterpart of
``repro/train/serve_runtime.py``).

``ResilientServer`` wraps the production ``FNOServer`` (the fused path,
served through CUDA graphs on the card) with the resilience layer a front
end needs:

  * **bounded admission** — ``submit`` sheds load with an explicit
    ``RequestRejected`` once ``queue_limit`` requests are pending; every
    shed is counted.
  * **per-request deadlines** — a request that cannot be answered before
    its deadline raises ``DeadlineExceeded`` instead of holding a slot.
  * **bounded retry with exponential backoff + jitter** — replica-loss
    failures are retried on the surviving replicas (``max_retries``,
    seeded jitter so chaos replays are reproducible).
  * **health-checked replica pool** — replicas are quarantined on any
    fault, health-checked with a canary forward + finite check, and
    reinstated only when the canary passes; killed replicas stay dead.
  * **graceful degradation** — the guarded step catches the ladder's own
    triggers, a ``faults.KernelFault`` and a ``NonFiniteOutput``, and
    re-serves THAT request on the staged path (same cfg,
    ``path="staged"``, run eagerly): the ladder is fused kernels → staged
    PyTorch → reject, and every degradation increments
    ``stats["degraded"]``, so no fallback is silent. Anything else the
    fused path raises (a kernel that fails to build or launch) ends the
    request: the exception leaves ``drain``, and the request stays
    pending. ``FNOServer``, ``kernels.ops`` and ``kernels.engine`` raise
    when a kernel fails, and nothing here hides it. A sticky CUDA error (an
    illegal address) poisons the process's context: it ends the process.
  * **hot checkpoint reload** — ``reload()`` restores params through
    ``Checkpointer`` (``latest_valid_step`` skips corrupt steps), validates
    them with a canary forward BEFORE swapping (``FNOServer.step_with``,
    eager), and rolls back to the serving params on any failure
    (``stats["rollbacks"]``). The swap assigns ``FNOServer.params``, which
    copies the new values into the tensors the graphs captured.

Replicas here are pool *states* sharing one server on one device — a
replica id is the unit of failover/quarantine bookkeeping, which is what
the deterministic fault harness (``distributed/faults.py``) needs. Outputs
come back as host (CPU) tensors, copied inside the guard so that deferred
CUDA errors surface there.
"""
from __future__ import annotations

import collections
import dataclasses
import random
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import FNOConfig
from repro_torch.distributed import faults as flt
from repro_torch.train import serve_fno_step as sfs


class RequestRejected(RuntimeError):
    """Admission control shed this request (queue full)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before an answer was produced."""


class NoHealthyReplica(RuntimeError):
    """Every replica is dead or failed its canary — nothing to serve on."""


class NonFiniteOutput(RuntimeError):
    """A forward produced NaN/Inf — treated like a kernel fault by the
    degradation ladder."""


class ReplicaLost(RuntimeError):
    """The serving replica died mid-request (failover trigger)."""


@dataclasses.dataclass
class ReplicaState:
    """Pool bookkeeping for one replica: healthy | quarantined | dead."""

    id: int
    state: str = "healthy"


class ReplicaPool:
    """Round-robin pool of health-tracked replicas.

    State machine: healthy --fault--> quarantined --canary pass-->
    healthy; healthy --kill--> dead (terminal). ``pick`` rotates over the
    healthy set; when it is empty the caller runs a health sweep first
    and only then gives up.
    """

    def __init__(self, n_replicas: int):
        if n_replicas < 1:
            raise ValueError(f"a pool needs at least one replica, got "
                             f"{n_replicas}")
        self.replicas = [ReplicaState(i) for i in range(n_replicas)]
        self._rr = 0

    def healthy(self) -> List[ReplicaState]:
        return [r for r in self.replicas if r.state == "healthy"]

    def quarantined(self) -> List[ReplicaState]:
        return [r for r in self.replicas if r.state == "quarantined"]

    def pick(self) -> Optional[ReplicaState]:
        live = self.healthy()
        if not live:
            return None
        r = live[self._rr % len(live)]
        self._rr += 1
        return r

    def quarantine(self, r: ReplicaState) -> None:
        if r.state == "healthy":
            r.state = "quarantined"

    def mark_dead(self, r: ReplicaState) -> None:
        r.state = "dead"

    def reinstate(self, r: ReplicaState) -> None:
        if r.state == "quarantined":
            r.state = "healthy"

    def states(self) -> Dict[str, int]:
        out = {"healthy": 0, "quarantined": 0, "dead": 0}
        for r in self.replicas:
            out[r.state] += 1
        return out


def _host_finite(y: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(y on the host, whether it is all finite)."""
    y = y.cpu()
    return y, bool(torch.isfinite(y).all())


class ResilientServer:
    """The guarded, failover-capable front end over ``FNOServer``.

    ``submit``/``drain`` is the primary API (bounded queue, deterministic
    request indices for the fault harness); ``__call__`` is the
    submit-one-drain-one convenience. Every returned output is a finite
    tensor on the host.
    """

    STAT_KEYS = ("accepted", "shed", "served", "degraded", "failovers",
                 "retries", "quarantined", "reinstated", "killed",
                 "deadline_exceeded", "reloads", "rollbacks")

    def __init__(self, cfg: FNOConfig, params, *, device="cuda",
                 replicas: int = 2, variant: str = "full",
                 max_batch: int = 8, queue_limit: int = 16,
                 deadline_s: Optional[float] = None,
                 max_retries: int = 2, backoff_base_s: float = 0.01,
                 backoff_jitter: float = 0.5, seed: int = 0,
                 fault_plan: Optional[flt.FaultPlan] = None,
                 checkpointer=None):
        self.cfg = cfg
        # Production step: the fused path exactly as FNOServer serves it.
        # Degraded step: the staged path on the SAME config, a server of
        # its own (eager), so the production graphs never hold it.
        self.primary = sfs.FNOServer(cfg, params, device=device,
                                     path="fused", variant=variant,
                                     max_batch=max_batch)
        self.fallback = sfs.FNOServer(cfg, params, device=device,
                                      path="staged", variant=variant,
                                      max_batch=max_batch)
        self.params = self.fallback.params
        self.pool = ReplicaPool(replicas)
        self.plan = fault_plan
        self.ckpt = checkpointer
        self.queue_limit = queue_limit
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_jitter = backoff_jitter
        self._rng = random.Random(seed)  # deterministic backoff jitter
        self._pending: Deque[Tuple[int, object, int]] = collections.deque()
        self._req_idx = 0  # accepted-request counter (fault-plan key)
        self.stats: Dict[str, int] = {k: 0 for k in self.STAT_KEYS}
        self._canary = torch.zeros(
            (self.primary.buckets[0], cfg.in_channels) + tuple(cfg.spatial),
            dtype=torch.float32)

    # -- admission ----------------------------------------------------------
    def submit(self, x, rollout_steps: int = 1) -> int:
        """Admit one request batch; returns its request index. Raises
        ``RequestRejected`` (and counts the shed) when the bounded queue is
        full. ``rollout_steps > 1`` asks for the K-step rollout; the guard
        and the ladder apply to the whole trajectory."""
        if len(self._pending) >= self.queue_limit:
            self.stats["shed"] += 1
            raise RequestRejected(
                f"admission queue full ({self.queue_limit} pending) — "
                f"request shed")
        idx = self._req_idx
        self._req_idx += 1
        self._pending.append((idx, x, rollout_steps))
        self.stats["accepted"] += 1
        return idx

    def drain(self) -> List[torch.Tensor]:
        """Serve every pending request in admission order, then run the
        health sweep so quarantined replicas get their canary chance."""
        out = []
        try:
            while self._pending:
                idx, x, steps = self._pending[0]
                y = self._serve_one(idx, x, steps)
                self._pending.popleft()
                self.stats["served"] += 1
                out.append(y)
        finally:
            self.health_sweep()
        return out

    def __call__(self, x, rollout_steps: int = 1) -> torch.Tensor:
        self.submit(x, rollout_steps)
        return self.drain()[-1]

    # -- health -------------------------------------------------------------
    def _canary_ok(self, params=None) -> bool:
        """Canary forward + finite check (the health check / reload
        validation primitive)."""
        try:
            y = self.primary.step_with(
                params if params is not None else self.params, self._canary)
            return _host_finite(y)[1]
        except flt.KernelFault:  # a real build or launch failure raises
            return False

    def health_sweep(self) -> int:
        """Give every quarantined replica one canary; reinstate on pass.
        Returns the number reinstated."""
        n = 0
        for r in self.pool.quarantined():
            if self._canary_ok():
                self.pool.reinstate(r)
                self.stats["reinstated"] += 1
                n += 1
        return n

    # -- the guarded request path ------------------------------------------
    def _check_deadline(self, deadline: Optional[float]) -> None:
        if deadline is not None and time.monotonic() > deadline:
            self.stats["deadline_exceeded"] += 1
            raise DeadlineExceeded(
                f"request missed its {self.deadline_s:.3f}s deadline")

    def _backoff(self, attempt: int) -> None:
        delay = self.backoff_base_s * (2 ** (attempt - 1))
        delay *= 1.0 + self.backoff_jitter * self._rng.random()
        time.sleep(delay)

    def _pick_replica(self) -> ReplicaState:
        r = self.pool.pick()
        if r is None:
            # Last chance: quarantined replicas get their canary now.
            self.health_sweep()
            r = self.pool.pick()
        if r is None:
            raise NoHealthyReplica(
                f"no healthy replica (pool: {self.pool.states()})")
        return r

    def _serve_one(self, idx: int, x, rollout_steps: int = 1
                   ) -> torch.Tensor:
        deadline = (None if self.deadline_s is None
                    else time.monotonic() + self.deadline_s)
        attempt = 0
        while True:
            self._check_deadline(deadline)
            replica = self._pick_replica()
            # Only the serve-time kinds are consumed here; "corrupt_ckpt"
            # records stay pending for the caller (disk faults, applied by
            # faults.corrupt_checkpoint, not request hooks).
            planned = []
            if self.plan:
                for kind in ("delay", "kill", "kernel", "nan"):
                    planned += self.plan.take("serve", idx, kind=kind,
                                              replica=replica.id)
            try:
                for f in planned:
                    if f.kind == "delay":
                        time.sleep(f.delay_s)
                self._check_deadline(deadline)
                if any(f.kind == "kill" for f in planned):
                    self.pool.mark_dead(replica)
                    self.stats["killed"] += 1
                    raise ReplicaLost(
                        f"replica {replica.id} died serving request {idx}")
                if any(f.kind == "kernel" for f in planned):
                    raise flt.KernelFault(
                        f"injected kernel fault on replica {replica.id}, "
                        f"request {idx}")
                # To the host inside the guard: deferred kernel errors
                # surface here, and the finite check needs the values.
                y = self.primary(torch.as_tensor(x), rollout_steps).cpu()
                if any(f.kind == "nan" for f in planned):
                    y = flt.poison_output(y)
                if not bool(torch.isfinite(y).all()):
                    raise NonFiniteOutput(
                        f"non-finite output from replica {replica.id} on "
                        f"request {idx}")
                return y
            except DeadlineExceeded:
                raise
            except ReplicaLost:
                # Failover: bounded retry on the surviving replicas.
                self.stats["failovers"] += 1
                attempt += 1
                if attempt > self.max_retries:
                    raise
                self.stats["retries"] += 1
                self._backoff(attempt)
                continue
            except (flt.KernelFault, NonFiniteOutput) as e:
                # The ladder's triggers only: a real build or launch
                # failure of the fused path is not degraded, it raises.
                self.pool.quarantine(replica)
                self.stats["quarantined"] += 1
                y, finite = _host_finite(
                    self.fallback(torch.as_tensor(x), rollout_steps))
                if finite:
                    self.stats["degraded"] += 1
                    return y
                # Ladder exhausted: fused → staged → reject.
                raise NonFiniteOutput(
                    f"request {idx}: degraded staged path also non-finite "
                    f"(primary fault: {e})") from e

    # -- hot checkpoint reload ---------------------------------------------
    def reload(self, step: Optional[int] = None) -> bool:
        """Hot-swap params from the checkpointer. The candidate is
        validated on a canary forward BEFORE any replica serves it; any
        restore failure (corrupt step, missing step, non-finite canary)
        rolls back to the serving params and returns False."""
        if self.ckpt is None:
            raise RuntimeError("reload() needs a checkpointer "
                               "(ResilientServer(checkpointer=...))")
        if step is None:
            step = self.ckpt.latest_valid_step()
        if step is None:
            self.stats["rollbacks"] += 1
            return False
        try:
            new_params = self.ckpt.restore(step, self.params)
        except Exception:  # noqa: BLE001 — corrupt / missing step
            self.stats["rollbacks"] += 1
            return False
        if not self._canary_ok(new_params):
            self.stats["rollbacks"] += 1
            return False
        self.primary.params = new_params
        self.fallback.params = new_params
        self.params = self.fallback.params
        self.stats["reloads"] += 1
        return True

    # -- introspection ------------------------------------------------------
    def pool_report(self) -> Dict[str, object]:
        """Pool + degradation counters in one dict — what the serve CLI
        prints and what dashboards scrape."""
        return {"replicas": self.pool.states(), **self.stats}
