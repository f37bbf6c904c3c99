"""Continuous-batching serving tier (counterpart of
``repro/train/serve_queue.py``).

``FNOServer`` answers one request batch at a time; a real front end sees
many small concurrent per-user requests. ``ContinuousBatchingServer`` sits
on top of a (resilient) server and coalesces those requests into the
buckets the engine serves (``serve_fno_step.bucket_sizes``; on the card
one CUDA graph each), with:

  * **bounded admission** — ``submit`` sheds with ``RequestRejected``
    once ``queue_limit`` requests are pending; every shed is counted.
  * **per-request timestamps** — enqueue → dispatch → complete, so p50/
    p99 latency and queue-depth accounting fall out of the request
    records.
  * **deadline-aware batch formation** — the queue may hold a non-full
    bucket for up to ``coalesce_s`` to admit more requests, but NEVER
    past the point where a queued request's deadline could no longer be
    met; a request whose deadline cannot be met at dispatch time is
    failed with ``DeadlineExceeded``, never served late.
  * **rollout batching** — requests carry ``rollout_steps``; a batch is
    formed only within one rollout depth (one graph a depth), FIFO within
    the bucket.

"Async" here is a cooperative event loop, not threads. The clock is
injectable: ``replay`` drives the tier on a ``VirtualClock`` with a
deterministic ``service_model`` ((bucket, rollout_steps) -> seconds), so
a seeded arrival schedule (``poisson_schedule``, drawn as the reference
draws it) yields EXACT shed/coalesce counts, the reference's for the same
schedule and model, while every formed batch still executes for real. On
a live deployment the clock is ``time.monotonic``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.train.serve_fno_step import pick_bucket
from repro_torch.train.serve_runtime import DeadlineExceeded, RequestRejected

QUEUE_STATS = ("offered", "accepted", "shed", "completed",
               "deadline_exceeded", "failed", "batches", "coalesced")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request of a traffic replay: ``n`` samples arriving
    at time ``t`` (seconds on the replay clock), asking for a
    ``rollout_steps``-deep trajectory within ``deadline_s``."""

    t: float
    n: int
    rollout_steps: int = 1
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class QueuedRequest:
    """One admitted request and its full lifecycle record."""

    idx: int
    n: int
    x: Any
    rollout_steps: int = 1
    deadline_t: Optional[float] = None  # absolute, on the server's clock
    t_enqueue: float = 0.0
    t_dispatch: Optional[float] = None
    t_complete: Optional[float] = None
    status: str = "queued"  # queued | done | deadline | failed
    y: Any = None
    error: Optional[str] = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_complete is None:
            return None
        return self.t_complete - self.t_enqueue


class VirtualClock:
    """Monotonic virtual time for deterministic replays: ``now`` reads
    it, the event loop advances it — wall time never enters."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> float:
        self._t = max(self._t, float(t))
        return self._t


def poisson_schedule(seed: int, requests: int, *, rate_hz: float,
                     max_n: int, rollout_steps: int = 1,
                     deadline_s: Optional[float] = None,
                     rollout_choices: Optional[Sequence[int]] = None
                     ) -> List[Arrival]:
    """Seeded Poisson-ish arrival schedule: exponential inter-arrival
    times at ``rate_hz``, request sizes uniform on [1, max_n]. A pure
    function of the seed — no wall-clock randomness, so every replay of
    the same schedule produces the same admission/coalescing decisions.
    ``rollout_choices`` mixes rollout depths across requests (uniform)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=requests)
    ts = np.cumsum(gaps)
    ns = rng.integers(1, max_n + 1, size=requests)
    if rollout_choices:
        steps = rng.choice(np.asarray(rollout_choices), size=requests)
    else:
        steps = np.full(requests, rollout_steps)
    return [Arrival(float(t), int(n), int(k), deadline_s)
            for t, n, k in zip(ts, ns, steps)]


class ContinuousBatchingServer:
    """Coalescing request queue over a batched (resilient) server.

    ``server`` is any callable ``server(x, rollout_steps=k) -> y`` over
    ``[n, C, *spatial]`` tensor batches — an ``FNOServer``, a
    ``ResilientServer``, or a test double. ``buckets`` defaults to the
    server's own ladder (``server.buckets``, or ``server.primary.buckets``
    for the resilient runtime) so the queue coalesces to exactly the
    batch shapes the server's graphs hold.

    Batch-formation policy: the FIFO prefix of the
    queue sharing the head request's ``rollout_steps``, cut off at the
    largest bucket (a single oversize request rides alone — the engine
    chunks it). With a ``service_model`` the tier is deadline-aware at
    formation time: members whose deadline precedes the batch's modeled
    completion are failed with ``DeadlineExceeded`` instead of served
    late; without a model (live mode) the check degrades to
    already-expired-at-dispatch.
    """

    def __init__(self, server, *, buckets: Optional[Sequence[int]] = None,
                 queue_limit: int = 64, coalesce_s: float = 0.0,
                 clock=None,
                 service_model: Optional[Callable[[int, int], float]] = None):
        self._server = server
        if buckets is None:
            inner = getattr(server, "buckets", None)
            if inner is None:
                inner = getattr(getattr(server, "primary", None),
                                "buckets", None)
            if inner is None:
                raise ValueError(
                    "ContinuousBatchingServer: pass buckets= explicitly — "
                    "the server exposes no bucket ladder")
            buckets = inner
        self.buckets: Tuple[int, ...] = tuple(buckets)
        self.queue_limit = queue_limit
        self.coalesce_s = coalesce_s
        self.clock = clock if clock is not None else time.monotonic
        self._now = (self.clock.now if isinstance(self.clock, VirtualClock)
                     else self.clock)
        self.service_model = service_model
        self._queue: Deque[QueuedRequest] = collections.deque()
        self.requests: Dict[int, QueuedRequest] = {}
        self._next_idx = 0
        self.stats: Dict[str, int] = {k: 0 for k in QUEUE_STATS}
        self.depth_trace: List[Tuple[float, int]] = []

    # -- admission ----------------------------------------------------------
    def submit(self, x, *, rollout_steps: int = 1,
               deadline_s: Optional[float] = None) -> int:
        """Admit one request of ``x.shape[0]`` samples; returns its
        request index. Sheds with ``RequestRejected`` when ``queue_limit``
        requests are already pending."""
        now = self._now()
        self.stats["offered"] += 1
        if len(self._queue) >= self.queue_limit:
            self.stats["shed"] += 1
            raise RequestRejected(
                f"continuous-batching queue full ({self.queue_limit} "
                f"pending) — request shed")
        r = QueuedRequest(
            idx=self._next_idx, n=int(x.shape[0]), x=x,
            rollout_steps=int(rollout_steps), t_enqueue=now,
            deadline_t=None if deadline_s is None else now + deadline_s)
        self._next_idx += 1
        self._queue.append(r)
        self.requests[r.idx] = r
        self.stats["accepted"] += 1
        self._sample_depth(now)
        return r.idx

    def result(self, idx: int) -> QueuedRequest:
        return self.requests[idx]

    def queue_depth(self) -> int:
        return len(self._queue)

    def _sample_depth(self, t: float) -> None:
        self.depth_trace.append((t, len(self._queue)))

    # -- batch formation ----------------------------------------------------
    def _head_group(self) -> List[QueuedRequest]:
        """FIFO prefix sharing the head's rollout depth, cut at the
        largest bucket (the head alone may exceed it — the engine
        chunks)."""
        if not self._queue:
            return []
        top = self.buckets[-1]
        steps = self._queue[0].rollout_steps
        group, total = [], 0
        for r in self._queue:
            if r.rollout_steps != steps:
                break
            if group and total + r.n > top:
                break
            group.append(r)
            total += r.n
        return group

    def _service_est(self, total_n: int, steps: int) -> float:
        """Modeled service seconds for ``total_n`` samples (chunked at
        the largest bucket exactly as the engine will). 0.0 without a
        service model — live mode measures instead of predicting."""
        if self.service_model is None:
            return 0.0
        top = self.buckets[-1]
        est, left = 0.0, total_n
        while left > 0:
            chunk = min(left, top)
            est += self.service_model(pick_bucket(chunk, self.buckets),
                                      steps)
            left -= chunk
        return est

    # -- dispatch -----------------------------------------------------------
    def _dispatch(self, now: float) -> Tuple[List[QueuedRequest], float]:
        """Form and serve one batch at time ``now``. Returns (handled
        requests, engine-free time). Deadline-doomed members are failed
        (``DeadlineExceeded``) instead of served late."""
        group = self._head_group()
        if not group:
            return [], now
        steps = group[0].rollout_steps
        est = self._service_est(sum(r.n for r in group), steps)
        keep: List[QueuedRequest] = []
        handled: List[QueuedRequest] = []
        for r in group:
            self._queue.remove(r)
            doomed = (r.deadline_t is not None
                      and r.deadline_t < now + est)
            if doomed:
                r.status, r.t_complete = "deadline", now
                r.error = (f"request {r.idx} deadline at "
                           f"t={r.deadline_t:.4f}s unreachable from "
                           f"dispatch t={now:.4f}s (+{est:.4f}s service)")
                self.stats["deadline_exceeded"] += 1
                handled.append(r)
            else:
                keep.append(r)
        if not keep:
            self._sample_depth(now)
            return handled, now
        # Re-estimate on the survivors: dropping members can only shrink
        # the batch, so every kept deadline stays reachable.
        est = self._service_est(sum(r.n for r in keep), steps)
        for r in keep:
            r.t_dispatch = now
        x = torch.cat([torch.as_tensor(r.x) for r in keep], 0)
        self.stats["batches"] += 1
        self.stats["coalesced"] += len(keep) - 1
        try:
            y = torch.as_tensor(self._server(x, rollout_steps=steps))
        except Exception as e:  # noqa: BLE001 — the tier records, not raises
            t_done = now + est if self.service_model else self._now()
            for r in keep:
                r.status, r.t_complete, r.error = "failed", t_done, str(e)
                self.stats["failed"] += 1
            self._sample_depth(t_done)
            return handled + keep, t_done
        t_done = now + est if self.service_model else self._now()
        off = 0
        for r in keep:
            r.y = y[off:off + r.n]
            off += r.n
            r.status, r.t_complete = "done", t_done
            self.stats["completed"] += 1
        handled += keep
        self._sample_depth(t_done)
        return handled, t_done

    def pump(self) -> List[QueuedRequest]:
        """Serve one batch if any work is queued (live-mode heartbeat)."""
        return self._dispatch(self._now())[0]

    def drain(self) -> List[QueuedRequest]:
        """Serve until the queue is empty; returns every handled
        request. After a drain the conservation invariant holds:
        accepted == completed + deadline_exceeded + failed."""
        out: List[QueuedRequest] = []
        while self._queue:
            out += self._dispatch(self._now())[0]
        return out

    # -- deterministic traffic replay --------------------------------------
    def replay(self, schedule: Sequence[Arrival],
               input_fn: Callable[[Arrival, int], Any]) -> Dict[str, Any]:
        """Drive the whole tier through a seeded arrival schedule on the
        virtual clock. ``input_fn(arrival, index) -> x`` materializes each
        request's samples (seed it — the replay adds no randomness).

        Event loop: requests arriving while the engine is busy coalesce;
        when the engine frees, the head group dispatches unless holding
        for the next arrival both fits ``coalesce_s`` AND keeps every
        queued deadline reachable (the don't-coalesce-past-a-deadline
        rule). Requires a ``VirtualClock`` and a ``service_model``."""
        if not isinstance(self.clock, VirtualClock):
            raise ValueError("replay() needs clock=VirtualClock(...)")
        if self.service_model is None:
            raise ValueError("replay() needs a deterministic service_model")
        order = sorted(range(len(schedule)), key=lambda i: schedule[i].t)
        seq = [schedule[i] for i in order]
        i, engine_free = 0, 0.0

        def admit(k: int) -> None:
            a = seq[k]
            self.clock.advance_to(a.t)
            try:
                self.submit(input_fn(a, k), rollout_steps=a.rollout_steps,
                            deadline_s=a.deadline_s)
            except RequestRejected:
                pass  # counted in stats["shed"]

        while i < len(seq) or self._queue:
            if not self._queue:
                admit(i)
                i += 1
                continue
            t_ready = max(self.clock.now(), engine_free)
            # Arrivals landing while the engine is busy join the queue.
            while i < len(seq) and seq[i].t <= t_ready:
                admit(i)
                i += 1
            group = self._head_group()
            total = sum(r.n for r in group)
            if total < self.buckets[-1] and i < len(seq):
                hold = t_ready + self.coalesce_s
                est = self._service_est(total, group[0].rollout_steps)
                dls = [r.deadline_t for r in group
                       if r.deadline_t is not None]
                if dls:
                    hold = min(hold, min(dls) - est)
                if seq[i].t <= hold:
                    admit(i)
                    i += 1
                    continue
            self.clock.advance_to(t_ready)
            _, engine_free = self._dispatch(t_ready)
        return self.report()

    # -- accounting ---------------------------------------------------------
    def latency_summary(self) -> Dict[str, float]:
        """p50/p99/mean/max enqueue→complete latency (seconds) over the
        COMPLETED requests (shed and deadline-failed requests have no
        service latency; they are accounted in stats)."""
        lats = [r.latency_s for r in self.requests.values()
                if r.status == "done"]
        if not lats:
            return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0,
                    "count": 0}
        arr = np.asarray(lats, np.float64)
        return {"p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)),
                "mean": float(arr.mean()), "max": float(arr.max()),
                "count": int(arr.size)}

    def depth_summary(self) -> Dict[str, float]:
        """p50/p99/max queue depth over the event-sampled depth trace."""
        if not self.depth_trace:
            return {"p50": 0.0, "p99": 0.0, "max": 0.0, "samples": 0}
        d = np.asarray([n for _, n in self.depth_trace], np.float64)
        return {"p50": float(np.percentile(d, 50)),
                "p99": float(np.percentile(d, 99)),
                "max": float(d.max()), "samples": int(d.size)}

    def report(self) -> Dict[str, Any]:
        """Stats + latency + queue-depth in one dict (what the replay
        benchmark rows and the smoke gate read)."""
        done = [r for r in self.requests.values() if r.status == "done"]
        samples = sum(r.n for r in done)
        span = (max(r.t_complete for r in done)
                - min(r.t_enqueue for r in done)) if done else 0.0
        return {"stats": dict(self.stats),
                "latency": self.latency_summary(),
                "queue_depth": self.depth_summary(),
                "served_samples": samples,
                "makespan_s": float(span)}
