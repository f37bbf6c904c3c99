"""Deterministic fault-injection harness (counterpart of
``repro/distributed/faults.py``, the port's own copy).

A ``FaultPlan`` is an explicit, ordered list of ``Fault`` records — *this*
request/step, *this* kind of failure, optionally *this* replica — consumed
exactly once each through explicit hooks in the serving runtime
(``train/serve_runtime.py``) and the trainer (``train/trainer.py``). No
monkeypatching: the production code paths ask the plan "does anything go
wrong here?" at well-defined points, so a chaos run is a pure function of
(plan, seed) and every gate (``launch/chaos_smoke.py``) can assert exact
failure counts.

Fault kinds:

  * ``kernel``       — the fused kernel path raises (``KernelFault``) for
    one request/step: the degradation-ladder trigger.
  * ``nan``          — the forward's outputs (serving) or the batch
    (training) are poisoned with NaN: the non-finite-guard trigger.
  * ``delay``        — the serving replica (or train step) stalls for
    ``delay_s``: the deadline / watchdog trigger.
  * ``kill``         — the replica dies mid-request: the failover trigger.
  * ``ckpt_io``      — one checkpoint save attempt raises ``IOError``: the
    save-retry trigger.
  * ``corrupt_ckpt`` — not a hook fault: ``corrupt_checkpoint`` flips real
    bytes in a committed step's ``arrays.npz`` so the checksum manifest
    catches it on restore (the reload-rollback trigger).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

KINDS = ("kernel", "nan", "delay", "kill", "ckpt_io", "corrupt_ckpt")
SCOPES = ("serve", "train")


class KernelFault(RuntimeError):
    """A (simulated or classified) kernel-level failure of the fused path —
    the fault class the degradation ladder catches."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned failure.

    ``at`` is the accepted-request index (scope="serve") or the training
    step (scope="train"); ``replica`` narrows a serve fault to one replica
    id (None = whichever replica handles the request)."""

    kind: str
    at: int
    scope: str = "serve"
    replica: Optional[int] = None
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.scope not in SCOPES:
            raise ValueError(f"unknown fault scope {self.scope!r}")


class FaultPlan:
    """An explicit, deterministic schedule of faults, each fired at most
    once. ``take`` is the single consumption hook: it returns (and marks
    fired) every pending fault matching (scope, at[, kind, replica])."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: List[Fault] = list(faults)
        self._fired = [False] * len(self.faults)

    def take(self, scope: str, at: int, *, kind: Optional[str] = None,
             replica: Optional[int] = None) -> List[Fault]:
        out: List[Fault] = []
        for i, f in enumerate(self.faults):
            if self._fired[i] or f.scope != scope or f.at != at:
                continue
            if kind is not None and f.kind != kind:
                continue
            if (f.replica is not None and replica is not None
                    and f.replica != replica):
                continue
            self._fired[i] = True
            out.append(f)
        return out

    def pending(self) -> List[Fault]:
        return [f for i, f in enumerate(self.faults) if not self._fired[i]]

    def count(self, *, kinds: Optional[Sequence[str]] = None,
              scope: Optional[str] = None) -> int:
        """Planned (not remaining) faults matching the filter — what the
        chaos gates compare observed stats against."""
        return sum(1 for f in self.faults
                   if (kinds is None or f.kind in kinds)
                   and (scope is None or f.scope == scope))


# ---------------------------------------------------------------------------
# poison helpers (the "inject NaN" faults route through these)
# ---------------------------------------------------------------------------
def poison_output(y: torch.Tensor) -> torch.Tensor:
    """NaN-poison a forward output: a copy with its first element NaN (the
    served value is untouched, exactly like a transient numerical blowup
    in one reply)."""
    out = y.clone(memory_format=torch.contiguous_format)
    out.view(-1)[0] = float("nan")
    return out


def poison_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """NaN-poison the input field of a training batch (a copy) — the loss
    and the gradients of the poisoned step go NaN, which the trainer's
    non-finite guard must absorb."""
    out = dict(batch)
    x = torch.as_tensor(batch["x"]).clone(
        memory_format=torch.contiguous_format)
    x.view(-1)[0] = float("nan")
    out["x"] = x
    return out


# ---------------------------------------------------------------------------
# checkpoint corruption (a real on-disk fault, not a hook)
# ---------------------------------------------------------------------------
def corrupt_checkpoint(directory: str, step: int,
                       array: Optional[str] = None) -> str:
    """Flip the payload of one array in ``step_<n>/arrays.npz`` WITHOUT
    updating the manifest — the sha256 check in ``Checkpointer.restore``
    must refuse it (and ``latest_valid_step`` must skip it). Returns the
    corrupted key."""
    path = os.path.join(directory, f"step_{step}", "arrays.npz")
    with np.load(path) as npz:
        data = dict(npz)
    key = array if array is not None else sorted(data)[0]
    arr = np.array(data[key], copy=True)
    if arr.size == 0:  # degenerate: corrupt by dtype-preserving resize
        arr = np.zeros((1,), dtype=arr.dtype)
    else:
        flat = arr.reshape(-1)
        flat[0] = (flat[0] + 1.0 if np.issubdtype(arr.dtype, np.floating)
                   else flat[0] + 1)
    data[key] = arr
    np.savez(path, **data)
    return key


# ---------------------------------------------------------------------------
# canned plans (shared by tests, the chaos gate, and serve --chaos)
# ---------------------------------------------------------------------------
def standard_chaos_plan() -> FaultPlan:
    """The four-way serving chaos plan the gate replays
    (``launch/chaos_smoke.py``, ``launch/serve_fno.py --chaos``): a kernel
    fault on request 0, a NaN injection on request 1, a replica kill on
    request 2, and a checkpoint corruption (applied on disk by the caller
    after serving; its record is kept here so planned and observed counts
    line up)."""
    return FaultPlan([
        Fault("kernel", at=0),
        Fault("nan", at=1),
        Fault("kill", at=2),
        Fault("corrupt_ckpt", at=3),
    ])


def canned_chaos_plans() -> Dict[str, FaultPlan]:
    """Every canned serving chaos plan, by name: whatever the plan injects,
    ``ResilientServer.STAT_KEYS`` must keep summing to the requests
    offered, and degraded/shed/killed must exactly match the plan. Plans
    are built fresh per call (``FaultPlan`` is stateful — fire-once)."""
    return {
        "quiet": FaultPlan([]),
        "standard": standard_chaos_plan(),
        "nan_burst": FaultPlan([Fault("nan", at=0), Fault("nan", at=1),
                                Fault("nan", at=2)]),
        "kill_failover": FaultPlan([Fault("kill", at=0, replica=0),
                                    Fault("kernel", at=2)]),
        "delay": FaultPlan([Fault("delay", at=0, delay_s=0.02),
                            Fault("delay", at=1, delay_s=0.02)]),
    }
