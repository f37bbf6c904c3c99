"""Launch-plan resolution: override → tuned cache → rule planner
(counterpart of ``repro/tuning/resolve.py``).

``resolve_plan`` is how every fused launch gets its plan
(``engine.pick_plan``, ``pick_wgrad_plan``, the core's launch), field by
field:

1. an explicit override: ``FNOConfig.block_plan``, passed down the
   model's calls as ``plan=`` to every launch (each launch takes the
   fields its kernel has);
2. a fresh tuned entry (``store.lookup`` under ``plans.workload_key``; the
   tuned kinds only, batches up to 8, the entry's probe shape);
3. the rule planner (``engine.plan_launch``: ``launch_plan``,
   ``wgrad_plan``, the core's library, the cluster by waves).

An override the planner refuses raises ``ValueError`` naming the field; it
never falls back. A cached field the planner refuses is dropped (the
entry is stale, ``store.check_tuning_cache`` says so) and the rule plans
the launch. ``engine.FORCED`` (``engine.forced_chain``), the measurement
scripts' tool, wins over all three, in the pickers.

The cache file is read once and kept; resolving reads no file after the
first launch, allocates nothing on the card and does not synchronise, so
a CUDA graph captured after an eager warm-up (``FNOServer``) replays the
plans the warm-up resolved.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tuning import plans as P
from repro_torch.tuning import store


@dataclasses.dataclass(frozen=True)
class Resolved:
    """One launch's plan, where each pinned field came from ("override" /
    "cache"; the rest are the rule planner's), and its cache key (None
    where no entry can serve it)."""

    plan: Dict[str, Any]
    sources: Dict[str, str]
    key: Optional[str]

    @property
    def source(self) -> str:
        """"override" if any field came from one, else "cache" if any came
        from the cache, else "rule"."""
        for s in ("override", "cache"):
            if s in self.sources.values():
                return s
        return "rule"


def _fields(kind: str, override) -> Dict[str, Any]:
    """The override's fields that `kind`'s kernel has."""
    from repro_torch.kernels import engine
    have = engine.PLAN_FIELDS[engine.kernel_of(kind)]
    return {k: v for k, v in (P.normalize_override(override) or ())
            if k in have}


def resolve_plan(kind: str, dtype, batch: int, hidden: int, out: int,
                 spatial, modes, per_mode: bool = False, override=None, *,
                 lib=None, ends: Optional[Tuple[int, int, int, int]] = None,
                 cache_path: Optional[str] = None,
                 use_cache: bool = True) -> Resolved:
    """The plan of one launch of `kind` (``engine.launch_kind``'s names)
    at this batch and shape, resolved field by field (module doc). dtype:
    a torch dtype or a policy name; `lib` the kernel's library (the card's
    occupancy for the rule's cluster; the core's plan), None off the card.
    use_cache=False skips the cache (an untuned launch)."""
    from repro_torch.kernels import engine

    if isinstance(dtype, str):
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}.get(
            dtype) or getattr(torch, dtype)
    spatial, modes = tuple(spatial), tuple(modes)
    ov = _fields(kind, override)
    key = (P.workload_key(kind, dtype, batch, hidden, out, spatial, modes,
                          per_mode)
           if use_cache and ends is None else None)
    cached = store.lookup(key, hidden, out, spatial, modes, cache_path) or {}
    plan_at = lambda pins: engine.plan_launch(
        kind, dtype, batch, hidden, out, spatial, modes, per_mode, pins,
        lib=lib, ends=ends)
    pins = {**cached, **ov}
    try:
        plan = plan_at(pins)
    except engine.PlanRefused as exc:
        if not cached or (exc.field is not None and set(
                exc.field.split(",")) & set(ov)):
            raise
        pins = dict(ov)  # a stale entry: the rule plans in its place
        plan = plan_at(pins)
    sources = {k: "override" if k in ov else "cache" for k in pins}
    return Resolved(plan, sources, key)

