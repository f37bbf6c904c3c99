"""Tuning keys and plan overrides: the vocabulary of the launch-plan tuner
(counterpart of ``repro/tuning/plans.py``).

A launch's *plan* is its kernel's plan fields (``engine.PLAN_FIELDS``):
the block kernel's ``cluster``, ``chain``, ``rows_f`` and ``rows_i``, the
wgrad kernel's ``cluster``, ``chain``, ``rows_f`` and ``cols``, both
kernels' tiling ``hc`` (hidden channels a block holds at once) and ``ot``
(out tiles), the core's ``engine.CORE_LAUNCH``. An *override* is a hashable tuple of (field,
value) pairs (``FNOConfig.block_plan``); each launch takes the fields its
kernel has.

Key schema, the reference's six segments and a batch bucket::

    r{rank}/{shape_class}/{layout}/{variant}/{dtype}/{launch}/b{bucket}
    e.g.  r2/h64-s128x128-m32x32/shared/full/f32/block_fwd/b8

* the first six segments are the reference's (``shape_class``,
  ``launch_variant`` and ``dtype_tag`` identical);
* ``b{bucket}``: the batch rounded up to a power of two, 1, 2, 4 or 8.
  The port's plan depends on the batch where the reference's does not: the
  rule planner takes clusters of 16 only where the batch fits one wave of
  them (``engine._pick``). Above 8 the rule planner decides.

A tuned entry serves the launches of its probe shape (hidden, out,
spatial, modes) exactly: its chunk rows are sized to those extents, and a
shape that only shares its key's power-of-two class takes the rule plan.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

LAUNCH_KINDS = ("block_fwd", "core", "gz_recompute", "dx_adjoint", "wgrad")
BATCH_BUCKETS = (1, 2, 4, 8)

_LAUNCH_VARIANT = {"block_fwd": "full", "core": "partial",
                   "gz_recompute": "full", "dx_adjoint": "full",
                   "wgrad": "full"}

_DTYPE_TAGS = {"float32": "f32", "bfloat16": "bf16"}

# Every field an override may hold, and the values each takes.
CHAINS = ("tc", "fma")
CLUSTERS = (1, 2, 4, 8, 16)
FIELDS = ("cluster", "chain", "rows_f", "rows_i", "cols", "hc", "ot", "np",
          "nb", "kc", "ri", "wj")

Override = Optional[Tuple[Tuple[str, Any], ...]]


def launch_variant(launch: str) -> str:
    """The normalized variant a launch kind keys under."""
    return _LAUNCH_VARIANT[launch]


def dtype_tag(compute_dtype) -> str:
    """Short dtype tag for keys ("float32" → "f32"); a torch dtype too."""
    name = str(compute_dtype).removeprefix("torch.")
    return _DTYPE_TAGS.get(name, name)


def _p2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def shape_class(hidden: int, out: int, spatial: Sequence[int],
                modes: Sequence[int]) -> str:
    """Power-of-two shape bucket, as the reference's: hidden (and out,
    only where it differs), spatial and modes extents each rounded up to
    the next power of two."""
    parts = [f"h{_p2(hidden)}"]
    if out != hidden:
        parts.append(f"o{_p2(out)}")
    parts.append("s" + "x".join(str(_p2(s)) for s in spatial))
    parts.append("m" + "x".join(str(_p2(m)) for m in modes))
    return "-".join(parts)


def batch_bucket(batch: int) -> Optional[int]:
    """The bucket a batch keys under (the next power of two), or None above
    the largest (the rule planner decides there)."""
    b = _p2(batch)
    return b if b <= BATCH_BUCKETS[-1] else None


def plan_key(rank: int, klass: str, layout: str, dtype: str, launch: str,
             bucket: int) -> str:
    """Format one cache key (the variant segment derives from launch)."""
    return (f"r{rank}/{klass}/{layout}/{launch_variant(launch)}/"
            f"{dtype}/{launch}/b{bucket}")


def workload_key(launch: str, dtype, batch: int, hidden: int, out: int,
                 spatial: Sequence[int], modes: Sequence[int],
                 per_mode: bool) -> Optional[str]:
    """The key of one launch, or None where no entry can serve it (a
    batch above the largest bucket, an untuned kind). Rank 1's core keys
    as its block_fwd, as the reference's does."""
    bucket = batch_bucket(batch)
    if bucket is None or launch not in LAUNCH_KINDS:
        return None
    if len(modes) == 1 and launch == "core":
        launch = "block_fwd"
    return plan_key(len(modes), shape_class(hidden, out, spatial, modes),
                    "per_mode" if per_mode else "shared", dtype_tag(dtype),
                    launch, bucket)


def parse_key(key: str) -> Dict[str, Any]:
    """Parse and validate a cache key; raises ValueError with the defect."""
    parts = key.split("/")
    if len(parts) != 7:
        raise ValueError(f"want 7 '/'-separated segments, got {len(parts)}")
    r, klass, layout, variant, dtype, launch, b = parts
    if not (r.startswith("r") and r[1:].isdigit() and int(r[1:]) in (1, 2, 3)):
        raise ValueError(f"bad rank segment {r!r}")
    if layout not in ("shared", "per_mode"):
        raise ValueError(f"bad layout segment {layout!r}")
    if launch not in LAUNCH_KINDS:
        raise ValueError(f"unknown launch kind {launch!r}")
    if variant != launch_variant(launch):
        raise ValueError(f"variant {variant!r} inconsistent with launch "
                         f"{launch!r} (want {launch_variant(launch)!r})")
    if dtype not in _DTYPE_TAGS.values():
        raise ValueError(f"bad dtype segment {dtype!r}")
    if not (b.startswith("b") and b[1:].isdigit()
            and int(b[1:]) in BATCH_BUCKETS):
        raise ValueError(f"bad batch bucket {b!r}; want one of "
                         f"{['b%d' % v for v in BATCH_BUCKETS]}")
    return {"rank": int(r[1:]), "shape_class": klass, "layout": layout,
            "variant": variant, "dtype": dtype, "launch": launch,
            "bucket": int(b[1:])}


def normalize_override(override) -> Override:
    """A canonical override: sorted (field, value) pairs without the
    fields left at 0 / None ("keep the resolved value"), or None. Takes a
    dict or pairs; raises ValueError for an unknown field or a bad value."""
    if override is None:
        return None
    items = dict(override).items()
    out = []
    for field, value in items:
        if field not in FIELDS:
            raise ValueError(f"unknown plan field {field!r}; known: "
                             f"{FIELDS}")
        if value is None or value == 0:
            continue
        if field == "chain":
            if value not in CHAINS:
                raise ValueError(f"plan field 'chain' takes one of {CHAINS}"
                                 f", got {value!r}")
        elif not (isinstance(value, int) and not isinstance(value, bool)
                  and value > 0):
            raise ValueError(f"plan field {field!r} takes a positive int, "
                             f"got {value!r}")
        elif field == "cluster" and value not in CLUSTERS:
            raise ValueError(f"plan field 'cluster' takes one of {CLUSTERS}"
                             f", got {value!r}")
        out.append((field, value))
    return tuple(sorted(out)) or None
