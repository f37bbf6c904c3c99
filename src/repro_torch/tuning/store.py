"""The committed cache of tuned launch plans (counterpart of
``repro/tuning/store.py``).

One file, ``tuning/cache/plans.json`` by default, maps tuning keys
(``plans.plan_key``) to entries::

    {"fields":  the plan fields the launch pins (engine.PLAN_FIELDS),
     "source":  "tuned" (a candidate beat the rule plan on the card) or
                "rule" (the rule plan's own fields),
     "ms", "rule_ms": the tuned and the rule plan's device ms on the card
                (null where nothing was measured),
     "probe":   {"batch", "hidden", "out", "spatial", "modes"}: the launch
                measured, whose shape the entry serves,
     "card":    the card's name and power limit as nvidia-smi gives them,
     "digest":  the kernel's ``build.source_digest`` when it was tuned}

and ``meta`` stamps every kernel's digest and the shared-memory limit.
The reference's TPU cache (``repro/tuning/cache/blocks.json``) is not
read.

Staleness (``check_tuning_cache``): an entry whose kernel's digest differs
from the tree's, whose key does not parse, or whose fields the planner
refuses when it replans with them pinned is an error, and the resolver
never uses such an entry: the rule planner takes its place. Any change to
a kernel's sources (``csrc/<name>.cu`` or a shared ``csrc/*.cuh``) makes
its entries stale; regenerate them on the card with
``python -m repro_torch.launch.autotune``.

The file is read once per path and kept (``reload`` forgets it), so
nothing a launch does reads a file after the first.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
from typing import Any, Dict, List, Optional

import torch

from repro_torch.analysis import Finding
from repro_torch.tuning import plans as P

CACHE_DIR = os.path.join(os.path.dirname(__file__), "cache")
DEFAULT_CACHE_PATH = os.path.join(CACHE_DIR, "plans.json")
# The source each kernel's entries are stamped with (``build.SOURCES``).
KERNEL_SOURCES = {"block": "fused_block", "wgrad": "fused_wgrad",
                  "core": "fused_core"}
_RETUNE = "regenerate it on the card: python -m repro_torch.launch.autotune"


def _path(path: Optional[str]) -> str:
    return path or DEFAULT_CACHE_PATH


@functools.lru_cache(maxsize=None)
def tree_digests() -> Dict[str, str]:
    """Each tuned kernel's source digest in this tree, by kernel."""
    from repro_torch.kernels import build
    return {k: build.source_digest(src) for k, src in KERNEL_SOURCES.items()}


@functools.lru_cache(maxsize=16)
def _load(path: str) -> Optional[dict]:
    """The parsed file; None where it is absent, an empty dict where it
    does not parse."""
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError:
        return None
    except json.JSONDecodeError:
        return {}
    if not isinstance(data, dict):
        return {}
    data.setdefault("meta", {})
    data.setdefault("entries", {})
    return data


def load_cache(path: Optional[str] = None) -> dict:
    """{"meta": {...}, "entries": {key: entry}}: empty where the file is
    absent or does not parse (the resolver then plans by rule, and
    ``check_tuning_cache`` reports the defect)."""
    data = _load(_path(path))
    return data if data else {"meta": {}, "entries": {}}


def reload() -> None:
    """Forget every file read, so the next lookup reads it again (the
    tuner after a save, tests that write a cache)."""
    _load.cache_clear()
    _fresh.cache_clear()


def entry_kernel(key: str) -> str:
    """The kernel ("block", "wgrad", "core") a key's launch runs."""
    from repro_torch.kernels import engine
    return engine.kernel_of(key.split("/")[5])


def stale_reason(key: str, entry: Any) -> Optional[str]:
    """Why an entry cannot be used (its key, its form or its kernel's
    digest), or None. The planner's refusal of its fields is found where
    it is replanned (``check_tuning_cache``, ``resolve``)."""
    try:
        P.parse_key(key)
    except ValueError as exc:
        return f"unparseable key: {exc}"
    if not isinstance(entry, dict) or not isinstance(entry.get("fields"),
                                                     dict):
        return "entry has no plan fields"
    try:
        if P.normalize_override(entry["fields"]) is None:
            return "entry pins no field"
    except ValueError as exc:
        return f"bad plan fields: {exc}"
    probe = entry.get("probe")
    if not isinstance(probe, dict) or not all(
            k in probe for k in ("batch", "hidden", "out", "spatial",
                                 "modes")):
        return "entry lacks the probe shape it serves"
    kernel = entry_kernel(key)
    want = tree_digests()[kernel]
    if entry.get("digest") != want:
        return (f"{KERNEL_SOURCES[kernel]} changed since it was tuned "
                f"(digest {entry.get('digest')!r}, the tree's {want!r})")
    return None


@functools.lru_cache(maxsize=16)
def _fresh(path: str) -> Dict[str, dict]:
    return {k: e for k, e in load_cache(path)["entries"].items()
            if stale_reason(k, e) is None}


def _probe_shape(probe: dict):
    return (int(probe["hidden"]), int(probe["out"]),
            tuple(int(s) for s in probe["spatial"]),
            tuple(int(m) for m in probe["modes"]))


_OFF = [False]


@contextlib.contextmanager
def disabled():
    """Within the block no entry serves a launch: every launch plans by
    rule (the yardstick the tuned plans are held against)."""
    saved = _OFF[0]
    _OFF[0] = True
    try:
        yield
    finally:
        _OFF[0] = saved


def lookup(key: Optional[str], hidden: int, out: int, spatial, modes,
           path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The fields of the fresh entry under `key` whose probe shape is this
    launch's, or None (also within ``disabled``)."""
    if key is None or _OFF[0]:
        return None
    e = _fresh(_path(path)).get(key)
    if e is None or _probe_shape(e["probe"]) != (
            int(hidden), int(out), tuple(spatial), tuple(modes)):
        return None
    return dict(e["fields"])


def save_cache(entries: Dict[str, dict], meta: Optional[dict] = None,
               path: Optional[str] = None) -> str:
    """Write a cache file (sorted keys; meta stamped with every kernel's
    digest and the shared-memory limit), forget the old one, and return
    its path."""
    from repro_torch.roofline import hw

    path = _path(path)
    full_meta = {"digests": tree_digests(),
                 "smem_limit": hw.SMEM_PER_BLOCK}
    full_meta.update(meta or {})
    data = {"meta": full_meta,
            "entries": {k: entries[k] for k in sorted(entries)}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rows = [f"  {json.dumps(k)}: {json.dumps(e, sort_keys=True)}"
            for k, e in data["entries"].items()]
    with open(path, "w") as f:  # an entry a line: diffs show what moved
        f.write('{"meta": ' + json.dumps(data["meta"], sort_keys=True)
                + ',\n "entries": {\n' + ",\n".join(rows) + "\n }}\n")
    reload()
    return path


def replan(key: str, entry: dict, lib=None) -> Dict[str, Any]:
    """The plan the planner makes for an entry's probe launch with its
    fields pinned (``engine.plan_launch``; the core's needs its `lib`).
    Raises ``engine.PlanRefused`` naming a field it refuses."""
    from repro_torch.kernels import engine

    parsed = P.parse_key(key)
    hidden, out, spatial, modes = _probe_shape(entry["probe"])
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[parsed["dtype"]]
    return engine.plan_launch(
        parsed["launch"], dtype, int(entry["probe"]["batch"]),
        hidden, out, spatial, modes, parsed["layout"] == "per_mode",
        dict(entry["fields"]), lib=lib)


def check_tuning_cache(path: Optional[str] = None, *,
                       core_lib=None) -> List[Finding]:
    """Staleness and integrity of one cache file (see the module doc).
    Core entries are replanned through `core_lib` (the core's library:
    the card's, or the CPU build of the tests); without one they are
    reported as not replanned, at warn severity."""
    from repro_torch.roofline import hw

    path = _path(path)
    rel = os.path.relpath(path, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))
    data = _load(path)
    if data is None:
        return [Finding("tuning-cache", rel, "no tuned plan cache: every "
                        f"launch plans by rule ({_RETUNE})",
                        severity="warn")]
    if not data:
        return [Finding("tuning-cache", rel, "the cache does not parse; "
                        f"every launch plans by rule ({_RETUNE})")]
    findings: List[Finding] = []
    if data["meta"].get("smem_limit") != hw.SMEM_PER_BLOCK:
        findings.append(Finding(
            "tuning-cache", rel,
            f"tuned against {data['meta'].get('smem_limit')} B of shared "
            f"memory a block, the limit is {hw.SMEM_PER_BLOCK} ({_RETUNE})"))
    unplanned = 0
    for key, e in data["entries"].items():
        where = f"{rel}::{key}"
        why = stale_reason(key, e)
        if why is not None:
            findings.append(Finding(
                "tuning-cache", where, f"stale entry ({why}): the resolver "
                f"plans this launch by rule in its place ({_RETUNE})"))
            continue
        if entry_kernel(key) == "core" and core_lib is None:
            unplanned += 1
            continue
        try:
            plan = replan(key, e, core_lib)
        except ValueError as exc:
            findings.append(Finding(
                "tuning-cache", where,
                f"the planner refuses the entry's fields ({exc}): the "
                f"resolver plans this launch by rule in its place "
                f"({_RETUNE})"))
            continue
        moved = {f: (v, plan.get(f)) for f, v in e["fields"].items()
                 if plan.get(f) != v}
        if moved or plan["smem"] > hw.SMEM_PER_BLOCK:
            findings.append(Finding(
                "tuning-cache", where,
                f"replanned with its fields pinned, the plan moved {moved} "
                f"or needs {plan['smem']} B ({_RETUNE})"))
    if unplanned:
        findings.append(Finding(
            "tuning-cache", rel, f"{unplanned} core entries not replanned: "
            "no core library (pass core_lib: the card's, or the CPU build)",
            severity="warn"))
    return findings
