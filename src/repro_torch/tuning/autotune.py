"""The launch-plan tuner: generate → prune → measure on the card → persist
(counterpart of ``repro/tuning/autotune.py``).

For every tuning key of the presets (``fno1d``, ``fno2d``,
``fno2d-large``, ``fno3d`` at full width) × f32 / bf16 × the five launch
kinds (rank 1 has no core) × batches 1, 2, 4 and 8:

1. **generate** candidate plans from the planner's own fields: the
   cluster 8 or 16 where ``_cluster_slices`` holds it, the chain "tc" or
   "fma" where it fits, then rows_f and rows_i (the wgrad: cols) at the
   planner's most for that cluster and chain and at each halving down to
   1 (rank 1's tensor-core rows to 16 points; cols to 16); the core's
   cluster and np at every value its library plans; always the rule plan;
2. **prune** what ``analysis.smem.estimate`` refuses;
3. **measure** (measure="card"): every candidate launched once against the
   launch's plain version (f32 within 2e-4; bf16 within 2e-2 of the f32
   plain version; errors scaled as ``chip_smoke.check`` scales them), a
   candidate that fails or does not launch dropped and logged; then CUDA
   events over each candidate and the rule plan in pairs, queued behind
   ``torch.cuda._sleep``, in two turns (rule first, then candidate first).
   A candidate replaces the rule plan only where it is faster by more than
   ``GAIN`` in both turns; otherwise the entry keeps the rule plan
   (``source: "rule"``), so noise does not churn plans;
4. **persist** through ``store.save_cache``.

measure="none" (the CPU, ``--smoke``) persists the pruned rule plans with
``source: "rule"`` and no times: the whole pipeline without a card.
"""
from __future__ import annotations

import dataclasses
import math
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tuning import plans as P
from repro_torch.tuning import store

PRESETS = ("fno1d", "fno2d", "fno2d-large", "fno3d")
DTYPES = ("f32", "bf16")
BATCHES = P.BATCH_BUCKETS
GAIN = 0.03          # a candidate must be this much faster in both turns
F32_TOL = 2e-4       # DESIGN.md §4, as chip_smoke.py holds the kernels
BF16_TOL = 2e-2
QUEUE_CYCLES = 100_000_000  # device spin ahead of a group of timed pairs
PAIRS_A_SPIN = 8     # timed pairs queued behind one spin
TARGET_MS = 0.5      # device time of one timed run of a plan (iters × ms)


@dataclasses.dataclass(frozen=True)
class Workload:
    """One tuning key: a launch kind of a preset's blocks at a dtype and
    batch bucket."""

    arch: str
    kind: str
    dtype: str      # "f32" | "bf16"
    batch: int
    hidden: int
    spatial: Tuple[int, ...]
    modes: Tuple[int, ...]
    per_mode: bool

    @property
    def key(self) -> str:
        return P.workload_key(self.kind, self.dtype, self.batch, self.hidden,
                              self.hidden, self.spatial, self.modes,
                              self.per_mode)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == "f32" else torch.bfloat16

    def probe(self) -> Dict[str, Any]:
        return {"batch": self.batch, "hidden": self.hidden,
                "out": self.hidden, "spatial": list(self.spatial),
                "modes": list(self.modes)}


def workloads(archs: Sequence[str] = PRESETS,
              dtypes: Sequence[str] = DTYPES,
              kinds: Sequence[str] = P.LAUNCH_KINDS,
              batches: Sequence[int] = BATCHES,
              reduced: bool = False) -> List[Workload]:
    """Every key of the filters' product (full width, or the reduced
    configs with `reduced`), deduplicated; rank 1 has no core."""
    from repro_torch.configs import get_config

    out, seen = [], set()
    for arch in archs:
        cfg = get_config(arch, reduced=reduced)
        for dtype in dtypes:
            for kind in kinds:
                if kind == "core" and cfg.ndim == 1:
                    continue
                for b in batches:
                    w = Workload(arch, kind, dtype, b, cfg.hidden,
                                 tuple(cfg.spatial), tuple(cfg.modes),
                                 cfg.weight_mode == "per_mode")
                    if w.key not in seen:
                        seen.add(w.key)
                        out.append(w)
    return out


def _plan(w: Workload, pins: Optional[Dict[str, Any]], lib):
    from repro_torch.kernels import engine
    return engine.plan_launch(w.kind, w.torch_dtype, w.batch, w.hidden,
                              w.hidden, w.spatial, w.modes, w.per_mode, pins,
                              lib=lib)


def fields_of(kind: str, plan: Dict[str, Any]) -> Dict[str, Any]:
    """The plan fields a launch of `kind` pins (``engine.PLAN_FIELDS``)."""
    from repro_torch.kernels import engine
    return {f: plan[f] for f in engine.PLAN_FIELDS[engine.kernel_of(kind)]}


def _halvings(top: int, least: int, step: int = 1) -> List[int]:
    out, v = [], top
    while v >= least:
        if v % step == 0 and v not in out:
            out.append(v)
        v //= 2
    return out


def candidates(w: Workload, lib) -> List[Dict[str, Any]]:
    """The generated candidates' fields, the rule plan's first."""
    from repro_torch.kernels import engine

    kernel = engine.kernel_of(w.kind)
    rule = fields_of(w.kind, _plan(w, None, lib))
    out = [rule]
    if kernel == "core":
        for cluster in P.CLUSTERS:
            for np_ in (1, 2, 4, 8):
                try:
                    out.append(fields_of(w.kind, _plan(
                        w, {"cluster": cluster, "np": np_}, lib)))
                except ValueError:
                    continue
    else:
        last = "rows_i" if kernel == "block" else "cols"
        for cluster in (8, 16):
            for chain in engine.CHAINS:
                try:
                    base = _plan(w, {"cluster": cluster, "chain": chain},
                                 lib)
                except ValueError:
                    continue
                lo, _, step = engine._rows_range(chain, w.spatial, w.modes)
                for v in _halvings(base["rows_f"], lo, step):
                    out.append(dict(fields_of(w.kind, base), rows_f=v))
                least = 16 if last == "cols" else 1
                for v in _halvings(base[last], least):
                    out.append(dict(fields_of(w.kind, base), **{last: v}))
    uniq, seen = [], set()
    for c in out:
        t = tuple(sorted(c.items()))
        if t not in seen:
            seen.add(t)
            uniq.append(c)
    return uniq


def prune(w: Workload, cands: List[Dict[str, Any]], lib,
          log: Callable = print) -> List[Dict[str, Any]]:
    """The candidates ``smem.estimate`` accepts, pinned as they are."""
    from repro_torch.analysis import smem

    kept = []
    for c in cands:
        e = smem.estimate(w.kind, w.torch_dtype, w.batch, w.hidden,
                          w.hidden, w.spatial, w.modes, w.per_mode,
                          tuple(sorted(c.items())), lib=lib)
        if e.fits and fields_of(w.kind, e.plan) == c:
            kept.append(c)
        else:
            log(f"  pruned {w.key} {c}: {e.error or e.smem_bytes}")
    return kept


# ---------------------------------------------------------------------------
# Measurement on the card
# ---------------------------------------------------------------------------
def _rel_err(y, ref) -> float:
    """Max |y - ref| scaled to the reference magnitude (max(|ref|, 1)), as
    ``chip_smoke.rel_err``."""
    y, ref = y.float(), ref.float()
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


class Probe:
    """One workload's operands on the card, its launch as a function of
    the plan's override, and the f32 plain version's outputs."""

    def __init__(self, w: Workload, device, seed: int = 0):
        from repro_torch.core import spectral
        from repro_torch.kernels import engine

        gen = torch.Generator(device=device).manual_seed(seed)
        mk = lambda *s, sc=1.0: sc * torch.randn(
            s, generator=gen, dtype=torch.float32, device=device)
        b, h, sp, md = w.batch, w.hidden, w.spatial, w.modes
        wshape = (h, h) + (md if w.per_mode else ())
        x, gy = mk(b, h, *sp), mk(b, h, *sp)
        wr, wi = mk(*wshape, sc=1.0 / h), mk(*wshape, sc=1.0 / h)
        wb, bias = mk(h, h, sc=1.0 / h), mk(h, 1, sc=0.3)
        # The core's input: the spectrum pair [B,H,s_1,K_R..K_2].
        zs = (b, h, sp[0]) + tuple(reversed(md[1:]))
        zr, zi = mk(*zs), mk(*zs)
        dt = w.torch_dtype
        name = "float32" if w.dtype == "f32" else "bfloat16"
        mats = lambda k, d: spectral.operand_tensors(sp, md, d, device, k)
        f32 = (x, gy, wr, wi, wb, bias, zr, zi)
        low = tuple(t.to(dt) for t in f32)

        def call(t, m, plan=None, plain=False):
            x_, gy_, wr_, wi_, wb_, b_, zr_, zi_ = t
            fb = (engine.fused_block_plain if plain else
                  lambda *a, **k: engine.fused_block(*a, plan=plan, **k))
            if w.kind == "block_fwd":
                return (fb(x_, wr_, wi_, wb_, b_, m("forward")),)
            if w.kind == "gz_recompute":
                return (fb(x_, wr_, wi_, wb_, b_, m("forward"),
                           act="gelu_vjp", gy=gy_),)
            if w.kind == "dx_adjoint":
                kw = {} if plain else {"adjoint": True}
                return (fb(gy_, wr_.transpose(0, 1), wi_.transpose(0, 1),
                           wb_.t().contiguous(), None, m("adjoint"),
                           act="linear", out_dtype=x_.dtype, **kw),)
            if w.kind == "wgrad":
                if plain:
                    return engine.fused_wgrad_plain(
                        x_, gy_, m("wgrad"), per_mode=w.per_mode)
                return engine.fused_wgrad(x_, gy_, m("wgrad"),
                                          per_mode=w.per_mode, plan=plan)
            # core: the spectrum pair and the s_1 stages' operands
            r = len(md)
            ops = m("forward")[2 * r - 2:2 * r + 2]
            if plain:
                return engine.fused_core_plain(zr_, zi_, wr_, wi_, *ops)
            return engine.fused_core(zr_, zi_, wr_, wi_, *ops, plan=plan,
                                     spatial=sp)

        self.run = lambda plan: call(low, lambda k: mats(k, name), plan)
        self.refs = call(f32, lambda k: mats(k, "float32"), plain=True)
        self.tol = F32_TOL if w.dtype == "f32" else BF16_TOL


def _check(probe: Probe, plan) -> float:
    outs = probe.run(plan)
    torch.cuda.synchronize()
    return max(_rel_err(a, r) for a, r in zip(outs, probe.refs))


def _time_pairs(probe: Probe, rule, cands, iters: int,
                rule_first: bool) -> List[Tuple[float, float]]:
    """(rule ms, candidate ms) a launch for each candidate, each pair's two
    runs of `iters` launches between CUDA events, PAIRS_A_SPIN pairs
    queued behind one device spin."""
    out = []
    for g in range(0, len(cands), PAIRS_A_SPIN):
        group = cands[g:g + PAIRS_A_SPIN]
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_CYCLES)
        evs = []
        for c in group:
            pair = []
            for plan in ((rule, c) if rule_first else (c, rule)):
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                for _ in range(iters):
                    probe.run(plan)
                e.record()
                pair.append((s, e))
            evs.append(pair if rule_first else pair[::-1])
        torch.cuda.synchronize()
        out += [tuple(s.elapsed_time(e) / iters for s, e in pair)
                for pair in evs]
    return out


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def measure(w: Workload, cands: List[Dict[str, Any]], rule: Dict[str, Any],
            log: Callable = print) -> Dict[str, Any]:
    """Check every candidate against the plain version, time the survivors
    against the rule plan in two turns and return the entry's fields,
    source, ms and rule_ms (module doc, step 3)."""
    probe = Probe(w, "cuda")
    ov = lambda c: tuple(sorted(c.items()))
    good = []
    for c in cands:
        try:
            err = _check(probe, ov(c))
        except (RuntimeError, ValueError) as exc:
            log(f"  dropped {w.key} {c}: {exc}")
            continue
        if not err <= probe.tol:
            log(f"  dropped {w.key} {c}: scaled_err={err:.3e} > "
                f"{probe.tol:.0e}")
            continue
        good.append(c)
    if rule not in good:
        raise RuntimeError(f"{w.key}: the rule plan {rule} failed its check")
    others = [c for c in good if c != rule]
    # Enough launches a run for TARGET_MS of device time.
    one = _time_pairs(probe, ov(rule), [ov(rule)], 3, True)[0][0]
    iters = max(2, min(20, math.ceil(TARGET_MS / max(one, 1e-3))))
    runs = [c for c in [rule] + others]
    t1 = _time_pairs(probe, ov(rule), [ov(c) for c in runs], iters, True)
    t2 = _time_pairs(probe, ov(rule), [ov(c) for c in runs[::-1]], iters,
                     False)[::-1]
    rule_ms = float(np.mean([r for r, _ in t1 + t2]))
    best, best_ratio = None, 1.0
    for c, (r1, c1), (r2, c2) in zip(runs, t1, t2):
        log(f"  {w.key} {c}: turn 1 {c1:.4f} / rule {r1:.4f} ms, "
            f"turn 2 {c2:.4f} / rule {r2:.4f} ms")
        if c is rule:
            continue
        if c1 < (1 - GAIN) * r1 and c2 < (1 - GAIN) * r2:
            ratio = (c1 + c2) / (r1 + r2)
            if ratio < best_ratio:
                best, best_ratio = (c, (c1 + c2) / 2, (r1 + r2) / 2), ratio
    if best is None:
        return {"fields": rule, "source": "rule", "ms": rule_ms,
                "rule_ms": rule_ms}
    c, ms, r_ms = best
    return {"fields": c, "source": "tuned", "ms": ms, "rule_ms": r_ms}


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------
def tune(measure_on: str = "card", *, archs: Sequence[str] = PRESETS,
         dtypes: Sequence[str] = DTYPES,
         kinds: Sequence[str] = P.LAUNCH_KINDS,
         batches: Sequence[int] = BATCHES, reduced: bool = False,
         libs: Optional[Dict[str, Any]] = None, base: Optional[str] = None,
         out: Optional[str] = None,
         log: Callable = print) -> Tuple[str, Dict[str, dict]]:
    """Tune the filters' keys and persist them over the entries of the
    cache at `base` (default: the committed cache; a missing file starts
    empty), to `out` (default: `base`). measure_on: "card" (measure every
    key on the card) or "none" (the pruned rule plans, no times). `libs`
    maps "block" / "wgrad" / "core" to the kernels' libraries (the card's
    by default with "card"; a key whose kernel has none is skipped off the
    card only for the core, whose plan needs its library). Returns (path,
    the entries written this run)."""
    if measure_on not in ("card", "none"):
        raise ValueError(f"measure_on is 'card' or 'none', got "
                         f"{measure_on!r}")
    from repro_torch.kernels import build, engine

    if measure_on == "card":
        if not torch.cuda.is_available():
            raise RuntimeError("measure_on='card' needs a CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        libs = libs or {"block": build.load_fused_block(),
                        "wgrad": build.load_fused_wgrad(),
                        "core": build.load_fused_core()}
        card = card_name()
    else:
        libs, card = libs or {}, None
    base = base or store.DEFAULT_CACHE_PATH
    entries = dict(store.load_cache(base)["entries"])
    digests = store.tree_digests()
    written: Dict[str, dict] = {}
    meta = {"measure": measure_on, "card": card}
    t0 = time.perf_counter()
    for w in workloads(archs, dtypes, kinds, batches, reduced):
        kernel = engine.kernel_of(w.kind)
        lib = libs.get(kernel)
        if kernel == "core" and lib is None:
            log(f"  skipped {w.key}: the core's plan needs its library")
            continue
        t = time.perf_counter()
        cands = prune(w, candidates(w, lib), lib, log)
        rule = cands[0]
        entry = {"probe": w.probe(), "workload": f"{w.arch}/{w.dtype}",
                 "card": card, "digest": digests[kernel],
                 "rule_fields": rule}
        if measure_on == "card":
            entry.update(measure(w, cands, rule, log))
        else:
            entry.update(fields=rule, source="rule", ms=None, rule_ms=None)
        entries[w.key] = written[w.key] = entry
        log(f"{w.key}: {entry['source']} {entry['fields']} "
            f"ms={entry['ms']} rule_ms={entry['rule_ms']} "
            f"({len(cands)} candidates, {time.perf_counter() - t:.1f} s)")
        if measure_on == "card":  # a run cut short keeps what it measured
            store.save_cache(entries, meta=meta, path=out or base)
    path = store.save_cache(entries, meta=meta, path=out or base)
    log(f"wrote {len(written)} entries ({len(entries)} in all) -> {path} "
        f"in {time.perf_counter() - t0:.1f} s")
    return path, written
