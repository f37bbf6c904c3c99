"""Every fused launch's plan and shared memory against the H100's budget,
before a launch (counterpart of ``repro/analysis/vmem.py``).

The budget is 232,448 B of dynamic shared memory a block
(``roofline.hw.SMEM_PER_BLOCK``), not the TPU's 16 MiB of VMEM. The
planners are the byte model: ``engine.launch_plan`` / ``wgrad_plan``
mirror the kernels' C layouts (``block_layout``, ``wgrad_layout``, held
to them by the CPU tests through the g++-built libraries), and the core's
plan comes only from its library (``fused_core_plan``), so the core's
estimate needs that library (`lib`: the card's, or the CPU build of the
tests). Without it the core is reported as not estimated; it never passes
silently.

A launch's plan is the one it would run (``tuning.resolve_plan``:
override → fresh tuned entry → rule planner). Off the card the rule's
cluster is the portable one where no tuned entry pins it (the card's
occupancy answers it there). An estimate the planner refuses carries its
error; ``check_smem`` turns refusals and plans over the budget into
findings. The tuner prunes its candidates with ``estimate``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.analysis import Finding
from repro_torch.roofline.hw import SMEM_PER_BLOCK


@dataclasses.dataclass(frozen=True)
class LaunchEstimate:
    """One launch's resolved plan and its shared memory a block."""

    launch: str                    # the launch kind (engine.launch_kind's)
    plan: Optional[Dict[str, Any]]  # None where refused or not estimated
    smem_bytes: int
    source: str                    # "override" | "cache" | "rule"
    limit: int = SMEM_PER_BLOCK
    error: Optional[str] = None    # the planner's refusal

    @property
    def fits(self) -> bool:
        return self.error is None and self.smem_bytes <= self.limit


def estimate(kind: str, dtype, batch: int, hidden: int, out: int, spatial,
             modes, per_mode: bool = False, override=None, *, lib=None,
             ends=None) -> LaunchEstimate:
    """The plan and shared memory of one launch of `kind` as it would
    resolve (`override` first), or the planner's refusal."""
    from repro_torch.tuning import resolve

    src = "override" if override else "rule"
    try:
        r = resolve.resolve_plan(kind, dtype, batch, hidden, out, spatial,
                                 modes, per_mode, override, lib=lib,
                                 ends=ends)
    except ValueError as exc:
        return LaunchEstimate(kind, None, 0, src, error=str(exc))
    return LaunchEstimate(kind, r.plan, int(r.plan["smem"]), r.source)


def _dtype(cfg, dtype):
    return dtype or cfg.precision.compute_dtype


def launch_estimate(cfg, launch: str, batch: int = 8, *, dtype=None,
                    lib=None, override=None) -> LaunchEstimate:
    """One launch kind of a config's blocks ([H, H] weights; dx_adjoint's
    [H, O] view is the same shape), with ``cfg.block_plan`` as the
    override unless `override` is given. `lib`: the kernel's library (the
    core's plan needs it; the block and wgrad kernels' rule asks it the
    card's occupancy)."""
    from repro_torch.kernels import engine

    if engine.kernel_of(launch) == "core" and lib is None:
        return LaunchEstimate(launch, None, 0, "rule", error=(
            "not estimated: the core's plan comes from its library "
            "(fused_core_plan) and none was given"))
    return estimate(launch, _dtype(cfg, dtype), batch, cfg.hidden,
                    cfg.hidden, cfg.spatial, cfg.modes,
                    cfg.weight_mode == "per_mode",
                    cfg.block_plan if override is None else override,
                    lib=lib)


def ends_dims(cfg, which: str):
    """The ends operand dims (C_in, L, Lp, C_out) of a block with the
    lift ("lift"), the projection ("proj") or both folded in."""
    lift = cfg.lifting_dim or 2 * cfg.hidden
    has_lift, has_proj = which in ("lift", "both"), which in ("proj", "both")
    return (cfg.in_channels if has_lift else cfg.hidden,
            lift if has_lift else 0, lift if has_proj else 0,
            cfg.out_channels if has_proj else 0)


def ends_launch_estimate(cfg, *, batch: int = 8, dtype=None,
                         which: str = "both") -> LaunchEstimate:
    """The block launch with the model's end MLPs folded in
    (``cfg.fuse_ends``, counted "block_ends"): the first block's with the
    lift, the last's with the projection, or a 1-layer model's with both
    (the default, the largest)."""
    return estimate("block_ends", _dtype(cfg, dtype), batch, cfg.hidden,
                    cfg.hidden, cfg.spatial, cfg.modes,
                    cfg.weight_mode == "per_mode", cfg.block_plan,
                    ends=ends_dims(cfg, which))


def block_launch_estimates(cfg, *, variant: str = "full", batch: int = 8,
                           dtype=None, libs: Optional[Dict[str, Any]] = None
                           ) -> Dict[str, LaunchEstimate]:
    """Every fused launch one whole-block training step of `cfg` runs: the
    forward (block_fwd; with variant="partial" at ranks 2–3 the core, at
    rank 1 the bare layer), the ends' launches where ``cfg.fuse_ends``
    folds them in (full variant), and the backward's gz_recompute,
    dx_adjoint and wgrad. `libs` maps "block" / "wgrad" / "core" to the
    kernels' libraries (the core's is needed to estimate it)."""
    from repro_torch.kernels import engine

    libs = libs or {}
    one = lambda kind: launch_estimate(
        cfg, kind, batch, dtype=dtype, lib=libs.get(engine.kernel_of(kind)))
    est: Dict[str, LaunchEstimate] = {}
    if variant == "full":
        est["block_fwd"] = one("block_fwd")
        if cfg.fuse_ends:
            whichs = (("both",) if cfg.num_layers == 1
                      else ("lift", "proj"))
            for w in whichs:
                est[f"block_ends_{w}"] = ends_launch_estimate(
                    cfg, batch=batch, dtype=dtype, which=w)
    elif cfg.ndim == 1:
        est["spectral_fwd"] = one("spectral_fwd")
    else:
        est["core"] = one("core")
    for kind in ("gz_recompute", "dx_adjoint", "wgrad"):
        est[kind] = one(kind)
    return est


def default_configs() -> List[Any]:
    """Every preset at full width and reduced, the fused ends at full
    width where the port serves them (fno2d, fno3d), and the shapes the
    block and wgrad kernels take only tiled (``configs.TILED``)."""
    from repro_torch.configs import (FNO_IDS, TILED, get_config,
                                     tiled_config, with_fuse_ends)

    out = [get_config(a, reduced=r) for r in (False, True) for a in FNO_IDS]
    out += [with_fuse_ends(get_config(a)) for a in ("fno2d", "fno3d")]
    out += [tiled_config(n) for n in TILED]
    return out


def check_smem(configs: Optional[Sequence[Any]] = None,
               dtypes: Sequence[str] = ("f32", "bf16"),
               variants: Sequence[str] = ("full", "partial"), *,
               libs: Optional[Dict[str, Any]] = None,
               batch: int = 8) -> List[Finding]:
    """Every launch of each config's training step (both variants, both
    presets' dtypes) at the plan it resolves: an error finding for a
    launch the planner refuses or one over the budget; one warning per
    config whose core launches were not estimated (no core library)."""
    from repro_torch.configs import with_precision

    findings: List[Finding] = []
    for cfg in configs if configs is not None else default_configs():
        label = (f"{cfg.name}[h{cfg.hidden} s{'x'.join(map(str, cfg.spatial))}"
                 f"{' ends' if cfg.fuse_ends else ''}]")
        unestimated = 0
        for dtype in dtypes:
            c = with_precision(cfg, dtype)
            for variant in variants:
                if variant == "partial" and cfg.fuse_ends:
                    continue  # the ends fold into the full variant only
                ests = block_launch_estimates(c, variant=variant,
                                              batch=batch, libs=libs)
                for name, e in ests.items():
                    target = f"{label}/{variant}/{dtype}/{name}"
                    if e.error is not None and e.error.startswith(
                            "not estimated"):
                        unestimated += 1
                    elif e.error is not None:
                        findings.append(Finding(
                            "smem-budget", target,
                            f"the planner refuses this launch: {e.error}"))
                    elif not e.fits:
                        findings.append(Finding(
                            "smem-budget", target,
                            f"plan {e.plan} ({e.source}) needs "
                            f"{e.smem_bytes} B of shared memory a block, "
                            f"over the {e.limit} B budget"))
        if unestimated:
            findings.append(Finding(
                "smem-budget", label,
                f"{unestimated} core launches not estimated: no core "
                f"library (pass libs={{'core': ...}}: the card's, or the "
                f"CPU build)", severity="warn"))
    return findings
