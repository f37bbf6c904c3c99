"""The port's contract checks (counterpart of ``scripts/lint.py``).

    python -m repro_torch.launch.lint --all --device cpu   # no card
    python -m repro_torch.launch.lint --all                # on the card

  --ast          source rules over src/repro_torch (analysis.ast_lint);
  --launches     launch counts of the fused entry points (a block forward
                 and backward, a model forward and backward in each fused
                 design, a K-step rollout; analysis.launch_lint);
  --casts        cast ownership of the same calls;
  --collectives  the collective budget of a sharded forward on spawned
                 ranks (gloo, (1,2), reduced fno2d, both TP layouts);
  --smem         every preset's launches against the 232,448 B a block
                 (analysis.smem; the core's through its library on the
                 card);
  --tuning       the committed tuned-plan cache is fresh
                 (tuning.store.check_tuning_cache).

On the CPU the calls run at the reference's reduced shapes; on the card
(``--device cuda``) the launches and casts run fno2d at full width and the
smem and tuning checks take the card's libraries. Exits 1 on any error
finding; warnings are printed.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.analysis import errors, format_findings

CHECKS = ("ast", "launches", "casts", "collectives", "smem", "tuning")


def run_checks(checks, device: str = "cpu", log=print):
    """The findings of the named checks (``CHECKS``)."""
    from repro_torch.analysis import ast_lint, launch_lint, smem
    from repro_torch.tuning import store

    card = device == "cuda"
    libs = {}
    if card and {"smem", "tuning"} & set(checks):
        from repro_torch.kernels import build
        libs = {"block": build.load_fused_block(),
                "wgrad": build.load_fused_wgrad(),
                "core": build.load_fused_core()}
    findings = []

    def step(name, fn):
        t = time.perf_counter()
        got = fn()
        log(f"  {name}: {len(errors(got))} errors, {len(got)} findings, "
            f"{time.perf_counter() - t:.1f} s")
        return got

    if "ast" in checks:
        findings += step("ast", ast_lint.run_ast_lints)
    keep = {c for c, on in (("launch-count", "launches" in checks),
                            ("cast-ownership", "casts" in checks)) if on}
    if keep:
        def calls():
            if card:
                got = launch_lint.lint_model(archs=("fno2d",), reduced=False,
                                             device="cuda", batch=8)
                got += launch_lint.lint_rollout(archs=("fno2d",),
                                                reduced=False, device="cuda")
            else:
                got = launch_lint.lint_block_matrix()
                got += launch_lint.lint_model()
                got += launch_lint.lint_rollout()
            return [f for f in got if f.checker in keep]
        findings += step("launches/casts", calls)
    if "collectives" in checks:
        findings += step("collectives", lambda: launch_lint.lint_sharded(
            device=device))
    if "smem" in checks:
        findings += step("smem", lambda: smem.check_smem(libs=libs))
    if "tuning" in checks:
        findings += step("tuning", lambda: store.check_tuning_cache(
            core_lib=libs.get("core")))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for c in CHECKS:
        ap.add_argument(f"--{c}", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    checks = [c for c in CHECKS if args.all or getattr(args, c)]
    if not checks:
        ap.error("name a check or pass --all")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("lint: --device cuda needs a CUDA device (pass --device "
                  "cpu on the CPU)", file=sys.stderr)
            return 2
    findings = run_checks(checks, args.device)
    if findings:
        print(format_findings(findings))
    bad = errors(findings)
    print(f"lint: {len(bad)} errors, {len(findings) - len(bad)} warnings "
          f"({', '.join(checks)}, device {args.device})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
