"""Regenerate the tuned launch-plan cache (counterpart of
``scripts/autotune.py``).

    python -m repro_torch.launch.autotune                 # every key, card
    python -m repro_torch.launch.autotune --arch fno3d --kind wgrad \\
        --batch 8 --out out/plans.json --log out/tune.log
    python -m repro_torch.launch.autotune --smoke --device cpu \\
        --out /tmp/plans.json                            # no card

On the card (the default) every key of the filters is measured: its
candidates checked against the plain version and timed against the rule
plan in two turns (``repro_torch.tuning.autotune``), and written over the
entries of the cache it starts from (``--base``, the committed
``src/repro_torch/tuning/cache/plans.json`` by default) into ``--out``
(default: the base), after every key, so a run cut short keeps what it
measured. The filters let the tuning run in parts. ``--smoke`` (with
``--device cpu``) persists the rule plans of the reduced configs, no
times: the pipeline without a card. Any change to a kernel's sources
makes its entries stale (``check_tuning_cache``): retune them here.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.tuning import autotune as A
from repro_torch.tuning import plans as P


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=list(A.PRESETS),
                    choices=A.PRESETS)
    ap.add_argument("--dtype", nargs="+", default=list(A.DTYPES),
                    choices=A.DTYPES)
    ap.add_argument("--kind", nargs="+", default=list(P.LAUNCH_KINDS),
                    choices=P.LAUNCH_KINDS)
    ap.add_argument("--batch", nargs="+", type=int, default=list(A.BATCHES),
                    choices=A.BATCHES)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: measure on the card; cpu: needs --smoke")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configs' rule plans, no times")
    ap.add_argument("--base", default=None,
                    help="the cache to start from (default: the committed)")
    ap.add_argument("--out", default=None,
                    help="where to write (default: --base)")
    ap.add_argument("--log", default=None,
                    help="also write every line to this file")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "cpu" and not args.smoke:
        print("autotune: measuring needs the card; on the CPU pass --smoke",
              file=sys.stderr)
        return 2
    sink = open(args.log, "w") if args.log else None

    def log(msg):
        print(msg, flush=True)
        if sink is not None:
            print(msg, file=sink, flush=True)

    try:
        A.tune("none" if args.smoke else "card", archs=args.arch,
               dtypes=args.dtype, kinds=args.kind, batches=args.batch,
               reduced=args.smoke, base=args.base, out=args.out, log=log)
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
