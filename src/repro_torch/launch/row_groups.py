"""The row kernels' slab-group size, measured on the card.

    PYTHONPATH=src python -m repro_torch.launch.row_groups [--batch 8]
        [--rounds 3]

Times ``csrc/dft_rows.cu``'s rdft and irdft (the partial variant's outer
transforms) at the batch's shapes of fno2d, fno2d-large and fno3d, f32 and
bf16, with the slab groups capped at 64, 128 and 256 rows in turn
(``kernels/dft.MAX_GROUP_ROWS``, the table these timings chose), each
launch queued behind a device spin so that CUDA events time the device
alone, rounds in alternating order. Prints one line a shape with the
median ms of each cap (``*`` marks the table's) and, last, one JSON object
with every median. Needs an NVIDIA GPU.

``--wrappers`` times the public rank-2 wrappers ``dft.rdft`` /
``dft.irdft`` at fno2d and fno2d-large instead, with no group sweep. They
are the same in every checkout since the partial variant's port, so run
by path with another checkout's package first on the path,

    PYTHONPATH=<checkout>/src python src/repro_torch/launch/row_groups.py \
        --wrappers

times that checkout's kernels with this script; two checkouts run in
turns in one call compare on one card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.core import spectral
from repro_torch.kernels import build, dft

ARCHS = ("fno2d", "fno2d-large", "fno3d")
CAPS = (64, 128, 256)
SPIN_CYCLES = 100_000_000  # ~50 ms of device spin ahead of the launches


def _time(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _case(kind, arch, b, dtype):
    """(inputs, last-axis factor, outer factor or None, dims) of one
    launch at the arch's full width."""
    cfg = get_config(arch)
    h, n1 = cfg.hidden, cfg.spatial[0]
    osp, omd = tuple(cfg.spatial[1:]), tuple(cfg.modes[1:])
    f = lambda k, n, m: spectral.row_operand_tensors(k, (n,), (m,), dtype,
                                                     "cuda")
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen).to("cuda",
                                                      getattr(torch, dtype))
    if len(osp) == 1:
        (n3,), (k3,) = osp, omd
        ins = ((rnd(b, h, n1, n3),) if kind == "rdft"
               else (rnd(b, h, n1, k3), rnd(b, h, n1, k3)))
        return ins, f(kind, n3, k3), None, (1, n3, 1, k3)
    (n2, n3), (k2, k3) = osp, omd
    if kind == "rdft":
        return ((rnd(b, h, n1, n2, n3),), f("cdft", n3, k3),
                f("cdft", n2, k2), (n2, n3, k2, k3))
    return ((rnd(b, h, n1, k3, k2), rnd(b, h, n1, k3, k2)),
            f("irdft", n3, k3), f("icdft", n2, k2), (n2, n3, k2, k3))


def _time_wrappers(args, report) -> None:
    """Median ms of the rank-2 wrappers over the rounds, into `report`."""
    for arch in ARCHS[:2]:
        for dtype in ("float32", "bfloat16"):
            for kind in ("rdft", "irdft"):
                ins, f3, _, _ = _case(kind, arch, args.batch, dtype)
                fn = getattr(dft, kind)
                times = [_time(lambda: fn(*ins, *f3), args.iters)
                         for _ in range(args.rounds)]
                name = f"{arch} {dtype} {kind}"
                report["ms"][name] = statistics.median(times)
                print(f"{name}: {report['ms'][name]:.4f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--wrappers", action="store_true",
                    help="time dft.rdft / dft.irdft at rank 2, no sweep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("row_groups: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    report = {"card": smi, "batch": args.batch, "ms": {}}
    if args.wrappers:
        _time_wrappers(args, report)
        print(json.dumps(report))
        return
    lib = build.load_dft_rows()
    for arch in ARCHS:
        for dtype in ("float32", "bfloat16"):
            esize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
            for kind in ("rdft", "irdft"):
                ins, f3, f2, dims = _case(kind, arch, args.batch, dtype)
                table = dft.MAX_GROUP_ROWS[(kind, f2 is not None, esize)]
                stream = torch.cuda.current_stream().cuda_stream
                runs = {cap: (lambda g=max(1, cap // dims[0]):
                              dft._launch_rows(lib, kind, ins, f3, f2, dims,
                                               stream, group=g))
                        for cap in CAPS}
                times = {cap: [] for cap in CAPS}
                for rnd in range(args.rounds):
                    for cap in CAPS if rnd % 2 == 0 else CAPS[::-1]:
                        times[cap].append(_time(runs[cap], args.iters))
                med = {side: statistics.median(v) for side, v in times.items()}
                name = f"{arch} {dtype} {kind}"
                report["ms"][name] = {str(c): m for c, m in med.items()}
                report["ms"][name]["table"] = table
                print(f"{name}: " + " ".join(
                    f"{c}{'*' if c == table else ''}={m:.4f}"
                    for c, m in med.items()), flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
