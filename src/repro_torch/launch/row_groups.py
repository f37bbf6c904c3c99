"""The row kernels' group size, and the standalone launches' device times,
measured on the card.

    PYTHONPATH=src python -m repro_torch.launch.row_groups [--batch 8]
        [--rounds 3]

Times ``csrc/dft_rows.cu``'s rdft and irdft (the partial variant's outer
transforms) and cdft with the forward and the padded-inverse operand (the
s_1 stage as a row launch) at the batch's shapes of fno2d, fno2d-large and
fno3d, f32 and bf16, with the groups capped at each of ``CAPS`` rows in
turn (``kernels/dft.MAX_GROUP_ROWS``, the table these timings chose), each
launch queued behind a device spin so that CUDA events time the device
alone, rounds in alternating order. Prints one line a shape with the
median ms of each cap (``*`` marks the table's) and, last, one JSON object
with every median. Needs an NVIDIA GPU.

``--wrappers`` times the public wrappers instead, with no group sweep:
``dft.rdft`` / ``dft.irdft`` / ``dft.cdft`` (both operands) at fno2d and
fno2d-large and ``cgemm.cgemm`` at the FNO's CGEMM shapes, each beside
the one PyTorch call that computes the same function on its f32 inputs
(``torch.fft`` / ``torch.matmul`` on complex64; a yardstick). The
wrappers are the same in every checkout since the partial variant's port,
so run by path with another checkout's package first on the path,

    PYTHONPATH=<checkout>/src python src/repro_torch/launch/row_groups.py \
        --wrappers

times that checkout's kernels with this script; two checkouts run in
turns in one call compare on one card.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.core import spectral
from repro_torch.kernels import build, dft
from repro_torch.kernels import cgemm as cgemm_k

ARCHS = ("fno2d", "fno2d-large", "fno3d")
KINDS = ("rdft", "irdft", "cdft", "icdft")
# Group caps swept per launch kind, in rows.
CAPS = {"rdft": (64, 128, 256), "irdft": (64, 128, 256),
        "cdft": (16, 32, 64, 128), "icdft": (16, 32, 64, 128)}
CGEMM_SHAPES = ((64, 64, 8192), (128, 128, 8192))  # (M, K, N) at B=8
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
    """(inputs, last-axis operand pair, outer factor pair or None, dims) of
    one launch at the arch's full width: rdft / irdft over the outer axes,
    cdft / icdft over s_1 of the b·h·Πk_2.. rows."""
    cfg = get_config(arch)
    h, n1, k1 = cfg.hidden, cfg.spatial[0], cfg.modes[0]
    osp, omd = tuple(cfg.spatial[1:]), tuple(cfg.modes[1:])
    f = lambda k, n, m: spectral.row_operand_tensors(k, (n,), (m,), dtype,
                                                     "cuda")
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen).to("cuda",
                                                      getattr(torch, dtype))
    if kind in ("cdft", "icdft"):
        rows = b * h * math.prod(omd)
        width = n1 if kind == "cdft" else k1
        return ((rnd(rows, width), rnd(rows, width)), f(kind, n1, k1), None,
                (1, n1 if kind == "cdft" else k1, 1,
                 k1 if kind == "cdft" else n1))
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


def _library(kind, ins, dims):
    """The one torch.fft call that computes a rank-2 row launch's function
    on its inputs as f32 (complex64 built beforehand); dims = (1, n_in, 1,
    n_out) as ``_case`` gives them."""
    n_out = dims[3]
    if kind == "rdft":
        x = ins[0].float()
        return lambda: torch.fft.rfft(x, dim=-1)[..., :n_out]
    c = torch.complex(ins[0].float(), ins[1].float())
    if kind == "irdft":
        return lambda: torch.fft.irfft(c, n=dims[1], dim=-1)
    if kind == "cdft":
        return lambda: torch.fft.fft(c, dim=-1)[..., :n_out]
    return lambda: torch.fft.ifft(c, n=n_out, dim=-1)


def _time_wrappers(args, report) -> None:
    """Median ms of the public wrappers and their library calls over the
    rounds, into `report`."""
    def put(name, fn):
        times = [_time(fn, args.iters) for _ in range(args.rounds)]
        report["ms"][name] = statistics.median(times)
        print(f"{name}: {report['ms'][name]:.4f}", flush=True)

    for arch in ARCHS[:2]:
        for dtype in ("float32", "bfloat16"):
            for kind in KINDS:
                ins, f3, _, dims = _case(kind, arch, args.batch, dtype)
                fn = getattr(dft, "cdft" if kind == "icdft" else kind)
                put(f"{arch} {dtype} {kind}", lambda: fn(*ins, *f3))
                if dtype == "float32":
                    put(f"{arch} {kind} library", _library(kind, ins, dims))
    for m, k, n in CGEMM_SHAPES:
        gen = torch.Generator().manual_seed(m + n)
        planes = [torch.randn(s, generator=gen).to("cuda")
                  for s in ((m, k), (m, k), (k, n), (k, n))]
        a_c = torch.complex(planes[0], planes[1])
        b_c = torch.complex(planes[2], planes[3])
        for dtype in ("float32", "bfloat16"):
            p = [t.to(getattr(torch, dtype)) for t in planes]
            put(f"cgemm {m}x{k}x{n} {dtype}", lambda: cgemm_k.cgemm(*p))
        put(f"cgemm {m}x{k}x{n} library", lambda: torch.matmul(a_c, b_c))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--wrappers", action="store_true",
                    help="time the public wrappers and their library "
                         "calls, no sweep")
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
            for kind in KINDS:
                ins, f3, f2, dims = _case(kind, arch, args.batch, dtype)
                launch = "cdft" if kind == "icdft" else kind
                table = dft.MAX_GROUP_ROWS[(kind, f2 is not None, esize)]
                stream = torch.cuda.current_stream().cuda_stream
                caps = CAPS[kind]
                runs = {cap: (lambda g=max(1, cap // dims[0]):
                              dft._launch_rows(lib, launch, ins, f3, f2, dims,
                                               stream, group=g))
                        for cap in caps}
                times = {cap: [] for cap in caps}
                for rnd in range(args.rounds):
                    for cap in caps if rnd % 2 == 0 else caps[::-1]:
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
