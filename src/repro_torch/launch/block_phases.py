"""Where the fused kernels' time goes, phase by phase, on the card.

    PYTHONPATH=src python -m repro_torch.launch.block_phases [--batch 8]
        [--arch fno2d-large] [--fuse-ends]

Builds ``csrc/fused_block.cu`` and ``csrc/fused_wgrad.cu`` as they are and
with each phase's loop elided (``-DFUSED_BLOCK_ELIDE=<mask>`` /
``-DFUSED_WGRAD_ELIDE=<mask>``, see ``PHASE_BOUND`` in the sources: the
output is then wrong and only the time counts), times every variant at
fno2d full width (or ``--arch``'s: fno2d-large runs the per-mode modes,
fno3d the rank-3 chain at 3 s_1 rows a chunk)
with CUDA events, in turns over several rounds, and prints
each phase's time as the whole kernel's median minus the median of the
variant without that phase.

fused_block (the block forward):
  phase 1 — truncated forward DFT chain of each block's hidden slice;
  phase 2 — CGEMM over distributed shared memory (per-mode: W streamed
            from device memory);
  phase 3 — padded inverse chain, bypass, bias, gelu and the write of y.
fused_wgrad (the weight gradients):
  phase 1 — the forward chain of x and the adjoint-forward chain of gz;
  phase 2 — the dW reduction over distributed shared memory (per-mode:
            the sample's spectra written to the workspace);
  phase 3 — the dW_b and dbias product over each block's points (the sum
            of the cluster's partials stays in "rest");
  phase 4 — the batch reduction of the last block of each cluster rank
            (per-mode: forming dW of its out slice from the workspace).
With ``--fuse-ends`` only the block kernel runs, as one launch with both
model ends (a 1-layer model's; the arch's lift width and channels), and
two more phases split out:
  phase 4 — the lift prologue of phase 1 (the hidden slice of each chunk
            formed from the raw input; phase 3's folded bypass stays in
            phase 3);
  phase 5 — the projection: the cluster's exchange of the activated
            channels and the projection MLP.

The last line is one JSON object with the medians. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import subprocess

import torch

from repro_torch.configs import FNO_IDS, get_config
from repro_torch.core import spectral
from repro_torch.kernels import build, engine

PHASES = (1, 2, 3)
WGRAD_PHASES = PHASES + (4,)
ENDS_PHASES = PHASES + (4, 5)


def variants(phases):
    """Variant name -> elision mask (bit i elides phase i)."""
    return {"whole": 0, **{f"no_phase{i}": 1 << i for i in phases},
            "no_phases": sum(1 << i for i in phases)}
# Kernel -> (source, elision macro, library loader).
KERNELS = {
    "fused_block": ("fused_block", "FUSED_BLOCK_ELIDE",
                    build.load_block_library),
    "fused_wgrad": ("fused_wgrad", "FUSED_WGRAD_ELIDE",
                    build.load_wgrad_library),
}


def _time(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="fno2d", choices=list(FNO_IDS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--fuse-ends", action="store_true",
                    help="time the block kernel's ends launch (lift and "
                         "projection) with phases 4 and 5 split out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("block_phases: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)

    kernels = ["fused_block"] if args.fuse_ends else list(KERNELS)
    phases = {k: ENDS_PHASES if args.fuse_ends else
              WGRAD_PHASES if k == "fused_wgrad" else PHASES
              for k in kernels}
    named = {k: variants(phases[k]) for k in kernels}
    jobs = [(k, v, m) for k in kernels for v, m in named[k].items()]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(
            lambda j: build.build(KERNELS[j[0]][0],
                                  (f"{KERNELS[j[0]][1]}={j[2]}",)), jobs))
    libs = {}
    for (kernel, variant, _), path in zip(jobs, paths):
        libs.setdefault(kernel, {})[variant] = KERNELS[kernel][2](path)

    cfg = get_config(args.arch)
    per_mode = cfg.weight_mode == "per_mode"
    b, h = args.batch, cfg.hidden
    spatial, modes = cfg.spatial, cfg.modes
    gen = torch.Generator().manual_seed(0)
    x32 = torch.randn((b, h) + tuple(spatial), generator=gen).cuda()
    gz32 = torch.randn((b, h) + tuple(spatial), generator=gen).cuda()
    wshape = (h, h) + (tuple(modes) if per_mode else ())
    ws32 = [(torch.randn(wshape, generator=gen) / h).cuda()
            for _ in range(2)] + [(torch.randn((h, h), generator=gen)
                                   / h).cuda(), torch.zeros((h, 1)).cuda()]
    lw = cfg.lifting_dim or 2 * h
    rng = torch.Generator().manual_seed(1)
    mk = lambda *s: (torch.randn(s, generator=rng) / s[-1] ** 0.5).cuda()
    xin32 = torch.randn((b, cfg.in_channels) + tuple(spatial),
                        generator=gen).cuda()
    ends32 = (mk(lw, cfg.in_channels), mk(lw, 1), mk(h, lw), mk(h, 1),
              mk(lw, h), mk(lw, 1), mk(cfg.out_channels, lw),
              mk(cfg.out_channels, 1))
    report = {"card": smi, "batch": b, "config": args.arch,
              "fuse_ends": args.fuse_ends}
    for kernel in kernels:
        report[kernel] = {}
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            x, gz = x32.to(tdt), gz32.to(tdt)
            ws = [w.to(tdt) for w in ws32]
            stream = torch.cuda.current_stream().cuda_stream
            if kernel == "fused_block" and args.fuse_ends:
                mats = spectral.operand_tensors(spatial, modes, dt, "cuda")
                e = [t.to(tdt) for t in ends32]
                xin = xin32.to(tdt)
                run = lambda lib: engine._launch(
                    lib, xin, *ws, mats, spatial, modes, stream,
                    lift=e[:4], proj=e[4:])
            elif kernel == "fused_block":
                mats = spectral.operand_tensors(spatial, modes, dt, "cuda")
                run = lambda lib: engine._launch(lib, x, *ws, mats, spatial,
                                                 modes, stream)
            else:
                mats = spectral.operand_tensors(spatial, modes, dt, "cuda",
                                                "wgrad")
                run = lambda lib: engine._launch_wgrad(lib, x, gz, mats,
                                                       spatial, modes, stream,
                                                       per_mode)
            times = {name: [] for name in named[kernel]}
            for rnd in range(args.rounds):
                order = (list(times) if rnd % 2 == 0
                         else list(times)[::-1])
                for name in order:
                    lib = libs[kernel][name]
                    times[name].append(_time(lambda: run(lib), args.iters))
            med = {k: statistics.median(v) for k, v in times.items()}
            split = {f"phase{i}_ms": med["whole"] - med[f"no_phase{i}"]
                     for i in phases[kernel]}
            report[kernel][dt] = {"median_ms": med, **split,
                                  "spread_ms": {k: max(v) - min(v)
                                                for k, v in times.items()}}
            print(f"{kernel} {dt}: whole={med['whole']:.4f} ms " + " ".join(
                f"{k}={v:.4f}" for k, v in split.items())
                + f" rest={med['no_phases']:.4f}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
