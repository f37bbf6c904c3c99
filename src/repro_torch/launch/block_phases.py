"""Where the fused kernels' time goes, phase by phase, on the card.

    PYTHONPATH=src python -m repro_torch.launch.block_phases [--batch 8]

Builds ``csrc/fused_block.cu`` and ``csrc/fused_wgrad.cu`` as they are and
with each phase's loop elided (``-DFUSED_BLOCK_ELIDE=<mask>`` /
``-DFUSED_WGRAD_ELIDE=<mask>``, see ``PHASE_BOUND`` in the sources: the
output is then wrong and only the time counts), times every variant at
fno2d full width with CUDA events, in turns over several rounds, and prints
each phase's time as the whole kernel's median minus the median of the
variant without that phase.

fused_block (the block forward):
  phase 1 — truncated forward DFT chain of each block's hidden slice;
  phase 2 — CGEMM over distributed shared memory;
  phase 3 — padded inverse chain, bypass, bias, gelu and the write of y.
fused_wgrad (the weight gradients):
  phase 1 — the forward chain of x and the adjoint-forward chain of gz;
  phase 2 — the dW reduction over distributed shared memory;
  phase 3 — the dW_b and dbias reductions over the points.

The last line is one JSON object with the medians. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.core import spectral
from repro_torch.kernels import build, engine

PHASES = (1, 2, 3)
# Variant name -> elision mask (bit i elides phase i).
VARIANTS = {"whole": 0, **{f"no_phase{i}": 1 << i for i in PHASES},
            "no_phases": sum(1 << i for i in PHASES)}
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
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("block_phases: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)

    jobs = [(k, v, m) for k, (_, macro, _) in KERNELS.items()
            for v, m in VARIANTS.items()]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(
            lambda j: build.build(KERNELS[j[0]][0],
                                  (f"{KERNELS[j[0]][1]}={j[2]}",)), jobs))
    libs = {}
    for (kernel, variant, _), path in zip(jobs, paths):
        libs.setdefault(kernel, {})[variant] = KERNELS[kernel][2](path)

    cfg = get_config("fno2d")
    b, h = args.batch, cfg.hidden
    spatial, modes = cfg.spatial, cfg.modes
    gen = torch.Generator().manual_seed(0)
    x32 = torch.randn((b, h) + tuple(spatial), generator=gen).cuda()
    gz32 = torch.randn((b, h) + tuple(spatial), generator=gen).cuda()
    ws32 = [(torch.randn((h, h), generator=gen) / h).cuda()
            for _ in range(3)] + [torch.zeros((h, 1)).cuda()]
    report = {"card": smi, "batch": b, "config": "fno2d"}
    for kernel in KERNELS:
        report[kernel] = {}
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            x, gz = x32.to(tdt), gz32.to(tdt)
            ws = [w.to(tdt) for w in ws32]
            stream = torch.cuda.current_stream().cuda_stream
            if kernel == "fused_block":
                mats = spectral.operand_tensors(spatial, modes, dt, "cuda")
                run = lambda lib: engine._launch(lib, x, *ws, mats, spatial,
                                                 modes, stream)
            else:
                mats = spectral.operand_tensors(spatial, modes, dt, "cuda",
                                                "wgrad")
                run = lambda lib: engine._launch_wgrad(lib, x, gz, mats,
                                                       spatial, modes, stream)
            times = {name: [] for name in VARIANTS}
            for rnd in range(args.rounds):
                order = list(VARIANTS) if rnd % 2 == 0 else list(VARIANTS)[::-1]
                for name in order:
                    lib = libs[kernel][name]
                    times[name].append(_time(lambda: run(lib), args.iters))
            med = {k: statistics.median(v) for k, v in times.items()}
            phases = {f"phase{i}_ms": med["whole"] - med[f"no_phase{i}"]
                      for i in PHASES}
            report[kernel][dt] = {"median_ms": med, **phases,
                                  "spread_ms": {k: max(v) - min(v)
                                                for k, v in times.items()}}
            print(f"{kernel} {dt}: whole={med['whole']:.4f} ms " + " ".join(
                f"{k}={v:.4f}" for k, v in phases.items())
                + f" rest={med['no_phases']:.4f}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
