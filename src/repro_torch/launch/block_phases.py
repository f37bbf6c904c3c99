"""Where the fused block kernel's time goes, phase by phase, on the card.

    PYTHONPATH=src python -m repro_torch.launch.block_phases [--batch 8]

Builds ``csrc/fused_block.cu`` as it is and with each phase's loop elided
(``-DFUSED_BLOCK_ELIDE=<mask>``, see ``PHASE_BOUND`` in the source: the
output is then wrong and only the time counts), times every variant at fno2d
full width with CUDA events, in turns over several rounds, and prints each
phase's time as the whole kernel's median minus the median of the variant
without that phase:

  phase 1 — truncated forward DFT chain of each block's hidden slice;
  phase 2 — CGEMM over distributed shared memory;
  phase 3 — padded inverse chain, bypass, bias, gelu and the write of y.

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
# Variant name -> FUSED_BLOCK_ELIDE mask (bit i elides phase i).
VARIANTS = {"whole": 0, **{f"no_phase{i}": 1 << i for i in PHASES},
            "no_phases": sum(1 << i for i in PHASES)}


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

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(
            lambda m: build.build("fused_block", (f"FUSED_BLOCK_ELIDE={m}",)),
            VARIANTS.values())))
    libs = {name: build.load_block_library(p) for name, p in paths.items()}

    cfg = get_config("fno2d")
    b, h = args.batch, cfg.hidden
    spatial, modes = cfg.spatial, cfg.modes
    gen = torch.Generator().manual_seed(0)
    x32 = torch.randn((b, h) + tuple(spatial), generator=gen).cuda()
    ws32 = [(torch.randn((h, h), generator=gen) / h).cuda()
            for _ in range(3)] + [torch.zeros((h, 1)).cuda()]
    report = {"card": smi, "batch": b, "config": "fno2d"}
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        x = x32.to(tdt)
        ws = [w.to(tdt) for w in ws32]
        mats = spectral.operand_tensors(spatial, modes, dt, "cuda")
        stream = torch.cuda.current_stream().cuda_stream
        times = {name: [] for name in libs}
        for rnd in range(args.rounds):
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for name in order:
                lib = libs[name]
                times[name].append(_time(
                    lambda: engine._launch(lib, x, *ws, mats, spatial,
                                           modes, stream), args.iters))
        med = {k: statistics.median(v) for k, v in times.items()}
        phases = {f"phase{i}_ms": med["whole"] - med[f"no_phase{i}"]
                  for i in PHASES}
        report[dt] = {"median_ms": med, **phases,
                      "spread_ms": {k: max(v) - min(v)
                                    for k, v in times.items()}}
        print(f"{dt}: whole={med['whole']:.4f} ms " + " ".join(
            f"{k}={v:.4f}" for k, v in phases.items())
            + f" rest={med['no_phases']:.4f}")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
