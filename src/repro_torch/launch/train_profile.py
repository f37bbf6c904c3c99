"""Where a training step's time goes on the card: a ``torch.profiler`` trace
of FNO training steps at full width (fno2d unless ``--arch`` names another
model: fno2d-large, fno3d), or, with ``--serve``, of served requests.

    PYTHONPATH=src python -m repro_torch.launch.train_profile [--dtype bf16]
        [--serve] [--variant partial] [--arch fno2d-large] [--no-fuse-block]
        [--fuse-ends]

Runs warm-up steps, then traces ``--steps`` train steps (fused path, batch
8 of the arch's PDE data from seed 0 — Darcy in 2D, diffusion in 3D —,
AdamW) with CPU and CUDA activities, and
prints the device time per step by kernel (top entries), the device's busy
time against the step's wall time (its idle share), and the host time per
step. With ``--serve`` a step is one request of those 8 samples to
``FNOServer``, waited for as a client would. ``--no-fuse-block`` profiles
the spectral-only path (the kernels fuse each spectral conv; the bypass,
bias and GELU are PyTorch ops). ``--fuse-ends`` folds the lifting MLP into
the first block's launch and the projection MLP into the last one's
(whole-block fusion, full variant). The last line is one JSON object.
Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import FNO_IDS, get_config, with_precision
from repro_torch.configs.fno import with_fuse_block, with_fuse_ends
from repro_torch.core import fno as fno_mod
from repro_torch.launch.train_fno import batch_fn
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train.serve_fno_step import FNOServer
from repro_torch.train.train_step import make_train_step


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="fno2d", choices=list(FNO_IDS),
                    help="the FNO at full width")
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--serve", action="store_true",
                    help="trace served requests instead of train steps")
    ap.add_argument("--variant", default="full",
                    choices=["full", "partial"],
                    help="full or partial fusion of the blocks' forward")
    ap.add_argument("--no-fuse-block", action="store_true",
                    help="fuse each spectral conv only (the paper's "
                         "design), not the whole block")
    ap.add_argument("--fuse-ends", action="store_true",
                    help="fold the end MLPs into the first and last "
                         "block's launch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = with_precision(with_fuse_block(get_config(args.arch),
                                         not args.no_fuse_block), args.dtype)
    cfg = with_fuse_ends(cfg, args.fuse_ends)
    cfg = dataclasses.replace(cfg, path="fused")
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg, "cuda")
    batch = batch_fn(cfg, 8, "cuda")(0)
    opt = AdamW(lr=constant(1e-4))
    step = make_train_step(cfg, opt, fno_path="fused",
                           fno_variant=args.variant)
    carry = [params, opt.init(params)]
    server = FNOServer(cfg, params, device="cuda", variant=args.variant,
                       max_batch=8)

    def run():
        if args.serve:
            server(batch["x"])
            torch.cuda.synchronize()
        else:
            carry[0], carry[1], _ = step(*carry, batch)

    for _ in range(5):
        run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only: a host op that launches a kernel reports the
    # kernel's time as its own too (the ctypes launches have no aten op).
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    if not events:
        raise SystemExit("train_profile: the trace holds no device events")
    per_step = lambda us: us / 1e3 / args.steps  # µs total -> ms per step
    device_ms = per_step(sum(e.self_device_time_total for e in events))
    wall_ms = 1e3 * wall / args.steps
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:args.top]
    what = "serve" if args.serve else "train"
    print(f"{what} arch={args.arch} variant={args.variant} "
          f"fuse_block={cfg.fuse_block} fuse_ends={cfg.fuse_ends} "
          f"dtype={args.dtype} "
          f"steps={args.steps}: wall "
          f"{wall_ms:.4f} ms per step, device busy {device_ms:.4f} ms per step, idle share "
          f"{1 - device_ms / wall_ms:.4f}")
    rows = []
    for e in top:
        ms = per_step(e.self_device_time_total)
        rows.append({"name": e.key[:80], "ms_per_step": ms,
                     "calls_per_step": e.count / args.steps})
        print(f"  {ms:9.4f} ms  {e.count / args.steps:7.1f} calls  "
              f"{e.key[:80]}")
    print(json.dumps({"card": smi, "what": what, "arch": args.arch,
                      "variant": args.variant,
                      "fuse_block": cfg.fuse_block,
                      "fuse_ends": cfg.fuse_ends,
                      "dtype": args.dtype,
                      "steps": args.steps,
                      "wall_ms_per_step": wall_ms,
                      "device_ms_per_step": device_ms,
                      "idle_share": 1 - device_ms / wall_ms, "top": rows}))


if __name__ == "__main__":
    main()
