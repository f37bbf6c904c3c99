"""Batched FNO serving driver (counterpart of ``repro/launch/serve_fno.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_fno --arch fno2d \
        --requests 8 --max-batch 8

Serves request batches of seeded random sizes through ``FNOServer`` on the
GPU (``--device cpu`` runs the plain versions), asserts every output is
finite, and prints samples/s beside the device's name. On the fused path
every FNO layer is one launch of the CUDA block kernel (``--variant
full``) or the paper's partial fusion (``--variant partial``: row rDFT,
fused core and row irDFT launches, then the block tail).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import FNO_IDS, get_config, with_precision
from repro_torch.configs.fno import with_fuse_block
from repro_torch.core import fno as fno_mod
from repro_torch.train import serve_fno_step as sfs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="fno2d", choices=list(FNO_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of synthetic request batches to serve")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="largest request batch (and bucket ceiling)")
    ap.add_argument("--path", default="fused",
                    choices=["ref", "staged", "fused"])
    ap.add_argument("--variant", default="full",
                    choices=["full", "partial"],
                    help="full: one block kernel per layer; partial: the "
                         "paper's partial fusion")
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--rollout-steps", type=int, default=1,
                    help="serve K-step autoregressive rollouts (the carry "
                         "stays on the device between steps)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run(args) -> dict:
    cfg = with_precision(get_config(args.arch, reduced=args.reduced),
                         args.dtype)
    cfg = with_fuse_block(cfg, args.path == "fused")
    cfg = dataclasses.replace(cfg, path=args.path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg)
    server = sfs.FNOServer(cfg, params, device=args.device,
                           variant=args.variant, max_batch=args.max_batch)
    dev = server.device
    shape = (cfg.in_channels,) + tuple(cfg.spatial)

    # Warm every bucket (kernel build, allocator) outside the timed loop.
    for b in server.buckets:
        server(torch.zeros((b,) + shape), rollout_steps=args.rollout_steps)
    _sync(dev)

    rng = np.random.default_rng(0)
    sizes = rng.integers(1, args.max_batch + 1, size=args.requests)
    gen = torch.Generator().manual_seed(1)
    reqs = [torch.randn((int(n),) + shape, generator=gen).to(dev)
            for n in sizes]
    _sync(dev)
    t0 = time.perf_counter()
    ys = [server(x, rollout_steps=args.rollout_steps) for x in reqs]
    _sync(dev)
    dt = time.perf_counter() - t0
    for y in ys:
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError("non-finite serve output")

    samples = int(sizes.sum())
    out = {
        "arch": args.arch, "path": args.path, "variant": args.variant,
        "dtype": args.dtype,
        "device": device_name(dev), "buckets": list(server.buckets),
        "rollout_steps": args.rollout_steps, "requests": args.requests,
        "samples": samples, "padded": server.stats["padded"],
        "seconds": dt, "samples_per_s": samples / max(dt, 1e-9),
    }
    print(f"serve_fno arch={args.arch} path={args.path} "
          f"variant={args.variant} dtype={args.dtype} "
          f"device={out['device']} buckets={list(server.buckets)}")
    print(f"  served {args.requests} requests / {samples} samples "
          f"(rollout K={args.rollout_steps}) in {dt * 1e3:.3f} ms "
          f"({out['samples_per_s']:.1f} samples/s on {out['device']}, "
          f"{server.stats['padded']} padded), all outputs finite")
    return out


def main() -> None:
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
