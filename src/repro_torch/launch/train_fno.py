"""FNO training driver (counterpart of the FNO branch of
``repro/launch/train.py``, with ``--dtype`` and ``--path`` as in
``examples/train_fno.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_fno --arch fno2d \
        --steps 100 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train_fno --reduced \
        --device cpu --steps 2

Trains on synthetic PDE data made in the run from seed 0 (Burgers 1D,
Darcy 2D, diffusion 3D), with AdamW and the reference's warmup-cosine
schedule, through ``train/trainer.Trainer`` (prefetched batches,
checkpoints every 50 steps and at the end into a temporary directory, a
non-finite step raises ``NaNBudgetExceeded``). On the fused path every
FNO block trains through the hand-written kernels: one launch forward
(``--variant full``; ``partial`` runs the paper's partial fusion, three
launches and the staged tail) and three backward. With
``--no-fuse-block`` the kernels fuse each spectral conv only, as the
paper does: one launch forward (three partial) and two backward, with the
bypass, bias and GELU in PyTorch. Runs on the GPU by
default; ``--device cpu`` runs the kernels' plain versions. Prints loss
and grad norm per step beside the device's name.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import FNO_IDS, get_config, with_precision
from repro_torch.configs.fno import with_fuse_block
from repro_torch.core import fno as fno_mod
from repro_torch.data import pde
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="fno2d", choices=list(FNO_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--path", default="fused",
                    choices=["ref", "staged", "fused"],
                    help="fused = the CUDA kernels forward and backward")
    ap.add_argument("--variant", default="full",
                    choices=["full", "partial"],
                    help="full: one block kernel per layer forward; "
                         "partial: the paper's partial fusion")
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="bf16: bf16 compute and DFT operands with f32 "
                         "master params, accumulators and AdamW update")
    ap.add_argument("--no-fuse-block", action="store_true",
                    help="fused path: fuse each spectral conv only, with "
                         "the bypass, bias and GELU in PyTorch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    return ap


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train_fno trains on the GPU by default and no CUDA device is "
            "available; pass --device cpu (device='cpu') to run the plain "
            "versions")
    return dev


def batch_fn(cfg, batch: int, device):
    """Batch i of the run's PDE task, from seed 0."""
    n = cfg.spatial[0]
    if cfg.ndim == 1:
        return lambda i: pde.burgers_batch(0, i, batch, n, device=device)
    if cfg.ndim == 2:
        return lambda i: pde.darcy_batch(0, i, batch, n, device=device)
    return lambda i: pde.diffusion3d_batch(0, i, batch, n, device=device)


def run(args) -> dict:
    dev = _device(args.device)
    cfg = with_precision(get_config(args.arch, reduced=args.reduced),
                         args.dtype)
    fuse = args.path == "fused" and not args.no_fuse_block
    cfg = dataclasses.replace(with_fuse_block(cfg, fuse), path=args.path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg, dev)
    opt = AdamW(lr=cosine_warmup(args.lr, min(100, args.steps // 10 + 1),
                                 args.steps))
    step = make_train_step(cfg, opt, fno_path=args.path,
                           fno_variant=args.variant)
    data = batch_fn(cfg, args.batch, dev)
    state = opt.init(params)
    print(f"train_fno arch={cfg.name} params={cfg.param_count()} "
          f"path={args.path} variant={args.variant} "
          f"fuse_block={cfg.fuse_block} dtype={args.dtype} "
          f"batch={args.batch} "
          f"steps={args.steps} device={name}")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                             ckpt_every=50, log_every=1, nan_skip_budget=0)
        out = Trainer(tcfg, step, data, params, state).run()
    history = [{"step": m["step"] + 1, "loss": m["loss"],
                "grad_norm": m["grad_norm"], "ms": 1e3 * m["dt"]}
               for m in out["metrics"]]
    for h in history:
        print(f"  step {h['step']:5d} loss {h['loss']:.6f} gnorm "
              f"{h['grad_norm']:.6f} {h['ms']:.1f} ms on {name}")
    return {"arch": cfg.name, "path": args.path, "variant": args.variant,
            "fuse_block": cfg.fuse_block, "dtype": args.dtype,
            "device": name, "history": history}


def main() -> None:
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
