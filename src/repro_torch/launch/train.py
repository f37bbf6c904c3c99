"""End-to-end training for both model families (counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 50 --batch 4 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --reduced --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch fno2d ...

An FNO id (``--arch fno*``) trains through ``launch.train_fno`` on its
synthetic PDE data (``--fno-path``: the reference's names, ``xla`` the
staged path, ``pallas`` the hand-written kernels, its default; ``--seq``
and the checkpoint flags are the LM's). An LM arch trains on the
deterministic Zipf token stream (``data.tokens.token_batch`` from seed 0)
with AdamW under the reference's warmup-cosine schedule, through
``train/trainer.Trainer``, checkpointing every ``--ckpt-every`` steps and
at the end into ``--ckpt-dir`` (a fresh temporary directory by default; a
given directory resumes from its latest valid checkpoint). Weights are
random from seed 0 at ``--dtype`` (f32, or bf16 as the reference's cells
build them). ``--device`` is cuda by default and raises where no card is;
``--device cpu`` runs on the CPU (with ``--reduced`` in mind). Prints the
loss, grad norm and ms of every step beside the device's name.
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time

import torch

from repro_torch.configs import ALL_IDS, FNO_IDS, get_config
from repro_torch.configs.base import torch_dtype
from repro_torch.data import tokens
from repro_torch.launch import train_fno
from repro_torch.launch.serve_fno import device_name
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

_DTYPES = {"f32": "float32", "bf16": "bfloat16"}
# The reference's --fno-path names and the port's paths.
_FNO_PATHS = {"ref": "ref", "xla": "staged", "pallas": "fused"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="fno1d", choices=list(ALL_IDS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--fno-path", default="pallas",
                    choices=list(_FNO_PATHS))
    ap.add_argument("--dtype", default="f32", choices=list(_DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train runs on the GPU by default and no CUDA device is "
            "available; pass --device cpu (device='cpu') to run on the CPU")
    return dev


def _fno(args) -> dict:
    argv = ["--arch", args.arch, "--steps", str(args.steps), "--batch",
            str(args.batch), "--lr", str(args.lr), "--path",
            _FNO_PATHS[args.fno_path], "--dtype", args.dtype, "--device",
            args.device] + (["--reduced"] if args.reduced else [])
    return train_fno.run(train_fno.build_parser().parse_args(argv))


def run(args) -> dict:
    if args.arch in FNO_IDS:
        return _fno(args)
    dev = _device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if dev.type == "cuda":  # f32 products in f32, as the reference's
        torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_lm(gen, cfg, torch_dtype(_DTYPES[args.dtype]), dev)
    opt = AdamW(lr=cosine_warmup(args.lr, min(100, args.steps // 10 + 1),
                                 args.steps))
    step = make_train_step(cfg, opt)
    data = lambda i: tokens.token_batch(0, i, args.batch, args.seq,
                                        cfg.vocab_size, device=dev)
    name = device_name(dev)
    print(f"arch={args.arch} params={cfg.param_count() / 1e6:.2f}M "
          f"steps={args.steps} batch={args.batch} seq={args.seq} "
          f"dtype={args.dtype} device={name}")
    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory())
        tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                             ckpt_every=args.ckpt_every, log_every=1)
        t0 = time.perf_counter()
        out = Trainer(tcfg, step, data, params, opt.init(params)).run()
        seconds = time.perf_counter() - t0
    history = [{"step": m["step"], "loss": m["loss"],
                "grad_norm": m["grad_norm"], "ms": 1e3 * m["dt"]}
               for m in out["metrics"]]
    for h in history:
        print(f"  step {h['step']:5d} loss {h['loss']:.4f} gnorm "
              f"{h['grad_norm']:.3f} {h['ms']:.0f}ms on {name}")
    done = out["final_step"]
    print(f"done: {done} steps in {seconds:.1f}s "
          f"({seconds / max(done, 1) * 1e3:.0f} ms/step)")
    return {"arch": args.arch, "dtype": args.dtype, "device": name,
            "final_step": done, "history": history}


def main(argv=None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
