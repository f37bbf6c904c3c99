"""Serving CLI: batched prefill and greedy autoregressive decode for the
LM zoo, batched bucketed inference for the FNO archs (counterpart of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --batch 4 --prompt-len 32 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch fno2d ...

An FNO id (``--arch fno*``) hands the whole command line to
``launch.serve_fno``. An LM arch draws random weights and prompts from
seed 0 (``--dtype``: f32 or bf16 weights and activations), prefills the
prompts, decodes ``--new-tokens`` tokens greedily and prints the
prefill's and decode's times beside the device's name, then the first
row's tokens. ``--device`` is cuda by default and raises where no card
is; ``--device cpu`` runs on the CPU (with ``--reduced`` in mind).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, FNO_IDS, get_config
from repro_torch.configs.base import torch_dtype
from repro_torch.launch import serve_fno
from repro_torch.launch.serve_fno import _sync, device_name
from repro_torch.models import transformer as tf
from repro_torch.models.frontend import fake_frontend_arrays
from repro_torch.train import serve_step

_DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list(ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--dtype", default="f32", choices=list(_DTYPES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "serve runs on the GPU by default and no CUDA device is "
            "available; pass --device cpu to run on the CPU")
    return dev


def run(args) -> dict:
    """Prefill and greedy decode of one LM arch; the printed numbers."""
    dev = _device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if not cfg.is_decoder:
        raise SystemExit(f"serve: {args.arch} is encoder-only and has no "
                         f"decode loop")
    if dev.type == "cuda":  # f32 products in f32, as the reference's
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch_dtype(_DTYPES[args.dtype])
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_lm(gen, cfg, dtype, dev)
    max_len = args.prompt_len + args.new_tokens
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    extra = fake_frontend_arrays(cfg, args.batch, args.prompt_len, gen,
                                 dtype, dev)
    prefill = serve_step.make_prefill_step(cfg, max_len=max_len)
    decode = serve_step.make_decode_step(cfg)

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompts, **extra})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(args.new_tokens - 1):
            tok, _, cache = decode(params, cache, tok)
            out.append(tok)
        _sync(dev)
        t_dec = time.perf_counter() - t0
    gen_tokens = torch.stack(out, dim=1).cpu()
    steps = max(args.new_tokens - 1, 1)
    result = {"arch": args.arch, "batch": args.batch,
              "device": device_name(dev), "prefill_ms": t_prefill * 1e3,
              "decode_ms_per_token": t_dec / steps * 1e3,
              "tokens": gen_tokens.tolist()}
    print(f"arch={args.arch} batch={args.batch} "
          f"prefill({args.prompt_len} toks)={t_prefill * 1e3:.0f}ms "
          f"decode={t_dec / steps * 1e3:.1f}ms/tok device={result['device']}")
    print("generated tokens[0]:", result["tokens"][0])
    return result


def main(argv=None) -> None:
    peek = argparse.ArgumentParser(add_help=False)
    peek.add_argument("--arch", default="qwen2-1.5b")
    known, _ = peek.parse_known_args(argv)
    if known.arch in FNO_IDS:
        serve_fno.run(serve_fno.build_parser().parse_args(argv))
        return
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
