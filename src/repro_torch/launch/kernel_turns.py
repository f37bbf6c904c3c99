"""The block and wgrad kernels' device times at the presets' launches: the
rows of PERF.md's kernel table that run at an untiled plan, so that two
checkouts compare on one card.

    PYTHONPATH=src python -m repro_torch.launch.kernel_turns [--tag NAME]
        [--iters 20]

Times each launch of the block kernel (the forward, the gz recompute, the
dx adjoint, the bare forward and dx, the linear TP-partial block, the
fused lift and projection) and the wgrad kernel (with and without the
bypass) at fno2d, fno3d and fno2d-large (per-mode W) B=8, fno1d's bare
forward B=8 and phase 28's 2D 256² modes 32 B=2, f32 and bf16, each
launch queued behind a device spin so that CUDA events time the device
alone. Prints one JSON object a line: {"tag", "row", "dtype", "ms"}, and
the card's name and power limit first. Needs an NVIDIA GPU.

It calls only the wrappers every checkout since the fused ends has
(``engine.fused_block`` / ``fused_wgrad``), so run by path with another
checkout's package first on the path,

    PYTHONPATH=<checkout>/src python src/repro_torch/launch/kernel_turns.py

times that checkout's kernels with this script; checkouts run in turns
(A, B, B, A) in one call compare on one card.

``--tiled`` times the tiled shapes (``configs.TILED``) instead: the block
forward and the wgrad at B=8 with the cluster pinned to 8 and to 16
(``plan=``), each line with the plan it ran, in two turns (8, 16, 16, 8).
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.core import spectral
from repro_torch.kernels import build, engine

SPIN_CYCLES = 100_000_000  # ~50 ms of device spin ahead of the launches
# (row, arch, batch, spatial and modes where they differ from the arch's)
SHAPES = (("fno2d", "fno2d", 8, None), ("fno3d", "fno3d", 8, None),
          ("fno2d-large", "fno2d-large", 8, None),
          ("fno1d", "fno1d", 8, None),
          ("256x256m32", "fno2d", 2, ((256, 256), (32, 32))))


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


def launches(arch: str, b: int, dtype: str, shape=None):
    """name -> a call of one launch at `arch`'s width, batch b."""
    cfg = get_config(arch)
    spatial, modes = shape or (tuple(cfg.spatial), tuple(cfg.modes))
    h, per_mode = cfg.hidden, cfg.weight_mode == "per_mode"
    gen = torch.Generator().manual_seed(0)
    tdt = getattr(torch, dtype)
    rn = lambda *s, sc=1.0: (sc * torch.randn(s, generator=gen)).to(
        "cuda", tdt)
    wshape = (h, h) + (tuple(modes) if per_mode else ())
    x, gy = rn(b, h, *spatial), rn(b, h, *spatial)
    wr, wi = rn(*wshape, sc=1.0 / h), rn(*wshape, sc=1.0 / h)
    wb, bias = rn(h, h, sc=1.0 / h), rn(h, 1, sc=0.3)
    m = {k: spectral.operand_tensors(spatial, modes, dtype, "cuda", k)
         for k in ("forward", "adjoint", "wgrad")}
    sw = lambda w: w.transpose(0, 1)
    wbt = wb.t().contiguous()
    out = {
        "block_fwd": lambda: engine.fused_block(x, wr, wi, wb, bias,
                                                m["forward"]),
        "wgrad": lambda: engine.fused_wgrad(x, gy, m["wgrad"],
                                            per_mode=per_mode),
    }
    if arch == "fno1d":
        return {"spectral_fwd": lambda: engine.fused_block(
            x, wr, wi, None, None, m["forward"], act="linear")}
    if shape is not None:
        return out
    out.update({
        "gz_recompute": lambda: engine.fused_block(
            x, wr, wi, wb, bias, m["forward"], act="gelu_vjp", gy=gy),
        "dx_adjoint": lambda: engine.fused_block(
            gy, sw(wr), sw(wi), wbt, None, m["adjoint"],
            act="linear", out_dtype=torch.float32, adjoint=True),
        "spectral_fwd": lambda: engine.fused_block(
            x, wr, wi, None, None, m["forward"], act="linear"),
        "spectral_dx": lambda: engine.fused_block(
            gy, sw(wr), sw(wi), None, None, m["adjoint"], act="linear",
            adjoint=True),
        "spectral_wgrad": lambda: engine.fused_wgrad(
            x, gy, m["wgrad"], per_mode=per_mode, with_bypass=False),
    })
    if not per_mode:
        out["block_linear"] = lambda: engine.fused_block(
            x, wr, wi, wb, bias, m["forward"], act="linear",
            out_dtype=torch.float32)
    if arch in ("fno2d", "fno3d"):
        cin, lw, cout = cfg.in_channels, 2 * h, cfg.out_channels
        xin = rn(b, cin, *spatial)
        lift = (rn(lw, cin, sc=0.7), rn(lw, 1, sc=0.3),
                rn(h, lw, sc=lw ** -0.5), rn(h, 1, sc=0.3))
        proj = (rn(lw, h, sc=h ** -0.5), rn(lw, 1, sc=0.3),
                rn(cout, lw, sc=lw ** -0.5), rn(cout, 1, sc=0.3))
        out["ends_lift"] = lambda: engine.fused_block(
            xin, wr, wi, wb, bias, m["forward"], lift=lift)
        out["ends_proj"] = lambda: engine.fused_block(
            x, wr, wi, wb, bias, m["forward"], proj=proj)
    return out


def tiled(iters: int, tag: str) -> None:
    """The tiled shapes' block forward and wgrad at B=8, f32, the cluster
    pinned to 8 and to 16 in turns."""
    from repro_torch.configs import TILED, tiled_config
    for name in TILED:
        cfg = tiled_config(name)
        h, per_mode = cfg.hidden, cfg.weight_mode == "per_mode"
        spatial, modes = tuple(cfg.spatial), tuple(cfg.modes)
        gen = torch.Generator().manual_seed(0)
        rn = lambda *s, sc=1.0: (sc * torch.randn(s, generator=gen)).cuda()
        wshape = (h, h) + (modes if per_mode else ())
        x, gy = rn(8, h, *spatial), rn(8, h, *spatial)
        wr, wi = rn(*wshape, sc=1.0 / h), rn(*wshape, sc=1.0 / h)
        wb, bias = rn(h, h, sc=1.0 / h), rn(h, 1, sc=0.3)
        m = {k: spectral.operand_tensors(spatial, modes, "float32", "cuda",
                                         k) for k in ("forward", "wgrad")}
        args = (8, h, h, spatial, modes, per_mode)
        for cl in (8, 16, 16, 8):
            pin = (("cluster", cl),)
            runs = {"block_fwd": (
                        lambda: engine.fused_block(x, wr, wi, wb, bias,
                                                   m["forward"], plan=pin),
                        lambda: engine.pick_plan(build.load_fused_block(),
                                                 0, *args, plan=pin)),
                    "wgrad": (
                        lambda: engine.fused_wgrad(x, gy, m["wgrad"],
                                                   per_mode=per_mode,
                                                   plan=pin),
                        lambda: engine.pick_wgrad_plan(
                            build.load_fused_wgrad(), 0, *args, plan=pin))}
            for kind, (fn, plan_of) in runs.items():
                line = {"tag": tag, "row": f"{name} {kind}",
                        "dtype": "float32", "cluster": cl}
                try:
                    line["plan"] = plan_of()
                except engine.PlanRefused as exc:  # no plan at this size
                    print(json.dumps({**line, "refused": str(exc)}),
                          flush=True)
                    continue
                print(json.dumps({**line, "ms": _time(fn, iters)}),
                      flush=True)
        del x, gy, wr, wi
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tiled", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_turns: needs a CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.tiled:
        tiled(args.iters, args.tag)
        return 0
    for row, arch, b, shape in SHAPES:
        for dtype in ("float32", "bfloat16"):
            for name, fn in launches(arch, b, dtype, shape).items():
                ms = _time(fn, args.iters)
                print(json.dumps({"tag": args.tag, "row": f"{row} {name}",
                                  "dtype": dtype, "ms": ms}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
