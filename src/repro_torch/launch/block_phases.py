"""Where the fused kernels' time goes, phase by phase, on the card.

    PYTHONPATH=src python -m repro_torch.launch.block_phases [--batch 8]
        [--arch fno2d-large] [--fuse-ends] [--chain tc|fma]
        [--kernel core [--clocks | --host] [--core-force cluster=4,np=2]]

Builds ``csrc/fused_block.cu`` and ``csrc/fused_wgrad.cu`` as they are and
with each phase's loop elided (``-DFUSED_BLOCK_ELIDE=<mask>`` /
``-DFUSED_WGRAD_ELIDE=<mask>``, see ``PHASE_BOUND`` in the sources: the
output is then wrong and only the time counts), times every variant at
fno2d full width (or ``--arch``'s: fno2d-large runs the per-mode modes,
fno3d the rank-3 chains) with CUDA events, in turns over several rounds,
and prints each phase's time as the whole kernel's median minus the median
of the variant without that phase. ``--chain`` forces both kernels'
phase-1 chain (the plans' "chain": "tc" the tensor cores, "fma" the CUDA
cores) where the planner would pick by fit.

fused_block (the block forward):
  phase 1 — truncated forward DFT chain of each block's hidden slice;
  phase 2 — CGEMM over distributed shared memory (per-mode: W streamed
            from device memory);
  phase 3 — padded inverse chain, bypass, bias, gelu and the write of y;
  phase 6 — within phase 3, the inverse chain alone;
  phase 7 — within phase 3, the bypass's loop over the hidden channels
            (what is left of phase 3 is bias, gelu and the write of y).
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
With ``--kernel core`` only the partial variant's core runs
(``csrc/fused_core.cu``, ``-DFUSED_CORE_ELIDE=<mask>``), at the arch's
block (fno2d-large per-mode W), on z pairs of B samples, timed queued
behind a device spin (device time only):
  phase 1 — the truncated forward DFT along s_1;
  phase 2 — the CGEMM (per-mode: W streamed; the cluster's gather of A);
  phase 3 — the padded inverse DFT along s_1 and the write of y;
  phase 4 — within phase 2, the gather of A through distributed shared
            memory;
  phase 5 — within phase 2, the per-mode W stream;
  phase 6 — within phase 1, the copies of z into shared memory;
  phase 7 — within phase 3, the stores of y;
  phase 8 — within phase 2, the products;
  phase 9 — within phase 1, the products.
``--clocks`` builds the core with ``-DFUSED_CORE_CLOCKS`` and prints, per
launch, each phase's median duration over the blocks from the card's
nanosecond clock (set-up; phase 1; the cluster barrier after it; phase 2;
the barrier after it; phase 3), a block's median life and the launch's
span from the first block's start to the last block's end.
``--core-force cluster=4,np=2`` pins fields of the core's plan
(``engine.CORE_LAUNCH``, through ``engine.FORCED``); several plans
separated by ';' are timed whole, in turns. ``--host`` prints the host's
µs per ``engine.fused_core`` call (its checks, plan, allocation and
launch, over calls the device queues up); it uses nothing but
``engine.fused_core``, so run by path with another checkout's ``src``
first on ``PYTHONPATH`` it times that checkout's wrapper.

The last line is one JSON object with the medians. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import math
import statistics
import subprocess
import time

import torch

from repro_torch.configs import FNO_IDS, get_config
from repro_torch.core import spectral
from repro_torch.kernels import build, engine

PHASES = (1, 2, 3)
CORE_PHASES = PHASES + (4, 5, 6, 7, 8, 9)
QUEUE_CYCLES = 20_000_000  # ~10 ms of device spin ahead of queued timing
BLOCK_PHASES = PHASES + (6, 7)
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

def _time(fn, iters: int, queued: bool = False) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:  # every launch enqueued behind the spin: device time only
        torch.cuda._sleep(QUEUE_CYCLES)
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
    ap.add_argument("--chain", choices=engine.CHAINS,
                    help="force both kernels' phase-1 chain")
    ap.add_argument("--kernel", choices=("block", "core"), default="block",
                    help="block: the block and wgrad kernels; core: the "
                         "partial variant's core")
    ap.add_argument("--clocks", action="store_true",
                    help="core: per-block phase durations from the card's "
                         "clock (a build with -DFUSED_CORE_CLOCKS)")
    ap.add_argument("--host", action="store_true",
                    help="core: host µs per engine.fused_core call")
    ap.add_argument("--core-force", default="",
                    help="pin core plan fields, e.g. cluster=4,np=2; "
                         "several plans separated by ';' are timed whole "
                         "(no phases), in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("block_phases: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)

    if args.kernel == "core" and args.host:
        _host_core(args, smi)
        return
    if args.kernel == "core" and args.clocks:
        _clock_core(args, smi)
        return
    if args.kernel == "core" and ";" in args.core_force:
        _sweep_core(args, smi)
        return
    if args.kernel == "core":
        _measure_core(args, smi)
        return
    with engine.forced_chain(args.chain):
        _measure(args, smi)


def _core_inputs(cfg, b: int, dt: str):
    """z pairs, W pair (per-mode for a per-mode arch) and the s_1 operands
    of the arch's block at B=b, and the plan's shape (h, n1, k1, p, k2)."""
    per_mode = cfg.weight_mode == "per_mode"
    h, n1, k1 = cfg.hidden, cfg.spatial[0], cfg.modes[0]
    spec = tuple(cfg.modes[1:][::-1])  # z's outer modes K_R..K_2
    gen = torch.Generator().manual_seed(0)
    tdt = getattr(torch, dt)
    z = [torch.randn((b, h, n1) + spec, generator=gen).to("cuda", tdt)
         for _ in range(2)]
    wshape = (h, h) + ((k1,) + spec[::-1] if per_mode else ())
    w = [(torch.randn(wshape, generator=gen) / h).to("cuda", tdt)
         for _ in range(2)]
    r = len(cfg.spatial)  # the s_1 stages: complex cDFT and padded icDFT
    f = spectral.operand_tensors(cfg.spatial, cfg.modes, dt,
                                 "cuda")[2 * r - 2:2 * r + 2]
    return z + w + list(f), (h, n1, k1, math.prod(spec),
                             spec[-1] if spec else 1)


def _forces(spec: str):
    """The plans of --core-force: ';'-separated entries of k=v pins (an
    empty entry is the planner's own)."""
    return [dict((k, int(v)) for k, v in
                 (kv.split("=") for kv in entry.split(",") if kv))
            for entry in spec.split(";")]


def _host_core(args: argparse.Namespace, smi: str) -> None:
    """Host µs per ``engine.fused_core`` call at the arch's block, f32 and
    bf16: `iters` calls between two reads of the host's clock with no
    synchronise between them (the device queues the launches), median of
    `rounds`."""
    cfg = get_config(args.arch)
    report = {"card": smi, "batch": args.batch, "config": args.arch,
              "kernel": "fused_core", "host_us": {}}
    for dt in ("float32", "bfloat16"):
        ins, _ = _core_inputs(cfg, args.batch, dt)
        for _ in range(3):
            engine.fused_core(*ins)
        us = []
        for _ in range(args.rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                engine.fused_core(*ins)
            us.append((time.perf_counter() - t0) / args.iters * 1e6)
        torch.cuda.synchronize()
        report["host_us"][dt] = {"median": statistics.median(us),
                                 "spread": max(us) - min(us)}
        print(f"fused_core {dt} host us per call: median "
              f"{statistics.median(us):.2f} (spread "
              f"{max(us) - min(us):.2f})")
    print(json.dumps(report))


CLOCK_SPANS = (("setup", 0, 1), ("phase1", 1, 2), ("sync1", 2, 3),
               ("phase2", 3, 4), ("sync2", 4, 5), ("phase3", 5, 6),
               ("block", 0, 6))


def _clock_core(args: argparse.Namespace, smi: str) -> None:
    """Per-block phase durations of the core at each plan of --core-force
    (';' separated), from the stamps of a -DFUSED_CORE_CLOCKS build."""
    lib = build.load_core_library(
        build.build("fused_core", ("FUSED_CORE_CLOCKS=1",)))
    lib.fused_core_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fused_core_clocks.restype = ctypes.c_int
    cfg = get_config(args.arch)
    per_mode = cfg.weight_mode == "per_mode"
    forces = _forces(args.core_force)
    report = {"card": smi, "batch": args.batch, "config": args.arch,
              "kernel": "fused_core", "clocks": []}
    for dt in ("float32", "bfloat16"):
        ins, (h, n1, k1, p, k2) = _core_inputs(cfg, args.batch, dt)
        stream = torch.cuda.current_stream().cuda_stream
        for force in forces:
            with engine.forced_chain(core=force):
                plan = engine.core_plan(lib, getattr(torch, dt), args.batch,
                                        h, h, n1, k1, p, per_mode, k2)
                for _ in range(4):  # the last launch's stamps stay
                    engine._launch_core(lib, *ins, stream)
            blocks = min(plan["cluster"] * plan["groups"] * plan["ptiles"],
                         4096)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (8 * blocks))()
            err = lib.fused_core_clocks(buf, blocks)
            if err != 0:
                raise RuntimeError(f"fused_core_clocks failed: {err}")
            t = torch.tensor(list(buf), dtype=torch.float64).reshape(blocks,
                                                                     8)
            spans = {name: float((t[:, j] - t[:, i]).median()) / 1e3
                     for name, i, j in CLOCK_SPANS}
            span = float(t[:, 6].max() - t[:, 0].min()) / 1e3
            report["clocks"].append({"dtype": dt, "force": force,
                                     "plan": plan, "median_us": spans,
                                     "span_us": span})
            print(f"fused_core {dt} {force} clocks (median µs a block): "
                  + " ".join(f"{k}={v:.2f}" for k, v in spans.items())
                  + f" span={span:.2f} blocks={blocks}")
    print(json.dumps(report))


def _sweep_core(args: argparse.Namespace, smi: str) -> None:
    """The whole core kernel at each forced plan of --core-force (';'
    separated; an empty entry is the planner's own), in turns."""
    lib = build.load_core_library(build.build("fused_core"))
    cfg = get_config(args.arch)
    per_mode = cfg.weight_mode == "per_mode"
    forces = _forces(args.core_force)
    report = {"card": smi, "batch": args.batch, "config": args.arch,
              "kernel": "fused_core", "sweep": []}
    for dt in ("float32", "bfloat16"):
        ins, (h, n1, k1, p, k2) = _core_inputs(cfg, args.batch, dt)
        stream = torch.cuda.current_stream().cuda_stream
        times = [[] for _ in forces]
        plans = {}
        for i, force in enumerate(forces):  # the plans that fit a block
            try:
                with engine.forced_chain(core=force):
                    plans[i] = engine.core_plan(lib, getattr(torch, dt),
                                                args.batch, h, h, n1, k1, p,
                                                per_mode, k2)
            except ValueError as e:
                print(f"fused_core {dt} {force}: {e}")
        order = list(plans)
        for rnd in range(args.rounds):
            for i in (order if rnd % 2 == 0 else order[::-1]):
                with engine.forced_chain(core=forces[i]):
                    times[i].append(_time(lambda: engine._launch_core(
                        lib, *ins, stream), args.iters, queued=True))
        for i, (force, t) in enumerate(zip(forces, times)):
            if not t:
                continue
            plan = plans[i]
            med = statistics.median(t)
            report["sweep"].append({"dtype": dt, "force": force,
                                    "median_ms": med,
                                    "spread_ms": max(t) - min(t),
                                    "plan": plan})
            print(f"fused_core {dt} {force}: {med:.4f} ms (spread "
                  f"{max(t) - min(t):.4f}) plan {plan}")
    print(json.dumps(report))


def _measure_core(args: argparse.Namespace, smi: str) -> None:
    """The core's phases at the arch's block, f32 and bf16, in turns, with
    the W bytes its plan reads a launch."""
    named = variants(CORE_PHASES)
    force = _forces(args.core_force)[0]
    with concurrent.futures.ThreadPoolExecutor(len(named)) as pool:
        paths = dict(zip(named, pool.map(
            lambda m: build.build("fused_core", (f"FUSED_CORE_ELIDE={m}",)),
            named.values())))
    libs = {k: build.load_core_library(p) for k, p in paths.items()}
    cfg = get_config(args.arch)
    per_mode = cfg.weight_mode == "per_mode"
    b = args.batch
    report = {"card": smi, "batch": b, "config": args.arch,
              "kernel": "fused_core", "per_mode": per_mode, "force": force}
    for dt in ("float32", "bfloat16"):
        tdt = getattr(torch, dt)
        ins, (h, n1, k1, p, k2) = _core_inputs(cfg, b, dt)
        stream = torch.cuda.current_stream().cuda_stream
        run = lambda lib: engine._launch_core(lib, *ins, stream)
        times = {name: [] for name in named}
        with engine.forced_chain(core=force):
            plan = engine.core_plan(libs["whole"], tdt, b, h, h, n1, k1, p,
                                    per_mode, k2)
            for rnd in range(args.rounds):
                order = list(times) if rnd % 2 == 0 else list(times)[::-1]
                for name in order:
                    lib = libs[name]
                    times[name].append(_time(lambda: run(lib), args.iters,
                                             queued=True))
        med = {k: statistics.median(v) for k, v in times.items()}
        split = {f"phase{i}_ms": med["whole"] - med[f"no_phase{i}"]
                 for i in CORE_PHASES}
        report[dt] = {"median_ms": med, **split, "plan": plan,
                      "spread_ms": {k: max(v) - min(v)
                                    for k, v in times.items()}}
        print(f"fused_core {dt}: whole={med['whole']:.4f} ms " + " ".join(
            f"{k}={v:.4f}" for k, v in split.items())
            + f" rest={med['no_phases']:.4f} planned w_bytes="
            f"{plan['w_bytes']}")
    print(json.dumps(report))


def _measure(args: argparse.Namespace, smi: str) -> None:
    """Times each variant of each kernel in turns at the arguments' config
    and prints the phases' split and the report."""
    kernels = ["fused_block"] if args.fuse_ends else list(KERNELS)
    phases = {k: ENDS_PHASES if args.fuse_ends else
              WGRAD_PHASES if k == "fused_wgrad" else BLOCK_PHASES
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
              "fuse_ends": args.fuse_ends, "chain": args.chain}
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
