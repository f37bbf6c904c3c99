#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and the CUDA toolkit; exits non-zero
without them and never carries on on the CPU. Phases, in order, any failure
fatal:

  1. environment — the card's name and power limit, the kernel build from
     the sources in this checkout (seconds and ptxas registers/smem/spills);
  2. kernel vs plain — the fused block kernel against its plain PyTorch
     version on the card: odd extents at ranks 1–3, reduced_1d/2d/3d, fno2d
     full width at B=1 and B=8, each in f32 (≤ 2e-4) and bf16 (≤ 2e-2
     against the f32 plain version), errors scaled to the reference's
     magnitude;
  3. serve — ``FNOServer`` for fno2d at full width (hidden 64, 4 layers,
     128×128, 32×32 modes), max_batch 8: 8 requests of seeded sizes 1–8,
     2 requests with rollout_steps=4, 2 requests under the bf16 preset;
     outputs finite, equal to the staged path within the tolerances above,
     and the kernel launched exactly num_layers × Σ(chunks × K) times;
  4. times — a sustained serve window per precision (f32, then bf16):
     hundreds of single-step requests of seeded sizes 1–8, each waited for
     as a client would, giving request latency percentiles and sample-steps/s
     over the whole window; then CUDA events at fno2d B=8 in f32 and bf16:
     the kernel, its plain version, the staged torch.fft block (the paper's
     PyTorch baseline, a yardstick only), the bound from the shapes, peak
     device memory.

The last two lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

F32_TOL = 2e-4   # DESIGN.md §4: f32 port == reference
BF16_TOL = 2e-2  # DESIGN.md §4: bf16 forward within 2e-2 of the f32 reference
PEAK_F32_FLOPS = 67e12     # H100 SXM, CUDA cores (published, 700 W)
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense tensor cores (published, 700 W)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 (published)
DEVICE = "cuda"
WINDOW_REQUESTS = 500      # requests per precision in the sustained window
REPLACES = "src/repro/kernels/engine.py:307"
SOURCE = "src/repro_torch/csrc/fused_block.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(y, ref) -> float:
    """Max |y - ref| scaled to the reference magnitude (max(|ref|, 1))."""
    y, ref = y.float(), ref.float()
    scale = max(float(ref.abs().max()), 1.0)
    return float((y - ref).abs().max()) / scale


def check(name: str, err: float, tol: float) -> None:
    status = "ok" if err <= tol else "FAIL"
    log(f"  {name}: scaled_err={err:.3e} tol={tol:.0e} {status}")
    if err > tol:
        raise AssertionError(f"{name}: error {err:.3e} > {tol:.0e}")


def block_flops(b, h, o, spatial, modes) -> float:
    """Least operations of one fused block forward: a real FFT of each input
    and each output channel (2.5·N·log2 N for N points), the CGEMM (8 per
    complex multiply-add) and the bypass (2 per multiply-add)."""
    pts, kk = math.prod(spatial), math.prod(modes)
    fft = 2.5 * pts * math.log2(pts)
    return b * ((h + o) * fft + 8 * o * h * kk + 2 * o * h * pts)


def dense_dft_flops(b, h, o, spatial, modes) -> int:
    """Operations of one fused block forward as the kernel computes it:
    dense truncated-DFT stages, CGEMM, padded inverse stages, bypass."""
    r = len(spatial)
    macs = 0
    cur = list(spatial)  # forward: axis s_R first, real input then complex
    for i, ax in enumerate(range(r - 1, -1, -1)):
        rest = math.prod(n for j, n in enumerate(cur) if j != ax)
        macs += h * rest * spatial[ax] * modes[ax] * (2 if i == 0 else 4)
        cur[ax] = modes[ax]
    macs += o * h * math.prod(modes) * 4  # CGEMM
    cur = list(modes)  # inverse: axis s_1 first, real output last
    for ax in range(r):
        rest = math.prod(n for j, n in enumerate(cur) if j != ax)
        macs += o * rest * modes[ax] * spatial[ax] * (2 if ax == r - 1 else 4)
        cur[ax] = spatial[ax]
    macs += o * h * math.prod(spatial)  # bypass
    return 2 * b * macs


def bound_ms(b, h, o, spatial, modes, elem_bytes, peak_flops):
    """Least time for the block on the card: each input read once and y
    written once over the memory rate, against the least operations
    (``block_flops``) over the peak rate for the element type. Returns
    (ms, "bytes"|"operations")."""
    pts = math.prod(spatial)
    kk = sum(2 * 2 * n * k for n, k in zip(spatial, modes))  # 4R operands
    nbytes = elem_bytes * (b * h * pts + b * o * pts + 3 * o * h + o + kk)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = block_flops(b, h, o, spatial, modes) / peak_flops
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
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


def block_inputs(b, h, o, spatial, seed, device):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.tensor(sc * rng.normal(size=s),
                                         dtype=torch.float32, device=device)
    return (mk(b, h, *spatial), mk(o, h, sc=1.0 / h), mk(o, h, sc=1.0 / h),
            mk(o, h, sc=1.0 / h), mk(o, 1, sc=0.3))


def phase_environment(torch, build):
    log("== phase 1: environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(build.SOURCES)) as pool:
        list(pool.map(build.build, build.SOURCES))  # one nvcc per source
    log(f"  build: {time.perf_counter() - t0:.2f} s for {build.SOURCES}")
    for name in build.SOURCES:
        info = build.BUILD_INFO[name]
        log(f"  {name}: nvcc {info['seconds']:.2f} s "
            f"(cached={info['cached']})")
        for line in info["ptxas"]:
            log(f"    {line}")
    return card


def phase_kernel_vs_plain(torch, engine, spectral, configs):
    log("== phase 2: kernel vs plain on the card")
    shapes = [("odd_r1", 2, 8, 6, (64,), (17,)),
              ("odd_r2", 2, 8, 6, (16, 32), (5, 9)),
              ("odd_r3", 2, 8, 6, (8, 8, 16), (3, 3, 5))]
    for arch in ("fno1d", "fno2d", "fno3d"):
        c = configs.get_config(arch, reduced=True)
        shapes.append((f"reduced_{c.ndim}d", 2, c.hidden, c.hidden,
                       c.spatial, c.modes))
    full = configs.get_config("fno2d")
    for b in (1, 8):
        shapes.append((f"fno2d_B{b}", b, full.hidden, full.hidden,
                       full.spatial, full.modes))
    errs = {}
    for seed, (name, b, h, o, spatial, modes) in enumerate(shapes):
        args32 = block_inputs(b, h, o, spatial, seed, DEVICE)
        mats32 = spectral.operand_tensors(spatial, modes, "float32", DEVICE)
        ref = engine.fused_block_plain(*args32, mats32)
        y = engine.fused_block(*args32, mats32)
        torch.cuda.synchronize()
        check(f"{name} f32 kernel vs plain", rel_err(y, ref), F32_TOL)
        errs[(name, "float32")] = float((y - ref).abs().max())
        args16 = [a.to(torch.bfloat16) for a in args32]
        mats16 = spectral.operand_tensors(spatial, modes, "bfloat16", DEVICE)
        y16 = engine.fused_block(*args16, mats16)
        ref16 = engine.fused_block_plain(*args16, mats16)
        torch.cuda.synchronize()
        log(f"  {name} bf16 kernel vs bf16 plain: scaled_err="
            f"{rel_err(y16, ref16):.3e}")
        check(f"{name} bf16 kernel vs f32 plain", rel_err(y16, ref),
              BF16_TOL)
        errs[(name, "bfloat16")] = float((y16.float() - ref).abs().max())
    return errs


def phase_serve(torch, np, configs, fno_mod, sfs, engine):
    log("== phase 3: serve fno2d at full width")
    cfg = configs.with_fuse_block(configs.get_config("fno2d"))
    cfg_fused = dataclasses.replace(cfg, path="fused")
    cfg_staged = dataclasses.replace(cfg, path="staged", fuse_block=False)
    cfg_bf16 = configs.with_precision(cfg_fused, "bf16")
    log(f"  config: hidden={cfg.hidden} layers={cfg.num_layers} "
        f"spatial={cfg.spatial} modes={cfg.modes} in={cfg.in_channels} "
        f"out={cfg.out_channels}")
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg)
    servers = {name: sfs.FNOServer(c, params, device=DEVICE, max_batch=8)
               for name, c in (("fused", cfg_fused), ("staged", cfg_staged),
                               ("bf16", cfg_bf16))}
    shape = (cfg.in_channels,) + tuple(cfg.spatial)
    for srv in servers.values():  # warm every bucket outside the count
        for b in srv.buckets:
            srv(torch.zeros((b,) + shape, device=DEVICE))
        srv(torch.zeros((1,) + shape, device=DEVICE), rollout_steps=4)
    torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(1)
    mkreq = lambda n: torch.randn((int(n),) + shape, generator=gen).to(DEVICE)
    plan = ([(mkreq(n), 1, "fused") for n in rng.integers(1, 9, size=8)]
            + [(mkreq(n), 4, "fused") for n in rng.integers(1, 9, size=2)]
            + [(mkreq(n), 1, "bf16") for n in rng.integers(1, 9, size=2)])
    top = servers["fused"].buckets[-1]
    expect = {"float32": 0, "bfloat16": 0}
    for x, k, name in plan:
        chunks = -(-x.shape[0] // top)
        expect["float32" if name == "fused" else "bfloat16"] += (
            cfg.num_layers * chunks * k)
    torch.cuda.synchronize()

    engine.LAUNCHES.clear()
    outs = [servers[name](x, rollout_steps=k) for x, k, name in plan]
    torch.cuda.synchronize()
    counts = dict(engine.LAUNCHES)
    log(f"  launches {counts} expected {expect}")
    for dt, n in expect.items():
        if counts.get(dt, 0) != n:
            raise AssertionError(f"kernel launches {counts} != {expect}")

    for (x, k, name), y in zip(plan, outs):
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"non-finite serve output ({name}, K={k})")
        y_ref = servers["staged"](x, rollout_steps=k)
        tol = F32_TOL if name == "fused" else BF16_TOL
        check(f"serve {name} n={x.shape[0]} K={k} vs staged f32",
              rel_err(y, y_ref), tol)
    return counts, servers


def phase_serve_window(torch, np, servers, engine, num_layers):
    """Sustained serving, one precision at a time: WINDOW_REQUESTS
    single-step requests of seeded sizes 1–8 back to back, each waited for
    (one request in flight, as a client that needs its answer). Latency is
    the host clock from call to answer; throughput is every sample-step over
    the whole window's wall time."""
    log("== phase 4: times — sustained serve window, fno2d full width")
    srv0 = servers["fused"]
    shape = (srv0.cfg.in_channels,) + tuple(srv0.cfg.spatial)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    pool = torch.randn((64,) + shape, generator=gen, device=DEVICE)
    stats = {}
    for name in ("fused", "bf16"):
        srv = servers[name]
        rng = np.random.default_rng(3)
        sizes = rng.integers(1, 9, size=WINDOW_REQUESTS)
        offs = rng.integers(0, 64 - 8, size=WINDOW_REQUESTS)
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        outs, lat = [], []
        t_all = time.perf_counter()
        for n, off in zip(sizes, offs):
            t0 = time.perf_counter()
            outs.append(srv(pool[off:off + n]))
            torch.cuda.synchronize()
            lat.append(1e3 * (time.perf_counter() - t0))
        wall = time.perf_counter() - t_all
        launches = sum(engine.LAUNCHES.values())
        if launches != num_layers * WINDOW_REQUESTS:
            raise AssertionError(f"window launches {launches} != "
                                 f"{num_layers * WINDOW_REQUESTS}")
        if not all(bool(torch.isfinite(y).all()) for y in outs):
            raise AssertionError(f"non-finite output in the {name} window")
        lat = np.asarray(lat)
        buckets = np.asarray([srv.buckets[np.searchsorted(srv.buckets, n)]
                              for n in sizes])
        dt = srv.cfg.precision.compute_dtype
        st = {"requests": WINDOW_REQUESTS, "sample_steps": int(sizes.sum()),
              "wall_s": wall, "sample_steps_per_s": float(sizes.sum()) / wall,
              "latency_ms": {q: float(np.percentile(lat, p)) for q, p in
                             (("p50", 50), ("p99", 99))},
              "latency_ms_mean": float(lat.mean()),
              "latency_ms_max": float(lat.max()),
              "latency_ms_p50_by_bucket": {
                  int(b): float(np.percentile(lat[buckets == b], 50))
                  for b in srv.buckets if (buckets == b).any()},
              "launches": launches}
        stats[dt] = st
        log(f"  {dt}: {st['requests']} requests, {st['sample_steps']} "
            f"sample-steps in {wall:.3f} s: "
            f"{st['sample_steps_per_s']:.2f} sample-steps/s; latency ms "
            f"p50 {st['latency_ms']['p50']:.3f} p99 "
            f"{st['latency_ms']['p99']:.3f} mean {st['latency_ms_mean']:.3f}"
            f"; p50 by bucket {st['latency_ms_p50_by_bucket']}")
    return stats


def phase_times(torch, build, engine, spectral, ops, configs, counts, errs):
    log("== phase 4: times — the block at fno2d B=8")
    full = configs.get_config("fno2d")
    b, h, o = 8, full.hidden, full.hidden
    spatial, modes = full.spatial, full.modes
    args32 = block_inputs(b, h, o, spatial, 100, DEVICE)
    rows = []
    for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                         ("bfloat16", PEAK_BF16_FLOPS, 2)):
        tdt = getattr(torch, dt)
        args = [a.to(tdt) for a in args32]
        mats = spectral.operand_tensors(spatial, modes, dt, DEVICE)
        bias1 = args[4].reshape(-1)
        kernel_ms = time_ms(lambda: engine.fused_block(*args, mats), 20)
        one = [a[:1] if i == 0 else a for i, a in enumerate(args)]
        kernel_b1_ms = time_ms(lambda: engine.fused_block(*one, mats), 20)
        plans = {bb: engine.pick_plan(build.load_fused_block(),
                                      0 if dt == "float32" else 1, bb, h, o,
                                      spatial, modes)["cluster"]
                 for bb in (1, 2, 4, 8)}
        plain_ms = time_ms(lambda: engine.fused_block_plain(*args, mats), 10)
        fft_ms = time_ms(lambda: ops.fno_block_nd(
            args[0], args[1], args[2], args[3], bias1, modes, path="ref"), 10)
        bms, by = bound_ms(b, h, o, spatial, modes, eb, peak)
        log(f"  {dt}: clusters by bucket {plans}; kernel_ms at B=1 "
            f"{kernel_b1_ms:.4f}")
        log(f"  {dt}: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"torch_fft_ms={fft_ms:.4f} bound_us={1e3 * bms:.2f} ({by}) "
            f"flops_needed={block_flops(b, h, o, spatial, modes):.0f} "
            f"flops_kernel={dense_dft_flops(b, h, o, spatial, modes)}")
        rows.append({
            "name": f"fused_block_{'f32' if dt == 'float32' else 'bf16'}",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": counts.get(dt, 0),
            "max_abs_err": errs[("fno2d_B8", dt)],
            "tol": F32_TOL if dt == "float32" else BF16_TOL,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "torch_fft_ms": fft_ms,
            "ms_b1": kernel_b1_ms})
    log(f"  max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    return rows


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch import configs
    from repro_torch.core import fno as fno_mod
    from repro_torch.core import spectral
    from repro_torch.kernels import build, engine, ops
    from repro_torch.train import serve_fno_step as sfs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_environment(torch, build)
    errs = phase_kernel_vs_plain(torch, engine, spectral, configs)
    counts, servers = phase_serve(torch, np, configs, fno_mod, sfs, engine)
    stats = phase_serve_window(torch, np, servers, engine,
                               servers["fused"].cfg.num_layers)
    rows = phase_times(torch, build, engine, spectral, ops, configs, counts,
                       errs)
    log(f"serve window: {json.dumps(stats)}")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
