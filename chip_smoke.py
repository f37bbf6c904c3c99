#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and the CUDA toolkit; exits non-zero
without them and never carries on on the CPU. Phases, in order, any failure
fatal:

  1. environment — the card's name and power limit, the kernels' build from
     the sources in this checkout, one nvcc per source in parallel (seconds
     and ptxas registers/smem/spills);
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
     device memory;
  5. kernel vs plain, backward — the gz-recompute, dx-adjoint and wgrad
     launches against their plain versions on the card at phase 2's shapes:
     f32 ≤ 2e-4 on the same inputs, bf16 ≤ 2e-2 of the f32 plain chain;
  6. train — fno2d at full width, batch 8 of Darcy data from seed 0: the
     fused path's step-0 loss, grad norm and every leaf's grad against the
     staged path (f32 ≤ 2e-4 of each leaf's magnitude; bf16 ≤ 5e-2 of the
     f32 staged grads), exactly num_layers launches of each of block_fwd,
     gz_recompute, dx_adjoint and wgrad per training step, and 20 AdamW
     steps on that one batch whose last loss is below the first;
  7. train times — per precision, median step ms and samples/s over 30
     steps after the 20 above, peak device memory; then CUDA events at
     fno2d B=8 for each backward launch beside its plain version, the
     staged torch.fft block's autograd backward (a yardstick) and its bound;
  8. kernel vs plain, partial launches — the row kernels (rdft, cdft with
     the forward and the padded-inverse operand, irdft) and the fused core
     against their plain versions at phase 2's odd extents (ranks 2–3),
     fno2d full width at B=1 and B=8 and fno3d full width (hidden 32, 64³,
     modes 16³) at B=1, f32 ≤ 2e-4 and bf16 ≤ 2e-2 of the f32 plain
     version; and the block kernel without wb (the bare spectral layer);
  9. serve partial — ``FNOServer(variant="partial")`` for fno2d at full
     width with phase 3's 12 requests: finite, equal to the staged path and
     to the full variant within the tolerances, exactly num_layers ×
     Σ(chunks × K) launches of each of rdft, core and irdft and no
     block_fwd; then fno3d at full width serves batches of 1 and 2 through
     the partial path (f32 and bf16) against the staged path;
  10. train partial — phase 6 with ``fno_variant="partial"``: num_layers
     launches of each of rdft, core, irdft, gz_recompute, dx_adjoint and
     wgrad per step;
  11. times, partial — phase 4's serve window (the same seeded sizes) and
     phase 7's training window on the partial variant; CUDA events at fno2d
     B=8 for each partial launch beside its plain version, its one-call
     ``torch.fft`` yardstick (none for the core) and its bound, fno3d's
     outer launches at B=1, and the whole served block forward, partial
     against full against the staged torch.fft block.

Each phase's seconds are printed. The last two lines are a
``{"kernels": [...]}`` JSON object and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
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
BF16_GRAD_TOL = 5e-2  # DESIGN.md §4: bf16 grads within 5e-2 of f32
PEAK_F32_FLOPS = 67e12     # H100 SXM, CUDA cores (published, 700 W)
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense tensor cores (published, 700 W)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 (published)
DEVICE = "cuda"
WINDOW_REQUESTS = 500      # requests per precision in the sustained window
TRAIN_STEPS = 20           # AdamW steps on one batch: the loss must fall
TRAIN_WINDOW = 30          # timed training steps per precision after those
BLOCK_REPLACES = "src/repro/kernels/engine.py:307"
WGRAD_REPLACES = "src/repro/kernels/engine.py:634"
BLOCK_SOURCE = "src/repro_torch/csrc/fused_block.cu"
WGRAD_SOURCE = "src/repro_torch/csrc/fused_wgrad.cu"
BACKWARD = ("gz_recompute", "dx_adjoint", "wgrad")
PARTIAL_LAUNCHES = ("rdft", "cdft", "icdft", "irdft", "core")
DTYPES = ("float32", "bfloat16")
ROWS_SOURCE = "src/repro_torch/csrc/dft_rows.cu"
CORE_SOURCE = "src/repro_torch/csrc/fused_core.cu"
PARTIAL_REPLACES = {"rdft": "src/repro/kernels/dft.py:44",
                    "cdft": "src/repro/kernels/dft.py:75",
                    "irdft": "src/repro/kernels/dft.py:97",
                    "core": "src/repro/kernels/engine.py:494"}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(y, ref) -> float:
    """Max |y - ref| scaled to the reference magnitude (max(|ref|, 1))."""
    y, ref = y.float(), ref.float()
    scale = max(float(ref.abs().max()), 1.0)
    return float((y - ref).abs().max()) / scale


def errors(ours, refs) -> tuple:
    """(max |y - ref|, max rel_err(y, ref)) over the pairs: the row's
    max_abs_err and its scaled_err, the one held against the tolerance."""
    pairs = list(zip(ours, refs))
    return (max(float((y.float() - r.float()).abs().max()) for y, r in pairs),
            max(rel_err(y, r) for y, r in pairs))


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


def wgrad_flops(b, h, o, spatial, modes) -> float:
    """Least operations of the weight gradients: a real FFT of each x and
    each gz channel, the spectral reduction (8 per complex multiply-add),
    the dW_b reduction (2 per multiply-add) and dbias (1 per add)."""
    return block_flops(b, h, o, spatial, modes) + b * o * math.prod(spatial)


def bound_ms(kind, b, h, o, spatial, modes, elem_bytes, peak_flops):
    """Least time for one launch of `kind` on the card: each input read once
    and each output written once over the memory rate, against the least
    operations over the peak rate for the element type. Returns
    (ms, "bytes"|"operations").

    block_fwd reads x, the weights and the operands and writes y;
    gz_recompute reads gy too and writes gz; dx_adjoint reads gz and writes
    dx (the same work with H and O swapped); wgrad reads x and gz and writes
    the f32 weight gradients; the partial variant's launches as
    ``partial_work`` counts them."""
    pts = math.prod(spatial)
    mats = sum(2 * 2 * n * k for n, k in zip(spatial, modes))  # 4R operands
    act_in, act_out = b * h * pts, b * o * pts
    weights = 3 * o * h + o
    flops = block_flops(b, h, o, spatial, modes)
    if kind == "block_fwd":
        nbytes = elem_bytes * (act_in + act_out + weights + mats)
    elif kind == "gz_recompute":
        nbytes = elem_bytes * (act_in + 2 * act_out + weights + mats)
    elif kind == "dx_adjoint":
        nbytes = elem_bytes * (act_out + act_in + 3 * o * h + mats)
    elif kind in PARTIAL_LAUNCHES:
        flops, elems = partial_work(kind, b, h, o, spatial, modes)
        nbytes = elem_bytes * elems
    else:
        nbytes = elem_bytes * (act_in + act_out + mats) + 4 * weights
        flops = wgrad_flops(b, h, o, spatial, modes)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / peak_flops
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def fft_flops(n: int, real: bool) -> float:
    """Least operations of one FFT of n points: 2.5·n·log2 n for real
    input or output, 5·n·log2 n complex (the convention of
    ``block_flops``)."""
    return (2.5 if real else 5.0) * n * math.log2(n) if n > 1 else 0.0


def partial_work(kind, b, h, o, spatial, modes):
    """(least operations, elements moved) of one partial-variant launch at
    a block of B=b, H=h, O=o: each row read once and each output written
    once (operands too), against FFTs of the transformed axes.

    rdft: the b·h·s_1 rows over the outer axes s_2..s_R (one real FFT of
    all outer points each); irdft: the b·o·s_1 rows back; cdft / icdft:
    the s_1 stage as a row launch over b·h·P (b·o·P) rows of s_1 points
    (complex FFTs; P = Πk_2..k_R); core: z and y pairs, W, both s_1
    operands, an s_1 FFT of every (b, channel, p) column each way and the
    CGEMM (8 per complex multiply-add)."""
    n1, k1 = spatial[0], modes[0]
    n_out, p = math.prod(spatial[1:]), math.prod(modes[1:])
    if kind == "rdft":
        rows = b * h * n1
        return (rows * fft_flops(n_out, True),
                rows * (n_out + 2 * p) + 2 * n_out * p)
    if kind == "irdft":
        rows = b * o * n1
        return (rows * fft_flops(n_out, True),
                rows * (2 * p + n_out) + 2 * n_out * p)
    if kind in ("cdft", "icdft"):
        rows = b * (h if kind == "cdft" else o) * p
        return rows * fft_flops(n1, False), rows * 2 * (n1 + k1) + 2 * n1 * k1
    return (b * p * ((h + o) * fft_flops(n1, False) + 8 * o * h * k1),
            2 * b * p * n1 * (h + o) + 2 * o * h + 4 * n1 * k1)


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


def check_shapes(configs):
    """Phase 2's and phase 5's shapes: odd extents at ranks 1–3,
    reduced_1d/2d/3d, fno2d full width at B=1 and B=8."""
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
    return shapes


def phase_kernel_vs_plain(torch, engine, spectral, configs):
    log("== phase 2: kernel vs plain on the card")
    errs = {}
    for seed, (name, b, h, o, spatial, modes) in enumerate(
            check_shapes(configs)):
        args32 = block_inputs(b, h, o, spatial, seed, DEVICE)
        mats32 = spectral.operand_tensors(spatial, modes, "float32", DEVICE)
        ref = engine.fused_block_plain(*args32, mats32)
        y = engine.fused_block(*args32, mats32)
        torch.cuda.synchronize()
        errs[(name, "float32")] = e = errors([y], [ref])
        check(f"{name} f32 kernel vs plain", e[1], F32_TOL)
        args16 = [a.to(torch.bfloat16) for a in args32]
        mats16 = spectral.operand_tensors(spatial, modes, "bfloat16", DEVICE)
        y16 = engine.fused_block(*args16, mats16)
        ref16 = engine.fused_block_plain(*args16, mats16)
        torch.cuda.synchronize()
        log(f"  {name} bf16 kernel vs bf16 plain: scaled_err="
            f"{rel_err(y16, ref16):.3e}")
        errs[(name, "bfloat16")] = e = errors([y16], [ref])
        check(f"{name} bf16 kernel vs f32 plain", e[1], BF16_TOL)
    return errs


def serve_requests(torch, np, shape):
    """Phase 3's 12 mixed requests, the same in every phase that sends
    them: 8 single-step requests of seeded sizes 1–8, 2 with
    rollout_steps=4, 2 under the bf16 preset, as (x, K, bf16)."""
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(1)
    mkreq = lambda n: torch.randn((int(n),) + shape, generator=gen).to(DEVICE)
    return ([(mkreq(n), 1, False) for n in rng.integers(1, 9, size=8)]
            + [(mkreq(n), 4, False) for n in rng.integers(1, 9, size=2)]
            + [(mkreq(n), 1, True) for n in rng.integers(1, 9, size=2)])


def expected_launches(plan, kinds, num_layers, top):
    """num_layers × Σ(chunks × K) launches of each kind per precision for
    requests (x, K, name); names ending in "bf16" run in bf16."""
    expect = {}
    for x, k, name in plan:
        dt = "bfloat16" if name.endswith("bf16") else "float32"
        chunks = -(-x.shape[0] // top)
        for kind in kinds:
            expect[(kind, dt)] = (expect.get((kind, dt), 0)
                                  + num_layers * chunks * k)
    return expect


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

    plan = [(x, k, "bf16" if bf16 else "fused")
            for x, k, bf16 in serve_requests(torch, np, shape)]
    expect = expected_launches(plan, ("block_fwd",), cfg.num_layers,
                               servers["fused"].buckets[-1])
    torch.cuda.synchronize()

    engine.LAUNCHES.clear()
    outs = [servers[name](x, rollout_steps=k) for x, k, name in plan]
    torch.cuda.synchronize()
    counts = dict(engine.LAUNCHES)
    log(f"  launches {counts} expected {expect}")
    if counts != expect:
        raise AssertionError(f"kernel launches {counts} != {expect}")

    for (x, k, name), y in zip(plan, outs):
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"non-finite serve output ({name}, K={k})")
        y_ref = servers["staged"](x, rollout_steps=k)
        tol = F32_TOL if name == "fused" else BF16_TOL
        check(f"serve {name} n={x.shape[0]} K={k} vs staged f32",
              rel_err(y, y_ref), tol)
    return counts, servers


def phase_serve_window(torch, np, servers, engine, num_layers,
                       names=("fused", "bf16"), kinds=("block_fwd",),
                       phase="4"):
    """Sustained serving, one precision at a time: WINDOW_REQUESTS
    single-step requests of seeded sizes 1–8 back to back, each waited for
    (one request in flight, as a client that needs its answer). Latency is
    the host clock from call to answer; throughput is every sample-step over
    the whole window's wall time. `names` are the f32 and bf16 servers,
    `kinds` the launch kinds each layer issues; the sizes are the same
    for every variant."""
    log(f"== phase {phase}: times — sustained serve window, fno2d full "
        f"width, {names}")
    srv0 = servers[names[0]]
    shape = (srv0.cfg.in_channels,) + tuple(srv0.cfg.spatial)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    pool = torch.randn((64,) + shape, generator=gen, device=DEVICE)
    stats = {}
    for name in names:
        srv = servers[name]
        rng = np.random.default_rng(3)
        sizes = rng.integers(1, 9, size=WINDOW_REQUESTS)
        offs = rng.integers(0, 64 - 8, size=WINDOW_REQUESTS)
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        outs, lat = [], []
        collections = [0, 0, 0]  # garbage collections during the window
        count_gc = lambda phase, info: collections.__setitem__(
            info["generation"], collections[info["generation"]]
            + (phase == "stop"))
        gc.callbacks.append(count_gc)
        t_all = time.perf_counter()
        try:
            for n, off in zip(sizes, offs):
                t0 = time.perf_counter()
                outs.append(srv(pool[off:off + n]))
                torch.cuda.synchronize()
                lat.append(1e3 * (time.perf_counter() - t0))
        finally:
            gc.callbacks.remove(count_gc)
        wall = time.perf_counter() - t_all
        dt = srv.cfg.precision.compute_dtype
        launches = engine.LAUNCHES[(kinds[0], dt)]
        want = {(k, dt): num_layers * WINDOW_REQUESTS for k in kinds}
        if dict(engine.LAUNCHES) != want:
            raise AssertionError(f"window launches {dict(engine.LAUNCHES)} "
                                 f"!= {want}")
        if not all(bool(torch.isfinite(y).all()) for y in outs):
            raise AssertionError(f"non-finite output in the {name} window")
        lat = np.asarray(lat)
        buckets = np.asarray([srv.buckets[np.searchsorted(srv.buckets, n)]
                              for n in sizes])
        st = {"requests": WINDOW_REQUESTS, "sample_steps": int(sizes.sum()),
              "wall_s": wall, "sample_steps_per_s": float(sizes.sum()) / wall,
              "latency_ms": {q: float(np.percentile(lat, p)) for q, p in
                             (("p50", 50), ("p99", 99))},
              "latency_ms_mean": float(lat.mean()),
              "latency_ms_max": float(lat.max()),
              "latency_ms_p50_by_bucket": {
                  int(b): float(np.percentile(lat[buckets == b], 50))
                  for b in srv.buckets if (buckets == b).any()},
              # the five slowest requests: (position, ms, bucket)
              "slowest": [(int(i), float(lat[i]), int(buckets[i]))
                          for i in np.argsort(lat)[::-1][:5]],
              "gc_collections": collections,
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
        bms, by = bound_ms("block_fwd", b, h, o, spatial, modes, eb, peak)
        log(f"  {dt}: clusters by bucket {plans}; kernel_ms at B=1 "
            f"{kernel_b1_ms:.4f}")
        log(f"  {dt}: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"torch_fft_ms={fft_ms:.4f} bound_us={1e3 * bms:.2f} ({by}) "
            f"flops_needed={block_flops(b, h, o, spatial, modes):.0f} "
            f"flops_kernel={dense_dft_flops(b, h, o, spatial, modes)}")
        rows.append({
            "name": f"fused_block_{'f32' if dt == 'float32' else 'bf16'}",
            "route": "cuda", "source": BLOCK_SOURCE,
            "replaces": BLOCK_REPLACES,
            "launches": counts.get(("block_fwd", dt), 0),
            "max_abs_err": errs[("fno2d_B8", dt)][0],
            "scaled_err": errs[("fno2d_B8", dt)][1],
            "tol": F32_TOL if dt == "float32" else BF16_TOL,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "torch_fft_ms": fft_ms,
            "ms_b1": kernel_b1_ms})
    log(f"  max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    return rows


def backward_mats(spectral, spatial, modes, dtype):
    return {k: spectral.operand_tensors(spatial, modes, dtype, DEVICE, k)
            for k in ("forward", "adjoint", "wgrad")}


def run_backward(engine, args, gy, mats, *, plain=False, gz=None):
    """The backward's three launches (or their plain versions): gz from gy,
    dx from gz through the adjoint bundle with transposed weights, and the
    weight gradients from x and gz. A given `gz` feeds dx and wgrad in
    place of the one computed here."""
    x, wr, wi, wb, bias = args
    block = engine.fused_block_plain if plain else engine.fused_block
    wgrad = engine.fused_wgrad_plain if plain else engine.fused_wgrad
    gz0 = block(x, wr, wi, wb, bias, mats["forward"], act="gelu_vjp", gy=gy)
    gz = gz0 if gz is None else gz
    t = lambda w: w.t().contiguous()
    dx = block(gz, t(wr), t(wi), t(wb), None, mats["adjoint"], act="linear")
    return gz0, dx, wgrad(x, gz, mats["wgrad"])


def phase_backward_vs_plain(torch, engine, spectral, configs):
    log("== phase 5: kernel vs plain on the card, backward launches")
    errs = {}
    for seed, (name, b, h, o, spatial, modes) in enumerate(
            check_shapes(configs)):
        args32 = block_inputs(b, h, o, spatial, 200 + seed, DEVICE)
        gy32 = torch.randn((b, o) + tuple(spatial),
                           generator=torch.Generator().manual_seed(seed)
                           ).to(DEVICE)
        m32 = backward_mats(spectral, spatial, modes, "float32")
        # f32: each launch against its plain version on the same inputs.
        gz, dx, dw = run_backward(engine, args32, gy32, m32)
        pgz, pdx, pdw = run_backward(engine, args32, gy32, m32, plain=True,
                                     gz=gz)
        torch.cuda.synchronize()
        for kind, a, ref in (("gz_recompute", [gz], [pgz]),
                             ("dx_adjoint", [dx], [pdx]),
                             ("wgrad", dw, pdw)):
            errs[(name, kind, "float32")] = e = errors(a, ref)
            check(f"{name} f32 {kind} vs plain", e[1], F32_TOL)
        # bf16: the kernels' chain against the f32 plain chain.
        rgz, rdx, rdw = run_backward(engine, args32, gy32, m32, plain=True)
        args16 = [a.to(torch.bfloat16) for a in args32]
        m16 = backward_mats(spectral, spatial, modes, "bfloat16")
        gz16, dx16, dw16 = run_backward(engine, args16,
                                        gy32.to(torch.bfloat16), m16)
        torch.cuda.synchronize()
        for kind, a, ref in (("gz_recompute", [gz16], [rgz]),
                             ("dx_adjoint", [dx16], [rdx]),
                             ("wgrad", dw16, rdw)):
            errs[(name, kind, "bfloat16")] = e = errors(a, ref)
            check(f"{name} bf16 {kind} vs f32 plain", e[1], BF16_TOL)
    return errs


def leaf_err(a, ref) -> float:
    """Max |a - ref| over max |ref|: relative to the leaf's own magnitude."""
    a, ref = a.float(), ref.float()
    return float((a - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def phase_train(torch, configs, fno_mod, pde, tree, ts, optim, engine,
                variant="full", phase="6"):
    """Step-0 parity of the fused path (full or partial variant) with the
    staged one, the launch structure, and TRAIN_STEPS AdamW steps on one
    batch per precision."""
    log(f"== phase {phase}: train fno2d at full width, variant {variant}")
    kinds = (engine.KINDS if variant == "full"
             else engine.PARTIAL_KINDS + engine.KINDS[1:])
    cfg = configs.with_fuse_block(configs.get_config("fno2d"))
    staged = dataclasses.replace(cfg, path="staged", fuse_block=False)
    layers = cfg.num_layers
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg, DEVICE)
    batch = pde.darcy_batch(0, 0, 8, cfg.spatial[0], device=DEVICE)
    for k, v in batch.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite Darcy batch {k}")
    log(f"  batch x {tuple(batch['x'].shape)} y {tuple(batch['y'].shape)}; "
        f"params {cfg.param_count()}")
    loss_ref, g_ref = ts.value_and_grad(
        ts.make_loss_fn(staged, fno_path="staged"), params, batch)
    gn_ref = float(optim.global_norm(g_ref))
    log(f"  staged f32: loss {float(loss_ref):.6f} grad_norm {gn_ref:.6f}")
    total = TRAIN_STEPS + TRAIN_WINDOW
    runs, counts = {}, {}
    for preset, tol in (("f32", F32_TOL), ("bf16", BF16_GRAD_TOL)):
        c = dataclasses.replace(configs.with_precision(cfg, preset),
                                path="fused")
        dt = c.precision.compute_dtype
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        loss, g = ts.value_and_grad(
            ts.make_loss_fn(c, fno_path="fused", fno_variant=variant),
            params, batch)
        torch.cuda.synchronize()
        one = dict(engine.LAUNCHES)
        want = {(k, dt): layers for k in kinds}
        log(f"  {preset}: launches for one forward+backward {one}")
        if one != want:
            raise AssertionError(f"launches {one} != {want}")
        gn = float(optim.global_norm(g))
        log(f"  {preset}: loss {float(loss):.6f} grad_norm {gn:.6f}")
        check(f"{preset} step-0 loss vs staged f32",
              abs(float(loss) - float(loss_ref)) / abs(float(loss_ref)), tol)
        check(f"{preset} step-0 grad norm vs staged f32",
              abs(gn - gn_ref) / gn_ref, tol)
        paths = [".".join(str(k) for k in p) for p in tree.paths(g)]
        errs = [leaf_err(a, b) for a, b in zip(tree.leaves(g),
                                              tree.leaves(g_ref))]
        worst = max(range(len(errs)), key=errs.__getitem__)
        log(f"  {preset}: grads of {len(errs)} leaves vs staged f32, worst "
            f"{paths[worst]}")
        for p, e in zip(paths, errs):
            check(f"{preset} grad {p}", e, tol)
        for a in tree.leaves(g):
            if a.dtype != torch.float32:
                raise AssertionError(f"grad dtype {a.dtype} != float32")

        opt = optim.AdamW(lr=optim.cosine_warmup(
            1e-3, min(100, total // 10 + 1), total))
        step = ts.make_train_step(c, opt, fno_path="fused",
                                  fno_variant=variant)
        p, st = params, opt.init(params)
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        losses = []
        for _ in range(TRAIN_STEPS):
            p, st, m = step(p, st, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        counts[dt] = dict(engine.LAUNCHES)
        want = {(k, dt): layers * TRAIN_STEPS for k in kinds}
        if counts[dt] != want:
            raise AssertionError(f"launches {counts[dt]} != {want}")
        losses = [float(v) for v in losses]
        log(f"  {preset}: {TRAIN_STEPS} steps on one batch, loss "
            f"{losses[0]:.6f} -> {losses[-1]:.6f}; launches {counts[dt]}")
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"{preset}: loss did not fall: {losses}")
        runs[dt] = (step, p, st)
    return batch, runs, counts


def train_window(torch, np, batch, runs):
    """Median step ms, samples/s and peak memory over TRAIN_WINDOW steps
    per precision, continuing each run of `runs`."""
    stats = {}
    for dt, (step, p, st) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        t_all = time.perf_counter()
        for _ in range(TRAIN_WINDOW):
            t0 = time.perf_counter()
            p, st, m = step(p, st, batch)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        wall = time.perf_counter() - t_all
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"{dt}: non-finite loss in the window")
        b = batch["x"].shape[0]
        stats[dt] = {"steps": TRAIN_WINDOW, "batch": b,
                     "step_ms_median": float(np.median(ms)),
                     "step_ms_p90": float(np.percentile(ms, 90)),
                     "samples_per_s": b * TRAIN_WINDOW / wall,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "final_loss": float(m["loss"])}
        log(f"  {dt}: step ms median {stats[dt]['step_ms_median']:.4f} p90 "
            f"{stats[dt]['step_ms_p90']:.4f}; "
            f"{stats[dt]['samples_per_s']:.2f} samples/s; peak memory "
            f"{stats[dt]['peak_memory_bytes']} B")
    return stats


def phase_train_times(torch, np, engine, spectral, ops, configs, batch,
                      runs, counts, errs):
    log("== phase 7: train times, fno2d full width, batch 8")
    stats = train_window(torch, np, batch, runs)
    full = configs.get_config("fno2d")
    b, h, o = 8, full.hidden, full.hidden
    spatial, modes = full.spatial, full.modes
    args32 = block_inputs(b, h, o, spatial, 300, DEVICE)
    gy32 = torch.randn((b, o) + tuple(spatial),
                       generator=torch.Generator().manual_seed(301)).to(DEVICE)
    rows = []
    for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                         ("bfloat16", PEAK_BF16_FLOPS, 2)):
        tdt = getattr(torch, dt)
        args = [a.to(tdt) for a in args32]
        x, wr, wi, wb, bias = args
        gy = gy32.to(tdt)
        mats = backward_mats(spectral, spatial, modes, dt)
        t = lambda w: w.t().contiguous()
        wrt, wit, wbt = t(wr), t(wi), t(wb)
        gz = engine.fused_block(*args, mats["forward"], act="gelu_vjp", gy=gy)
        launch = {
            "gz_recompute": lambda plain: (
                engine.fused_block_plain if plain else engine.fused_block)(
                    *args, mats["forward"], act="gelu_vjp", gy=gy),
            "dx_adjoint": lambda plain: (
                engine.fused_block_plain if plain else engine.fused_block)(
                    gz, wrt, wit, wbt, None, mats["adjoint"], act="linear"),
            "wgrad": lambda plain: (
                engine.fused_wgrad_plain if plain else engine.fused_wgrad)(
                    x, gz, mats["wgrad"]),
        }
        leaves = [a.detach().clone().requires_grad_(True)
                  for a in (x, wr, wi, wb, bias.reshape(-1))]
        y = ops.fno_block_nd(*leaves, modes, path="ref")
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            y, leaves, gy, retain_graph=True), 10)
        for kind in BACKWARD:
            kms = time_ms(lambda: launch[kind](False), 20)
            pms = time_ms(lambda: launch[kind](True), 10)
            bms, by = bound_ms(kind, b, h, o, spatial, modes, eb, peak)
            log(f"  {dt} {kind}: kernel_ms={kms:.4f} plain_ms={pms:.4f} "
                f"torch_fft_bwd_ms={bwd_ms:.4f} bound_us={1e3 * bms:.2f} "
                f"({by})")
            rows.append({
                "name": f"{kind}_{'f32' if dt == 'float32' else 'bf16'}",
                "route": "cuda",
                "source": WGRAD_SOURCE if kind == "wgrad" else BLOCK_SOURCE,
                "replaces": (WGRAD_REPLACES if kind == "wgrad"
                             else BLOCK_REPLACES),
                "launches": counts[dt].get((kind, dt), 0),
                "max_abs_err": errs[("fno2d_B8", kind, dt)][0],
                "scaled_err": errs[("fno2d_B8", kind, dt)][1],
                "tol": F32_TOL if dt == "float32" else BF16_TOL,
                "ms": kms, "plain_ms": pms, "bound_ms": bms,
                "bound_by": by, "library_ms": None,
                "torch_fft_bwd_ms": bwd_ms})
    log(f"  max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    return stats, rows


def as_tuple(y):
    return y if isinstance(y, tuple) else (y,)


def partial_shapes(configs):
    """Phase 8's shapes: phase 2's odd extents at ranks 2–3, fno2d full
    width at B=1 and B=8, fno3d full width at B=1."""
    shapes = [c for c in check_shapes(configs) if c[0] in ("odd_r2",
                                                           "odd_r3")]
    full = configs.get_config("fno2d")
    for b in (1, 8):
        shapes.append((f"fno2d_B{b}", b, full.hidden, full.hidden,
                       full.spatial, full.modes))
    f3 = configs.get_config("fno3d")
    shapes.append(("fno3d_B1", 1, f3.hidden, f3.hidden, f3.spatial,
                   f3.modes))
    return shapes


def partial_cases(torch, spectral, dft, engine, b, h, o, spatial, modes,
                  seed):
    """Each partial-variant launch at a block of this shape, as the path
    issues it: kind -> (kernel, plain version, f32 inputs, operands by
    dtype). rdft/irdft transform the outer axes (one axis at rank 2, the
    Kronecker-combined operand at rank 3); cdft/icdft are the s_1 stage as
    standalone row launches."""
    r = len(spatial)
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s, sc=1.0: (sc * torch.randn(s, generator=gen)).to(DEVICE)
    n1, k1 = spatial[0], modes[0]
    osp, omd = tuple(spatial[1:]), tuple(modes[1:])
    n_out, p = math.prod(osp), math.prod(omd)
    spec = tuple(modes[r - 1:0:-1])
    fwd, inv = ("rdft", "irdft") if r == 2 else ("outer_fwd", "outer_inv")
    row = lambda kind, sp, md: {
        dt: spectral.row_operand_tensors(kind, sp, md, dt, DEVICE)
        for dt in DTYPES}
    core_ops = {dt: spectral.operand_tensors(spatial, modes, dt,
                                             DEVICE)[2 * r - 2:2 * r + 2]
                for dt in DTYPES}
    return {
        "rdft": (dft.rdft, dft.rdft_plain, [rnd(b, h, n1, n_out)],
                 row(fwd, osp, omd)),
        "cdft": (dft.cdft, dft.cdft_plain,
                 [rnd(b * h * p, n1), rnd(b * h * p, n1)],
                 row("cdft", (n1,), (k1,))),
        "icdft": (dft.cdft, dft.cdft_plain,
                  [rnd(b * o * p, k1), rnd(b * o * p, k1)],
                  row("icdft", (n1,), (k1,))),
        "irdft": (dft.irdft, dft.irdft_plain,
                  [rnd(b, o, n1, p), rnd(b, o, n1, p)], row(inv, osp, omd)),
        "core": (engine.fused_core, engine.fused_core_plain,
                 [rnd(b, h, n1, *spec), rnd(b, h, n1, *spec),
                  rnd(o, h, sc=1.0 / h), rnd(o, h, sc=1.0 / h)], core_ops),
    }


def phase_partial_vs_plain(torch, engine, spectral, dft, configs):
    log("== phase 8: kernel vs plain on the card, partial launches")
    errs = {}
    for seed, (name, b, h, o, spatial, modes) in enumerate(
            partial_shapes(configs)):
        cases = partial_cases(torch, spectral, dft, engine, b, h, o,
                              spatial, modes, 500 + seed)
        for kind, (fn, plain, ins, mats) in cases.items():
            ref = as_tuple(plain(*ins, *mats["float32"]))
            y = as_tuple(fn(*ins, *mats["float32"]))
            torch.cuda.synchronize()
            errs[(name, kind, "float32")] = e = errors(y, ref)
            check(f"{name} f32 {kind} vs plain", e[1], F32_TOL)
            y16 = as_tuple(fn(*[a.to(torch.bfloat16) for a in ins],
                              *mats["bfloat16"]))
            torch.cuda.synchronize()
            errs[(name, kind, "bfloat16")] = e = errors(y16, ref)
            check(f"{name} bf16 {kind} vs f32 plain", e[1], BF16_TOL)
        del cases
    # The block kernel without wb and bias: the bare spectral layer that
    # the rank-1 partial variant runs.
    name, b, h, o, spatial, modes = check_shapes(configs)[0]
    x, wr, wi = block_inputs(b, h, o, spatial, 520, DEVICE)[:3]
    m32 = spectral.operand_tensors(spatial, modes, "float32", DEVICE)
    ref = engine.fused_block_plain(x, wr, wi, None, None, m32, act="linear")
    y = engine.fused_block(x, wr, wi, None, None, m32, act="linear")
    y16 = engine.fused_block(
        *[a.to(torch.bfloat16) for a in (x, wr, wi)], None, None,
        spectral.operand_tensors(spatial, modes, "bfloat16", DEVICE),
        act="linear")
    torch.cuda.synchronize()
    check(f"{name} f32 bare spectral (wb=None) vs plain", rel_err(y, ref),
          F32_TOL)
    check(f"{name} bf16 bare spectral (wb=None) vs f32 plain",
          rel_err(y16, ref), BF16_TOL)
    return errs


def phase_serve_partial(torch, np, configs, fno_mod, sfs, engine, servers):
    log("== phase 9: serve the partial variant, fno2d and fno3d full width")
    cfg = servers["fused"].cfg
    params = servers["fused"].params
    for name, base in (("partial", "fused"), ("partial_bf16", "bf16")):
        servers[name] = sfs.FNOServer(servers[base].cfg, params,
                                      device=DEVICE, variant="partial",
                                      max_batch=8)
    shape = (cfg.in_channels,) + tuple(cfg.spatial)
    for name in ("partial", "partial_bf16"):  # warm outside the count
        srv = servers[name]
        for b in srv.buckets:
            srv(torch.zeros((b,) + shape, device=DEVICE))
        srv(torch.zeros((1,) + shape, device=DEVICE), rollout_steps=4)
    plan = [(x, k, "partial_bf16" if bf16 else "partial")
            for x, k, bf16 in serve_requests(torch, np, shape)]
    expect = expected_launches(plan, engine.PARTIAL_KINDS, cfg.num_layers,
                               servers["partial"].buckets[-1])
    torch.cuda.synchronize()
    engine.LAUNCHES.clear()
    outs = [servers[name](x, rollout_steps=k) for x, k, name in plan]
    torch.cuda.synchronize()
    counts = dict(engine.LAUNCHES)
    log(f"  launches {counts} expected {expect}")
    if counts != expect:
        raise AssertionError(f"kernel launches {counts} != {expect}")
    for (x, k, name), y in zip(plan, outs):
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"non-finite serve output ({name}, K={k})")
        tol = F32_TOL if name == "partial" else BF16_TOL
        check(f"serve {name} n={x.shape[0]} K={k} vs staged f32",
              rel_err(y, servers["staged"](x, rollout_steps=k)), tol)
        check(f"serve {name} n={x.shape[0]} K={k} vs full variant f32",
              rel_err(y, servers["fused"](x, rollout_steps=k)), tol)

    # fno3d at full width: the full-fusion kernels cannot hold it; the
    # partial path serves it.
    c3 = configs.with_fuse_block(configs.get_config("fno3d"))
    p3 = fno_mod.init_fno(torch.Generator().manual_seed(0), c3)
    srv3 = {name: sfs.FNOServer(c, p3, device=DEVICE, variant="partial",
                                max_batch=2)
            for name, c in (("f32", dataclasses.replace(c3, path="fused")),
                            ("bf16", configs.with_precision(
                                dataclasses.replace(c3, path="fused"),
                                "bf16")))}
    staged3 = sfs.FNOServer(dataclasses.replace(c3, path="staged",
                                                fuse_block=False), p3,
                            device=DEVICE, max_batch=2)
    gen = torch.Generator().manual_seed(4)
    reqs = [torch.randn((n, c3.in_channels) + tuple(c3.spatial),
                        generator=gen).to(DEVICE) for n in (1, 2)]
    torch.cuda.synchronize()
    engine.LAUNCHES.clear()
    outs3 = {name: [srv(x) for x in reqs] for name, srv in srv3.items()}
    torch.cuda.synchronize()
    want = {(k, dt): c3.num_layers * len(reqs)
            for k in engine.PARTIAL_KINDS for dt in DTYPES}
    counts3 = dict(engine.LAUNCHES)
    log(f"  fno3d launches {counts3}")
    if counts3 != want:
        raise AssertionError(f"fno3d launches {counts3} != {want}")
    ms3 = {}
    for i, x in enumerate(reqs):
        ref = staged3(x)
        for name, tol in (("f32", F32_TOL), ("bf16", BF16_TOL)):
            y = outs3[name][i]
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"non-finite fno3d output ({name})")
            check(f"serve fno3d {name} n={x.shape[0]} vs staged f32",
                  rel_err(y, ref), tol)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv3[name](x)
            torch.cuda.synchronize()
            ms3[f"{name}_B{x.shape[0]}"] = 1e3 * (time.perf_counter() - t0)
    log(f"  fno3d request ms (host clock, after one warm request): {ms3}")
    return counts, ms3


def library_call(torch, kind, ins, n, k):
    """The one torch.fft call that computes a row launch's function, on its
    f32 inputs (a yardstick; the port never calls it), or None (core)."""
    if kind == "rdft":
        return lambda: torch.fft.rfft(ins[0], dim=-1)[..., :k]
    if kind == "core":
        return None
    c = torch.complex(*ins)
    if kind == "cdft":
        return lambda: torch.fft.fft(c, dim=-1)[..., :k]
    if kind == "icdft":
        return lambda: torch.fft.ifft(c, n=n, dim=-1)
    return lambda: torch.fft.irfft(c, n=n, dim=-1)


def phase_partial_times(torch, engine, spectral, dft, ops, configs, errs,
                        serve_counts, train_counts):
    log("== phase 11: times — partial launches and block at fno2d B=8")
    full = configs.get_config("fno2d")
    b, h, o = 8, full.hidden, full.hidden
    spatial, modes = full.spatial, full.modes
    cases = partial_cases(torch, spectral, dft, engine, b, h, o, spatial,
                          modes, 600)
    f3 = configs.get_config("fno3d")
    cases3 = partial_cases(torch, spectral, dft, engine, 1, f3.hidden,
                           f3.hidden, f3.spatial, f3.modes, 601)
    # (axis length, kept modes) of each launch's library call
    nk = {"rdft": (spatial[1], modes[1]), "irdft": (spatial[1], modes[1]),
          "cdft": (spatial[0], modes[0]), "icdft": (spatial[0], modes[0])}
    rows = []
    for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                         ("bfloat16", PEAK_BF16_FLOPS, 2)):
        tdt = getattr(torch, dt)
        t = {}
        for kind in PARTIAL_LAUNCHES:
            fn, plain, ins, mats = cases[kind]
            a = [x.to(tdt) for x in ins]
            m = mats[dt]
            lib = library_call(torch, kind, ins, *nk.get(kind, (0, 0)))
            t[kind] = {
                "ms": time_ms(lambda: fn(*a, *m), 20),
                "plain_ms": time_ms(lambda: plain(*a, *m), 10),
                "library_ms": time_ms(lib, 20) if lib else None,
                "bound": bound_ms(kind, b, h, o, spatial, modes, eb, peak)}
            log(f"  {dt} {kind}: kernel_ms={t[kind]['ms']:.4f} plain_ms="
                f"{t[kind]['plain_ms']:.4f} library_ms="
                f"{t[kind]['library_ms']} bound_us="
                f"{1e3 * t[kind]['bound'][0]:.2f} ({t[kind]['bound'][1]})")
        for kind in ("rdft", "irdft"):  # fno3d's outer launches at B=1
            fn, _, ins, mats = cases3[kind]
            a = [x.to(tdt) for x in ins]
            t[kind]["ms_fno3d_b1"] = time_ms(lambda: fn(*a, *mats[dt]), 5)
            log(f"  {dt} {kind} fno3d outer B=1: kernel_ms="
                f"{t[kind]['ms_fno3d_b1']:.4f}")
        for kind in ("rdft", "cdft", "irdft", "core"):
            ks = ("cdft", "icdft") if kind == "cdft" else (kind,)
            e = [errs[("fno2d_B8", k, dt)] for k in ks]
            row = {
                "name": f"{kind}_{'f32' if dt == 'float32' else 'bf16'}",
                "route": "cuda",
                "source": CORE_SOURCE if kind == "core" else ROWS_SOURCE,
                "replaces": PARTIAL_REPLACES[kind],
                "launches": serve_counts.get((kind, dt), 0),
                "launches_train": train_counts[dt].get((kind, dt), 0),
                "max_abs_err": max(v[0] for v in e),
                "scaled_err": max(v[1] for v in e),
                "tol": F32_TOL if dt == "float32" else BF16_TOL,
                "ms": t[kind]["ms"], "plain_ms": t[kind]["plain_ms"],
                "bound_ms": t[kind]["bound"][0],
                "bound_by": t[kind]["bound"][1],
                "library_ms": t[kind]["library_ms"]}
            if kind == "core":
                row["library_note"] = ("no single PyTorch call computes "
                                       "cDFT_s1 -> CGEMM -> icDFT_s1")
            elif kind in ("rdft", "irdft"):
                row["ms_fno3d_b1"] = t[kind]["ms_fno3d_b1"]
            if kind == "cdft":  # the padded inverse operand, same kernel
                row.update({f"{key}_inverse": t["icdft"][key]
                            for key in ("ms", "plain_ms", "library_ms")})
                row["bound_ms_inverse"] = t["icdft"]["bound"][0]
            rows.append(row)
    del cases, cases3

    # The whole block forward, served (no grad): the partial variant's
    # three launches + tail against the one-launch full variant and the
    # staged torch.fft block.
    args32 = block_inputs(b, h, o, spatial, 602, DEVICE)
    block = {}
    with torch.no_grad():
        for dt in DTYPES:
            x, wr, wi, wb, bias = [a.to(getattr(torch, dt)) for a in args32]
            bias1 = bias.reshape(-1)
            run = lambda **kw: ops.fno_block_nd(x, wr, wi, wb, bias1, modes,
                                                **kw)
            block[dt] = {"partial_ms": time_ms(lambda: run(variant="partial"),
                                               20),
                         "full_ms": time_ms(lambda: run(variant="full"), 20),
                         "torch_fft_ms": time_ms(lambda: run(path="ref"),
                                                 10)}
            log(f"  {dt} block forward B=8: {block[dt]}")
    return rows, block


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
    from repro_torch import configs, optim, tree
    from repro_torch.core import fno as fno_mod
    from repro_torch.core import spectral
    from repro_torch.data import pde
    from repro_torch.kernels import build, dft, engine, ops
    from repro_torch.train import serve_fno_step as sfs
    from repro_torch.train import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    seconds = {}

    def timed(label, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[label] = time.perf_counter() - t
        log(f"  phase {label}: {seconds[label]:.1f} s")
        return out

    timed("1", phase_environment, torch, build)
    errs = timed("2", phase_kernel_vs_plain, torch, engine, spectral,
                 configs)
    counts, servers = timed("3", phase_serve, torch, np, configs, fno_mod,
                            sfs, engine)
    layers = servers["fused"].cfg.num_layers
    stats = timed("4 window", phase_serve_window, torch, np, servers,
                  engine, layers)
    rows = timed("4 times", phase_times, torch, build, engine, spectral,
                 ops, configs, counts, errs)
    bwd_errs = timed("5", phase_backward_vs_plain, torch, engine, spectral,
                     configs)
    batch, runs, train_counts = timed("6", phase_train, torch, configs,
                                      fno_mod, pde, tree, ts, optim, engine)
    train_stats, bwd_rows = timed(
        "7", phase_train_times, torch, np, engine, spectral, ops, configs,
        batch, runs, train_counts, bwd_errs)
    for row in rows:  # the forward kernel's launches on the training path
        dt = "float32" if row["name"].endswith("f32") else "bfloat16"
        row["launches_train"] = train_counts[dt].get(("block_fwd", dt), 0)
    rows += bwd_rows
    part_errs = timed("8", phase_partial_vs_plain, torch, engine, spectral,
                      dft, configs)
    part_counts, fno3d_ms = timed("9", phase_serve_partial, torch, np,
                                  configs, fno_mod, sfs, engine, servers)
    _, part_runs, part_train_counts = timed(
        "10", phase_train, torch, configs, fno_mod, pde, tree, ts, optim,
        engine, variant="partial", phase="10")
    part_stats = timed("11 window", phase_serve_window, torch, np, servers,
                       engine, layers, names=("partial", "partial_bf16"),
                       kinds=engine.PARTIAL_KINDS, phase="11")
    log("== phase 11: train window, partial variant")
    part_train = timed("11 train", train_window, torch, np, batch,
                       part_runs)
    part_rows, part_block = timed(
        "11 times", phase_partial_times, torch, engine, spectral, dft, ops,
        configs, part_errs, part_counts, part_train_counts)
    rows += part_rows
    log(f"serve window: {json.dumps(stats)}")
    log(f"train window: {json.dumps(train_stats)}")
    log(f"serve window, partial: {json.dumps(part_stats)}")
    log(f"train window, partial: {json.dumps(part_train)}")
    log(f"block forward, partial vs full: {json.dumps(part_block)}")
    log(f"fno3d partial request ms: {json.dumps(fno3d_ms)}")
    log(f"phase seconds: {json.dumps(seconds)}")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
