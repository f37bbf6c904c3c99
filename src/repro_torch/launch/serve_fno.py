"""Batched FNO serving CLI (counterpart of ``repro/launch/serve_fno.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_fno --arch fno2d \
        --requests 8 --max-batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve_fno --replay
    PYTHONPATH=src python -m repro_torch.launch.serve_fno --chaos
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve_fno --dp 2 --tp 2 --backend gloo

On a DP×TP mesh (run under ``torch.distributed.run``, one process a rank;
``--dp``/``--tp`` default to the reference's auto grid, ``_pick_tp``, and
their product must be the world size) every rank serves every request:
its DP rows, TP over the hidden axis, the outputs all-gathered; rank 0
prints the collective plan. ``--backend`` is explicit: ``nccl`` needs a
card a rank, ``gloo`` stages the collectives through the host where the
ranks share a card. ``--replay`` and ``--chaos`` run on one rank only.

Serves request batches of seeded random sizes through ``FNOServer`` on the
GPU (``--device cpu`` runs the plain versions), asserts every output is
finite, and prints samples/s beside the device's name. On the card the
fused path is served through one CUDA graph per bucket and rollout depth.
On the fused path every FNO layer is one launch of the CUDA block kernel
(``--variant full``) or the paper's partial fusion (``--variant partial``:
row rDFT, fused core and row irDFT launches, then the block tail). With
``--no-fuse-block`` the kernels fuse the spectral conv only, as the paper
does (the bare layer kernel, or the partial variant's three launches), and
the bypass, bias and GELU run as PyTorch ops.

The fusion contract is checked on the served path: with whole-block fusion
and the full variant, every served request runs exactly ``num_layers``
``block_fwd`` launches a chunk and step, a K-step rollout ``num_layers ×
K`` (read from ``engine.LAUNCHES`` across graph replays); the partial and
spectral-only designs report their launches a layer.

``--replay`` drives the continuous-batching tier (``train/serve_queue``)
with a seeded Poisson arrival schedule on a virtual clock whose service
model is calibrated from measured serve steps; ``--chaos`` replays the
standard fault plan through the resilient runtime
(``train/serve_runtime``), then a corrupt-checkpoint reload that must roll
back and a valid reload that must swap.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.analysis import format_findings, launch_lint
from repro_torch.configs import FNO_IDS, get_config, with_precision
from repro_torch.configs.fno import with_fuse_block
from repro_torch.core import fno as fno_mod
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_mod
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
    ap.add_argument("--no-fuse-block", action="store_true",
                    help="fused path: fuse each spectral conv only, with "
                         "the bypass, bias and GELU in PyTorch")
    ap.add_argument("--rollout-steps", type=int, default=1,
                    help="serve K-step autoregressive rollouts (the carry "
                         "stays on the device between steps)")
    ap.add_argument("--replay", action="store_true",
                    help="traffic replay through the continuous-batching "
                         "tier: a seeded Poisson arrival schedule coalesced "
                         "into buckets on a virtual clock, printing p50/p99 "
                         "latency and queue depth")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="--replay arrival rate in requests/s")
    ap.add_argument("--deadline-ms", type=float, default=100.0,
                    help="--replay per-request deadline (milliseconds)")
    ap.add_argument("--chaos", action="store_true",
                    help="replay the standard fault plan (kernel fault, NaN "
                         "injection, replica kill, corrupt checkpoint) "
                         "through the resilient runtime and print the pool "
                         "and degradation stats")
    ap.add_argument("--replicas", type=int, default=2,
                    help="replica-pool size for --chaos and --replay")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel ranks (0 = world size // tp)")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel ranks over hidden (0 = auto: the "
                         "largest divisor of both the world size and "
                         "hidden that keeps dp >= tp)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="the mesh's collective backend (required on a "
                         "mesh of more than one rank)")
    return ap


def _pick_tp(n_dev: int, hidden: int) -> int:
    best = 1
    for tp in range(2, n_dev + 1):
        if n_dev % tp == 0 and hidden % tp == 0 and n_dev // tp >= tp:
            best = tp
    return best


def _mesh_shape(args, cfg) -> tuple:
    """(dp, tp) of the run: the reference's auto grid over the world size
    (``WORLD_SIZE``, 1 outside ``torch.distributed.run``) unless given;
    refuses a mesh other than the world and what runs on one rank only."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    tp = args.tp or _pick_tp(world, cfg.hidden)
    dp = args.dp or max(world // tp, 1)
    if dp * tp != world:
        raise SystemExit(
            f"serve_fno: requested mesh dp{dp}xtp{tp} needs {dp * tp} "
            f"ranks but the world has {world} — pass --dp/--tp whose "
            f"product is the world size (torch.distributed.run "
            f"--nproc-per-node), or omit them for the auto grid")
    if dp * tp > 1 and (args.replay or args.chaos):
        raise SystemExit("serve_fno: --replay and --chaos run on one rank; "
                         "the mesh's tiers are not ported yet")
    if dp * tp > 1 and args.backend is None:
        raise SystemExit("serve_fno: a mesh needs --backend nccl or gloo")
    return dp, tp


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
    cfg = with_fuse_block(cfg, args.path == "fused"
                          and not args.no_fuse_block)
    cfg = dataclasses.replace(cfg, path=args.path)
    dp, tp = _mesh_shape(args, cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg)
    if args.chaos:
        return _run_chaos(args, cfg, params)
    if args.replay:
        return _run_replay(args, cfg, params)
    if dp * tp == 1:
        return _serve(args, cfg, sfs.FNOServer(
            cfg, params, device=args.device, variant=args.variant,
            max_batch=args.max_batch))
    mesh = mesh_mod.make_mesh((dp, tp), ("data", "model"),
                              backend=args.backend, device=args.device)
    try:
        ctx = shd.make_context(cfg, mesh, kind="serve")
        local = shd.shard_params(params, shd.context_specs(cfg, ctx, params),
                                 mesh)
        return _serve(args, cfg, sfs.FNOServer(
            cfg, local, variant=args.variant, max_batch=args.max_batch,
            ctx=ctx))
    finally:
        mesh_mod.close()


def _serve(args, cfg, server) -> dict:
    """Warm, hold the fusion contract, serve the seeded requests (every
    rank of a mesh the same ones) and report; rank 0 prints."""
    dev = server.device
    say = print if server.ctx is None or server.ctx.mesh.rank == 0 \
        else (lambda *a, **k: None)
    shape = (cfg.in_channels,) + tuple(cfg.spatial)

    # Warm every bucket (kernel build, graph capture) outside the timed
    # loop, then hold the fusion contract on one request per bucket.
    server.warm((args.rollout_steps,))
    _sync(dev)
    ctx = server.ctx
    contract = fusion_contract(
        server, args.variant, args.rollout_steps,
        kind=("block_linear" if ctx is not None and ctx.model_axis
              else "block_fwd"))

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
    plan = server.collective_plan()
    out = {
        "arch": args.arch, "path": args.path, "variant": args.variant,
        "fuse_block": cfg.fuse_block, "dtype": args.dtype,
        "device": device_name(dev), "buckets": list(server.buckets),
        "rollout_steps": args.rollout_steps, "requests": args.requests,
        "samples": samples, "padded": server.stats["padded"],
        "seconds": dt, "samples_per_s": samples / max(dt, 1e-9),
        "graphed": server.graphed, "launches": contract,
        "collective_plan": plan,
    }
    mesh = f"dp{plan['dp']}xtp{plan['tp']}"
    say(f"serve_fno arch={args.arch} mesh={mesh} path={args.path} "
        f"variant={args.variant} fuse_block={cfg.fuse_block} "
        f"dtype={args.dtype} "
        f"device={out['device']} buckets={list(server.buckets)}")
    say(f"  collective plan: interior={plan['interior_collective']} "
        f"final={plan['final_collective']} layout={plan['tp_layout']} "
        f"overlap={plan['tp_overlap']} backend={plan['backend']} "
        f"graphed={plan['graphed']} "
        f"wire={plan['wire_bytes_per_fwd'] / 2**10:.1f}KiB/fwd")
    where = f"on {out['device']}" if server.ctx is None else (
        f"on {mesh} ranks, {out['device']}, eager" + (
            ": collectives staged through the host, not a deployment's "
            "speed" if server.ctx.mesh.host_staged else ""))
    say(f"  served {args.requests} requests / {samples} samples "
        f"(rollout K={args.rollout_steps}) in {dt * 1e3:.3f} ms "
        f"({out['samples_per_s']:.1f} samples/s {where}, "
        f"{server.stats['padded']} padded), all outputs finite")
    say(f"  launches a layer and step by bucket (K={args.rollout_steps}): "
        f"{contract}")
    return out


def fusion_contract(server, variant: str, rollout_steps: int,
                    kind: str = "block_fwd", held: bool = True) -> dict:
    """Kernel launches a layer and step of one served request of each
    bucket (``analysis.launch_lint.serve_step_contract``: a graphed
    server's from ``engine.LAUNCHES`` across its replays, an eager one's
    from the kernels' entry points, on the CPU too): ``{bucket: {kind:
    n}}``. With whole-block fusion and the full variant each must be
    exactly one `kind` a layer and step (a request runs ``num_layers ×
    K``, the reference's one fused kernel a layer; "block_linear" for a
    mesh's TP rank); raises AssertionError otherwise (unless `held` is
    False). The partial, spectral-only and ends designs' launches are
    reported as they are."""
    findings, out = launch_lint.serve_step_contract(
        server, server.cfg, variant=variant, rollout_steps=rollout_steps,
        kind=kind, held=held)
    if findings:
        raise AssertionError("fusion contract: "
                             + format_findings(findings))
    return out


def request(cfg, i: int, n: int) -> torch.Tensor:
    """Request i of a replay or chaos run: `n` seeded normal samples on the
    host."""
    gen = torch.Generator().manual_seed(1_000_003 + i)
    return torch.randn((n, cfg.in_channels) + tuple(cfg.spatial),
                       generator=gen)


def _run_replay(args, cfg, params) -> dict:
    """--replay: the continuous-batching tier under a seeded Poisson
    arrival schedule on a virtual clock. The per-bucket service model is
    calibrated from this card's serve steps (the median of 3 synchronised
    calls of each bucket after its capture), so the p50/p99 rows reflect
    the machine while the admission and coalescing decisions stay
    deterministic given the calibration. ``launch/serve_replay_smoke.py``
    is the stricter gate (a fixed synthetic model, exact counts)."""
    from repro_torch.train import serve_queue as sq
    from repro_torch.train import serve_runtime as srt

    rs = srt.ResilientServer(cfg, params, device=args.device,
                             replicas=args.replicas, variant=args.variant,
                             max_batch=args.max_batch,
                             queue_limit=max(args.requests, 1), seed=0)
    steps = args.rollout_steps
    base = calibrate(rs.primary, steps)
    cbs = sq.ContinuousBatchingServer(
        rs, queue_limit=args.max_batch * 2, coalesce_s=2.0 / args.rate,
        clock=sq.VirtualClock(),
        service_model=lambda bucket, k: base[bucket])
    sched = sq.poisson_schedule(
        0, args.requests, rate_hz=args.rate, max_n=args.max_batch,
        rollout_steps=steps, deadline_s=args.deadline_ms * 1e-3)
    rep = cbs.replay(sched, lambda a, i: request(cfg, i, a.n))
    for r in cbs.requests.values():
        if r.status == "done" and not bool(torch.isfinite(r.y).all()):
            raise RuntimeError("non-finite replay output")
    s, lat, qd = rep["stats"], rep["latency"], rep["queue_depth"]
    name = device_name(rs.primary.device)
    print(f"serve_fno --replay arch={args.arch} device={name} "
          f"rate={args.rate:.0f}req/s deadline={args.deadline_ms:.0f}ms "
          f"rollout K={steps} buckets={list(rs.primary.buckets)} "
          f"graphed={rs.primary.graphed}")
    print(f"  service model (ms by bucket, measured): "
          f"{ {b: round(1e3 * t, 4) for b, t in base.items()} }")
    print(f"  admission: offered={s['offered']} accepted={s['accepted']} "
          f"shed={s['shed']} deadline_exceeded={s['deadline_exceeded']} "
          f"completed={s['completed']} degraded={rs.stats['degraded']}")
    print(f"  batching: batches={s['batches']} coalesced={s['coalesced']} "
          f"queue_depth p50={qd['p50']:.1f} p99={qd['p99']:.1f} "
          f"max={qd['max']:.0f}")
    print(f"  latency: p50={lat['p50'] * 1e3:.3f}ms "
          f"p99={lat['p99'] * 1e3:.3f}ms mean={lat['mean'] * 1e3:.3f}ms "
          f"over {lat['count']} completed ({rep['served_samples']} "
          f"samples, makespan {rep['makespan_s'] * 1e3:.1f}ms virtual)")
    return {"arch": args.arch, "device": name, "service_model_s": base,
            **rep}


def calibrate(server, rollout_steps: int) -> dict:
    """Seconds of one served call of each bucket: the median of 3
    synchronised calls after a warm one (the capture, on the card)."""
    shape = (server.cfg.in_channels,) + tuple(server.cfg.spatial)
    base = {}
    for b in server.buckets:
        xb = torch.zeros((b,) + shape, device=server.device)
        server(xb, rollout_steps=rollout_steps)
        _sync(server.device)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            server(xb, rollout_steps=rollout_steps)
            _sync(server.device)
            ts.append(time.perf_counter() - t0)
        base[b] = float(np.median(ts))
    return base


def _run_chaos(args, cfg, params) -> dict:
    """--chaos: the standard fault plan through the resilient runtime;
    every accepted request must be answered finite. Then the checkpoint
    legs: a corrupt step must make the hot reload roll back (the old params
    keep serving, bit for bit) and a valid step must swap in and serve.
    ``launch/chaos_smoke.py`` is the stricter gate."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import faults as flt
    from repro_torch.train import serve_runtime as srt

    plan = flt.standard_chaos_plan()
    params2 = fno_mod.init_fno(torch.Generator().manual_seed(1), cfg)
    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir)
        rs = srt.ResilientServer(
            cfg, params, device=args.device, replicas=args.replicas,
            variant=args.variant, max_batch=args.max_batch,
            queue_limit=max(args.requests, 1), fault_plan=plan,
            checkpointer=ck, seed=0, backoff_base_s=1e-3)
        rng = np.random.default_rng(0)
        sizes = rng.integers(1, args.max_batch + 1, size=args.requests)
        t0 = time.perf_counter()
        ys = [rs(request(cfg, i, int(n))) for i, n in enumerate(sizes)]
        dt = time.perf_counter() - t0
        for y in ys:
            if not bool(torch.isfinite(y).all()):
                raise RuntimeError("non-finite chaos serve output")
        # The corrupt-checkpoint leg: the reload must roll back.
        x0 = request(cfg, 0, int(sizes[0]))
        before = rs(x0)
        ck.save(1, params2)
        flt.corrupt_checkpoint(ckdir, 1)
        if rs.reload() is not False:
            raise AssertionError("reload of a corrupt checkpoint must roll "
                                 "back")
        if not torch.equal(rs(x0), before):
            raise AssertionError("after a rollback the old params must "
                                 "serve bit for bit")
        # The valid leg: the reload must swap the new params in.
        ck.save(2, params2)
        if rs.reload() is not True:
            raise AssertionError("reload of a valid checkpoint must swap")
        swapped = rs(x0)
        report = rs.pool_report()
    samples = int(sizes.sum())
    name = device_name(rs.primary.device)
    print(f"serve_fno --chaos arch={args.arch} device={name} "
          f"replicas={args.replicas} requests={args.requests} "
          f"graphed={rs.primary.graphed}")
    print(f"  pool: {report['replicas']}")
    print(f"  stats: accepted={report['accepted']} "
          f"served={report['served']} degraded={report['degraded']} "
          f"shed={report['shed']} failovers={report['failovers']} "
          f"quarantined={report['quarantined']} "
          f"reinstated={report['reinstated']} "
          f"reloads={report['reloads']} rollbacks={report['rollbacks']}")
    print(f"  served {samples} samples in {dt * 1e3:.3f} ms under the "
          f"fault plan; all outputs finite; corrupt reload rolled back, "
          f"valid reload swapped (max |Δy| "
          f"{float((swapped - before).abs().max()):.3e})")
    return {"arch": args.arch, "device": name, **report}


def main() -> None:
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
