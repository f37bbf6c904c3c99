"""Chaos gate (counterpart of ``scripts/chaos_smoke.py``): a scripted
deterministic fault plan replayed through ``ResilientServer``; it fails
unless the resilience contract holds EXACTLY:

  * every accepted request is answered with a finite output (zero drops
    through a kernel fault, a NaN injection and a replica kill);
  * degraded-request count == planned degradation faults (kernel + nan) —
    no silent fallback, no spurious fallback;
  * shed-request count == the admission overflow the script provokes;
  * every answer, degraded (staged fallback) or not, matches the staged
    path to the parity tolerance (2e-4 in f32, of the output's magnitude);
  * a corrupted checkpoint makes the hot reload ROLL BACK (the old params
    keep serving, bit-identical), and a later valid checkpoint reloads and
    serves the new params.

    PYTHONPATH=src python -m repro_torch.launch.chaos_smoke
    PYTHONPATH=src python -m repro_torch.launch.chaos_smoke --reduced \\
        --device cpu

Runs on the GPU by default (fno2d at full width; the fused path served
through CUDA graphs); ``--reduced`` is the reference's reduced fno2d and
``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile

import torch

from repro_torch import configs, tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import fno as fno_mod
from repro_torch.distributed import faults as flt
from repro_torch.train import serve_runtime as srt

PARITY_TOL = 2e-4  # f32: fused == staged to 2e-4 (DESIGN.md §4)
N_REQUESTS = 4
N_OVERFLOW = 2


def parity_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    """Max |y - ref| scaled to the reference's magnitude (max(|ref|, 1))."""
    y, ref = y.float().cpu(), ref.float().cpu()
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def run(cfg, device, *, max_batch: int = 2) -> dict:
    """The gate on `cfg` (fused path) at `device`; returns the final stats
    and raises AssertionError on any breach."""
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg)
    params2 = fno_mod.init_fno(torch.Generator().manual_seed(1), cfg)
    staged = dataclasses.replace(cfg, path="staged", fuse_block=False)
    plan = flt.standard_chaos_plan()
    planned_degradations = plan.count(kinds=("kernel", "nan"))
    planned_kills = plan.count(kinds=("kill",))
    gen = torch.Generator().manual_seed(2)
    xs = [torch.randn((max_batch, cfg.in_channels) + tuple(cfg.spatial),
                      generator=gen) for _ in range(N_REQUESTS)]

    def oracle(p, x):
        with torch.no_grad():
            return fno_mod.apply_fno(
                tree.map(lambda t: t.to(device), p), staged,
                x.to(device)).cpu()

    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir)
        rs = srt.ResilientServer(
            cfg, params, device=device, replicas=2,
            max_batch=max_batch, queue_limit=N_REQUESTS, fault_plan=plan,
            checkpointer=ck, seed=0, backoff_base_s=1e-3)
        want = [oracle(params, x) for x in xs]

        # -- the fault-plan replay ------------------------------------------
        for x in xs:
            rs.submit(x)
        ys = rs.drain()
        if len(ys) != N_REQUESTS:
            raise AssertionError(f"dropped requests: {len(ys)}/"
                                 f"{N_REQUESTS} answered")
        errs = []
        for i, y in enumerate(ys):
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"request {i}: non-finite output")
            errs.append(parity_err(y, want[i]))
            if errs[-1] > PARITY_TOL:
                raise AssertionError(f"request {i}: scaled error "
                                     f"{errs[-1]:.2e} > {PARITY_TOL}")
        s = dict(rs.stats)
        if s["degraded"] != planned_degradations:
            raise AssertionError(
                f"degraded={s['degraded']}, the plan injected "
                f"{planned_degradations} degradation faults — no silent "
                f"fallback")
        if s["killed"] != planned_kills or s["failovers"] < 1:
            raise AssertionError(f"killed={s['killed']} failovers="
                                 f"{s['failovers']}: the kill must cost a "
                                 f"failover, not an answer")
        if not s["served"] == s["accepted"] == N_REQUESTS:
            raise AssertionError(f"served/accepted: {s}")
        if rs.pool.states()["dead"] != planned_kills:
            raise AssertionError(f"pool {rs.pool.states()}")

        # -- admission overflow: explicit shed, exact count -----------------
        shed = 0
        for i in range(N_REQUESTS + N_OVERFLOW):
            try:
                rs.submit(xs[i % N_REQUESTS])
            except srt.RequestRejected:
                shed += 1
        if shed != N_OVERFLOW or rs.stats["shed"] != N_OVERFLOW:
            raise AssertionError(f"queue_limit={N_REQUESTS}: expected "
                                 f"exactly {N_OVERFLOW} shed, got {shed}")
        ys2 = rs.drain()
        if len(ys2) != N_REQUESTS or not all(
                bool(torch.isfinite(y).all()) for y in ys2):
            raise AssertionError("the admitted requests after the shed "
                                 "must all be answered finite")

        # -- corrupt checkpoint: reload rolls back, old params serve --------
        ck.save(1, params2)
        flt.corrupt_checkpoint(ckdir, 1)
        before = rs(xs[0])
        if rs.reload() is not False or rs.stats["rollbacks"] != 1:
            raise AssertionError("a corrupt checkpoint must roll back")
        if not torch.equal(rs(xs[0]), before):
            raise AssertionError("after the rollback the old params must "
                                 "serve bit for bit")

        # -- valid checkpoint: canary passes, params swap -------------------
        ck.save(2, params2)
        if rs.reload() is not True:
            raise AssertionError("a valid checkpoint must reload")
        swap_err = parity_err(rs(xs[0]), oracle(params2, xs[0]))
        if swap_err > PARITY_TOL:
            raise AssertionError(f"after the reload the server must serve "
                                 f"the new params: scaled error "
                                 f"{swap_err:.2e}")
    return {"stats": dict(rs.stats), "pool": rs.pool.states(),
            "max_scaled_err": max(errs), "swap_scaled_err": swap_err,
            "graphed": rs.primary.graphed}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's reduced fno2d (default: full "
                         "width)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("chaos_smoke runs on the GPU by default and no "
                           "CUDA device is available; pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        configs.with_fuse_block(configs.get_config("fno2d",
                                                   reduced=args.reduced)),
        path="fused")
    out = run(cfg, args.device)
    s = out["stats"]
    print(f"chaos smoke OK: {N_REQUESTS} accepted requests all finite under "
          f"kernel+nan+kill faults (degraded={s['degraded']} == plan, "
          f"failovers={s['failovers']}, shed={s['shed']} == overflow, "
          f"reload rollback+swap verified, max scaled error "
          f"{out['max_scaled_err']:.3e} <= {PARITY_TOL}, graphed="
          f"{out['graphed']})")
    print(f"  final pool: {out['pool']}  stats: {s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
