"""Continuous-batching replay gate (counterpart of
``scripts/serve_replay_smoke.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_replay_smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_replay_smoke \\
        --reduced --device cpu

Replays a seeded Poisson arrival schedule through the continuous-batching
tier (``train/serve_queue``) over the real fused server, on a virtual
clock with a FIXED synthetic service model, so every count below is
machine-independent and asserted exactly (the reference's counts for the
same schedule and model):

  * exact admission/coalescing counts — shed, batches, coalesced,
    deadline_exceeded;
  * conservation — offered == accepted + shed and accepted == completed +
    deadline_exceeded + failed;
  * the deadline contract — no request is served past its deadline, so
    completed p99 <= the deadline;
  * determinism — a second replay of the schedule gives the same report;
  * every served output is finite (the engine really ran);
  * on the card, the rollout launch contract — a K-step rollout runs
    exactly num_layers × K ``block_fwd`` launches for K in {1, 4} (one
    graph replay each);
  * the tier batches and never changes the math: a K-step answer through
    the tier equals the server's own rollout bit for bit.

Runs on the GPU by default (fno2d at full width; ``--reduced`` the
reference's reduced fno2d); ``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import sys

import torch

from repro_torch import configs
from repro_torch.core import fno as fno_mod
from repro_torch.kernels import engine
from repro_torch.train import serve_fno_step as sfs
from repro_torch.train import serve_queue as sq

# The schedule and its exact expected outcome: a pure function of these
# constants and the bucket ladder. QUANTUM is the reference's tuned batch
# block for its reduced fno2d, so the ladder is (8,) as in the reference's
# gate (a valid port quantum: a multiple of engine.BATCH_BLOCK).
SEED = 0
QUANTUM = 8
REQUESTS = 24
RATE_HZ = 600.0
MAX_N = 4
ROLLOUT_STEPS = 2
DEADLINE_S = 0.015
QUEUE_LIMIT = 6
COALESCE_S = 0.004


def service_model(bucket: int, steps: int) -> float:
    """The fixed synthetic service time of one batch, seconds."""
    return 1e-3 * steps + 2.5e-4 * bucket


# Every admission outcome: sheds (bounded queue), a deadline miss (failed
# with DeadlineExceeded, never served late), and coalescing (10 requests
# ride in another request's batch).
EXPECTED = {"offered": 24, "accepted": 20, "shed": 4, "completed": 19,
            "deadline_exceeded": 1, "failed": 0, "batches": 9,
            "coalesced": 10}


def replay_once(server):
    """(tier, report) of one replay of the fixed schedule over `server`;
    request i's samples are seeded by i."""
    cbs = sq.ContinuousBatchingServer(
        server, queue_limit=QUEUE_LIMIT, coalesce_s=COALESCE_S,
        clock=sq.VirtualClock(), service_model=service_model)
    sched = sq.poisson_schedule(SEED, REQUESTS, rate_hz=RATE_HZ,
                                max_n=MAX_N, rollout_steps=ROLLOUT_STEPS,
                                deadline_s=DEADLINE_S)
    cfg = server.cfg
    shape = (cfg.in_channels,) + tuple(cfg.spatial)

    def input_fn(a, i):
        gen = torch.Generator().manual_seed(SEED * 1000 + i)
        return torch.randn((a.n,) + shape, generator=gen)

    return cbs, cbs.replay(sched, input_fn)


def check_replay(cbs, rep) -> None:
    """The exact counts, conservation, the deadline contract and finite
    outputs of one replay; raises AssertionError on any breach."""
    s = rep["stats"]
    for k, v in EXPECTED.items():
        if s[k] != v:
            raise AssertionError(f"{k}: got {s[k]}, expected exactly {v}")
    if s["offered"] != s["accepted"] + s["shed"]:
        raise AssertionError(f"offered != accepted + shed: {s}")
    if s["accepted"] != (s["completed"] + s["deadline_exceeded"]
                         + s["failed"]):
        raise AssertionError(f"accepted is not conserved: {s}")
    if cbs.queue_depth() != 0:
        raise AssertionError("a drained replay left queued requests")
    for r in cbs.requests.values():
        if r.status != "done":
            continue
        if r.deadline_t is not None and r.t_complete > r.deadline_t + 1e-12:
            raise AssertionError(
                f"request {r.idx} served {r.t_complete - r.deadline_t:.4f}"
                f" s past its deadline without DeadlineExceeded")
        if not bool(torch.isfinite(r.y).all()):
            raise AssertionError(f"request {r.idx}: non-finite output")
    if rep["latency"]["p99"] > DEADLINE_S:
        raise AssertionError(f"completed p99 {rep['latency']['p99']:.4f} s"
                             f" > deadline {DEADLINE_S} s")


def rollout_launches(server, ks=(1, 4)) -> dict:
    """``block_fwd`` launches of one K-step rollout at the smallest bucket,
    by K, read from ``engine.LAUNCHES`` across the replay."""
    cfg = server.cfg
    x = torch.zeros((server.buckets[0], cfg.in_channels)
                    + tuple(cfg.spatial), device=server.device)
    out = {}
    for k in ks:
        server(x, rollout_steps=k)  # capture outside the count
        before = collections.Counter(engine.LAUNCHES)
        server(x, rollout_steps=k)
        torch.cuda.synchronize(server.device)
        got = collections.Counter(engine.LAUNCHES) - before
        out[k] = got[("block_fwd", cfg.precision.compute_dtype)]
        if dict(got) != {("block_fwd", cfg.precision.compute_dtype):
                         cfg.num_layers * k}:
            raise AssertionError(f"K={k} rollout ran {dict(got)}, want "
                                 f"{cfg.num_layers * k} block_fwd")
    return out


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        configs.with_fuse_block(configs.get_config("fno2d",
                                                   reduced=args.reduced)),
        path="fused")
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg)
    server = sfs.FNOServer(cfg, params, device=args.device,
                           max_batch=MAX_N, quantum=QUANTUM)
    cbs, rep = replay_once(server)
    s = rep["stats"]
    print(f"replay: stats={s}")
    print(f"        latency p50={rep['latency']['p50'] * 1e3:.2f}ms "
          f"p99={rep['latency']['p99'] * 1e3:.2f}ms (virtual)  "
          f"queue p50={rep['queue_depth']['p50']:.1f} "
          f"p99={rep['queue_depth']['p99']:.1f} "
          f"max={rep['queue_depth']['max']:.0f}")
    check_replay(cbs, rep)
    print("exact counts, conservation, deadline contract, finiteness: OK")
    _, rep2 = replay_once(server)
    if rep2 != rep:
        raise AssertionError("replay is not deterministic")
    print("replay determinism: OK")
    if server.device.type == "cuda":
        got = rollout_launches(server)
        print(f"rollout launch contract: {got} block_fwd launches for K in "
              f"(1, 4) ({cfg.num_layers} layers): OK")
    else:
        print("rollout launch contract: not counted on the CPU (the plain "
              "versions launch no kernel)")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, cfg.in_channels) + tuple(cfg.spatial), generator=gen)
    direct = server(x, rollout_steps=ROLLOUT_STEPS).cpu()
    cbs3 = sq.ContinuousBatchingServer(server, queue_limit=4)
    idx = cbs3.submit(x, rollout_steps=ROLLOUT_STEPS)
    cbs3.drain()
    if not torch.equal(cbs3.result(idx).y.cpu(), direct):
        raise AssertionError("the tier changed the rollout answer")
    print("tier-vs-server rollout parity: OK")
    print("serve_replay_smoke: all gates passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
