"""The DP×TP mesh's cases, run on every rank of a spawned mesh
(``launch.mesh.spawn(run_rank, world, job)``), for the CPU tests
(``tests/test_torch_sharding.py``, gloo) and ``chip_smoke.py`` phase 33
(the card). Each case takes full params and a global batch, runs the port
on this rank's shards, and returns numpy results with the full shapes for
the caller to hold against its reference, beside this rank's kernel
launches (``engine.LAUNCHES``) and collectives (``sharding.COLLECTIVES``).

A job is ``{"mesh": (dp, tp), "backend", "device", "cases": [...]}``; a
case is a dict with its ``kind``:

  * "forward": ``apply_fno`` of the global batch ``x`` (this rank's rows
    in the context, the outputs all-gathered) -> ``y``;
  * "grads": the loss's grads on the global batch {x, y}, averaged over
    the batch axes and gathered -> ``loss``, ``grads``;
  * "train": one ``make_train_step(ctx=)`` step (``microbatches``
    optional) -> ``loss``, ``grad_norm``, the gathered new ``params``;
  * "serve": ``FNOServer(ctx=)`` over ``requests`` [(x, K)] -> ``ys``,
    ``plan``;
  * "save": a train step, then the params and AdamW state saved under the
    mesh to ``dir`` at ``step`` -> the gathered ``state``;
  * "restore": ``elastic_restore`` of ``dir`` at ``step`` onto this mesh
    -> the gathered ``state``.

Params come as a numpy tree (``params``) or a seed (``seed``:
``init_fno`` from ``torch.Generator().manual_seed(seed)`` on every rank).
A case's ``cfg`` is an ``FNOConfig``; ``variant`` and ``fno_strategy``
are optional.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import tree
from repro_torch.analysis import launch_lint
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import fno as fno_mod
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import engine
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train import serve_fno_step as sfs
from repro_torch.train import train_step as ts


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t)


def _full_params(case) -> Any:
    if "seed" in case:
        gen = torch.Generator().manual_seed(case["seed"])
        return fno_mod.init_fno(gen, case["cfg"])
    return tree.map(torch.from_numpy, case["params"])


def _state(cfg, ctx, params, opt_state):
    state = {"params": params, "opt": opt_state}
    return state, shd.context_specs(cfg, ctx, state)


def _case(case: Dict[str, Any], mesh) -> Dict[str, Any]:
    cfg = case["cfg"]
    ctx = shd.make_context(cfg, mesh, fno_strategy=case.get("fno_strategy"))
    variant = case.get("variant", "full")
    full = _full_params(case)
    specs = shd.context_specs(cfg, ctx, full)
    params = shd.shard_params(full, specs, mesh)
    dev = mesh.device
    on = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    kind = case["kind"]
    opt = AdamW(lr=constant(case.get("lr", 1e-3)))
    if kind == "forward":
        x = on(case["x"])
        with torch.no_grad(), shd.sharding_context(ctx):
            y = fno_mod.apply_fno(params, cfg, shd.local_rows(ctx, x),
                                  variant=variant)
        return {"y": _np(shd.gather_rows(ctx, y, x.shape[0]))}
    if kind == "grads":
        batch = {k: shd.local_rows(ctx, on(v))
                 for k, v in case["batch"].items()}
        loss_fn = ts.make_loss_fn(cfg, fno_path="fused", fno_variant=variant)
        with shd.sharding_context(ctx):
            loss, grads = ts.value_and_grad(loss_fn, params, batch)
        *flat, loss = shd.mean_over_batch(ctx, tree.leaves(grads) + [loss])
        grads = shd.gather_params(tree.unflatten(grads, flat), specs, mesh)
        return {"loss": float(loss), "grads": tree.map(_np, grads)}
    if kind in ("train", "save"):
        batch = {k: on(v) for k, v in case["batch"].items()}
        step = ts.make_train_step(cfg, opt, fno_path="fused",
                                  fno_variant=variant, ctx=ctx,
                                  microbatches=case.get("microbatches", 1))
        new, state, metrics = step(params, opt.init(params), batch)
        out = {"loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"])}
        if kind == "train":
            out["params"] = tree.map(_np, shd.gather_params(new, specs,
                                                            mesh))
            return out
        st, st_specs = _state(cfg, ctx, new, state)
        Checkpointer(case["dir"]).save(case["step"], st, mesh=mesh,
                                       specs=st_specs)
        out["state"] = tree.map(_np, shd.gather_params(st, st_specs, mesh))
        return out
    if kind == "restore":
        target = {"params": fno_mod.abstract_params(cfg),
                  "opt": AdamW(lr=constant(1e-3)).init(
                      fno_mod.abstract_params(cfg))}
        spec_fn = lambda t: shd.context_specs(cfg, ctx, t)
        st = ft.elastic_restore(Checkpointer(case["dir"]), case["step"],
                                target, mesh, spec_fn)
        st = shd.gather_params(st, spec_fn(target), mesh)
        return {"state": tree.map(_np, st)}
    if kind == "serve":
        srv = sfs.FNOServer(cfg, params, path="fused", variant=variant,
                            max_batch=case.get("max_batch", 8), ctx=ctx)
        ys = [_np(srv(on(x), rollout_steps=k)) for x, k in case["requests"]]
        return {"ys": ys, "plan": srv.collective_plan(),
                "buckets": list(srv.buckets)}
    raise ValueError(f"unknown case kind {kind!r}")


def run_rank(rank: int, world: int, init_method: str,
             job: Dict[str, Any]) -> list:
    """Join the world as `rank`, lay out ``job["mesh"]`` (dp, tp), run
    every case and return, for each, its results with this rank's
    ``launches``, wrapper ``calls`` by kind and ``collectives`` (counted
    from 0 for the case)."""
    dp, tp = job["mesh"]
    mesh = mesh_mod.make_mesh((dp, tp), ("data", "model"),
                              backend=job["backend"],
                              device=job.get("device", "cuda"), rank=rank,
                              world_size=world, init_method=init_method)
    out = []
    # The kernels' entry points count the calls by kind (the kind
    # ``engine.launch_kind`` names): on the card each call is one launch;
    # on the CPU, where the plain versions run and ``engine.LAUNCHES``
    # counts nothing, the calls still show the launch structure.
    with launch_lint.counted_calls() as calls:
        for case in job["cases"]:
            engine.LAUNCHES.clear()
            shd.COLLECTIVES.clear()
            calls.clear()
            res = _case(case, mesh)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            res["launches"] = {f"{k}/{d}": n for (k, d), n in
                               engine.LAUNCHES.items()}
            res["collectives"] = {f"{k}/{s}": n for (k, s), n in
                                  shd.COLLECTIVES.items()}
            res["calls"] = dict(calls)
            out.append(res)
    return out

