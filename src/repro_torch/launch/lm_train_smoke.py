"""The LM zoo trained on the card: the checks and times of
``chip_smoke.py`` phase 37, also run alone and by
``tests/test_torch_lm_train_gpu.py``.

    PYTHONPATH=src python -m repro_torch.launch.lm_train_smoke      # card
    PYTHONPATH=src python -m repro_torch.launch.lm_train_smoke --reduced \\
        --device cpu                                              # rehearsal

Full width (``FULL_WIDTH``: qwen2-1.5b, 1,543,714,304 parameters, and
hymba-1.5b, 1,640,660,800, whose SSD layers run beside sliding-window
attention), random weights from seed 0, train_4k's sequence of 4096
tokens, a global batch of 4 as 2 microbatches of 2, per-layer remat, the
Zipf token stream (``data.tokens``), f32 (TF32 off) and bf16 params, the
attention in ``lm_loss``'s blocks of ``transformer.TRAIN_BLOCK``:

  * the float64 oracle: the same code in float64 at one microbatch of
    1 × 4096 (batch 0's first row). The step-0 loss and every leaf's grad
    at f32 and bf16 against it: f32 within 2e-4, bf16 loss within 2e-2
    and grads within 5e-2 (DESIGN.md §4), a grad scaled by its leaf's
    magnitude, floored at ``LEAF_FLOOR`` of the tree's largest (the key
    bias's grad is zero in exact arithmetic — the softmax is
    shift-invariant — so it holds rounding alone, which a relative bound
    of its own magnitude cannot hold). The bf16 oracle runs on the bf16
    params widened: the same function, so it measures the rounding of the
    computation, not of the weights. hymba, whose SSD layers amplify the
    rounding layer by layer (PERF.md §6), keeps the loss limits; its whole
    gradient is held by direction at f32 (1 − cos(grad, float64's) within
    ``SSD_FACTOR`` × the f32 forward's error against float64, phase 36's
    rule, and never above ``SSD_CAP``) and logged leaf by leaf and layer
    by layer at both dtypes; every leaf's grad is held on the model cut
    to its first layer (``first_layer``: the same weights), within the
    dtype's grad limit or ``SSD_FACTOR`` × the cut's forward error where
    that is larger, never above ``SSD_CAP``. At random init its gradient
    grows ≈ 1000× from the last layer to the first, and the rounding with
    it: at full depth bf16's forward and gradient sit as far from float64
    as from nothing (the reference's bf16 shows the same growth,
    ``tests/lm_precision_witness.py``);
  * training: ``WARM`` steps (the second traced by ``torch.profiler``:
    device-busy ms and the idle share of a step) and ``TIMED`` timed
    steps of ``make_train_step(microbatches=2, remat=True)`` with AdamW
    under the CLI's warmup-cosine schedule: step ms (median, host clock,
    synchronised), tokens/s, peak memory, the model-FLOPs share of the
    card's peak (``roofline.analysis.lm_model_flops`` over the step time
    against ``roofline.hw.peak_flops``; f32 also against the CUDA cores'
    ``PEAK_FFMA_FLOPS``, where TF32-off products run); then the loss of
    batch 0 after the last step must be below step 0's.

Every preset reduced (batch 4 of 32 tokens): one ``make_train_step``
step with microbatches 2 (nemotron-4-340b and arctic-480b with a bf16
gradient accumulator and bf16 AdamW state, their knobs in the reference's
``launch/cells.py``) on the device against the same step on the CPU
(``compare_steps``: loss and grad norm within 2e-4, moments within 2e-4
of their leaf's magnitude (2^-7 for bf16 ones), params within 2e-4 of
theirs where the grad stands above the two devices' rounding and within
2·lr where Adam's first step takes the sign of rounding noise); and the
loss and grads with remat against without (``REMAT_TOL``; on the card the
backward's scatter-adds run on atomics). Any failed check raises. With
``--device cpu`` (``--reduced``: the reduced configs at 64 tokens in place
of the full-width ones) the same code runs as a rehearsal.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import tokens
from repro_torch.launch.lm_smoke import (device_trace, host_ms, require,
                                         sync)
from repro_torch.models import transformer as tf
from repro_torch.models.frontend import fake_frontend_arrays
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import constant, cosine_warmup
from repro_torch.roofline.analysis import lm_model_flops
from repro_torch.roofline.hw import PEAK_FFMA_FLOPS, peak_flops
from repro_torch.train.train_step import (make_loss_fn, make_train_step,
                                          value_and_grad)

FULL_WIDTH = ("qwen2-1.5b", "hymba-1.5b")
SEQ, BATCH, MICROBATCHES = 4096, 4, 2
WARM, TIMED = 2, 5
LR = 1e-4  # peak: hymba at random init does not converge at 1e-3
F32_TOL = 2e-4        # DESIGN.md §4: f32 loss and grads
BF16_LOSS_TOL = 2e-2  # DESIGN.md §4: bf16 forward
BF16_GRAD_TOL = 5e-2  # DESIGN.md §4: bf16 grads
SSD_FACTOR = 3.0      # hymba: times its forward's own error
SSD_CAP = 0.1         # the most an SSD limit scaled so may reach
LEAF_FLOOR = 1e-3     # a leaf's scale: at least this of the tree's largest
REMAT_TOL = 1e-5      # remat on against off, scaled as LEAF_FLOOR says
STEP_TOL = 2e-4       # the reduced step, device against the CPU
BF16_STATE_TOL = 2.0 ** -7  # bf16 moments: two bf16 roundings
NOISE = 1e-5          # |m| below this of the tree's largest: rounding noise
BF16_KNOBS = ("nemotron-4-340b", "arctic-480b")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
REDUCED_B, REDUCED_S = 4, 32


def lm_batch(cfg, index: int, b: int, s: int, device) -> Dict:
    """Batch `index` of the Zipf stream from seed 0 ([b, s] tokens and
    labels), with the frontend's embeddings (hubert's frames, internvl2's
    prefix) drawn from a CPU generator seeded `index`: the same batch on
    every device."""
    batch = tokens.token_batch(0, index, b, s, cfg.vocab_size,
                               device=device)
    extra = fake_frontend_arrays(cfg, b, s,
                                 torch.Generator().manual_seed(index))
    if "inputs_embeds" in extra:
        del batch["tokens"]
    batch.update({k: v.to(device) for k, v in extra.items()})
    return batch


def _cast(params, dtype):
    return tree.map(lambda t: t.to(dtype), params)


def leaf_errors(grads, ref) -> Dict[str, float]:
    """Each leaf's max |g − ref| over its scale: max |ref| of the leaf,
    at least ``LEAF_FLOOR`` of the tree's largest |ref|."""
    top = max(float(r.abs().max()) for r in tree.leaves(ref))
    out = {}
    for p, g, r in zip(tree.paths(ref), tree.leaves(grads),
                       tree.leaves(ref)):
        scale = max(float(r.abs().max()), LEAF_FLOOR * top, 1e-30)
        err = float((g.to(r.dtype) - r).abs().max()) / scale
        out["/".join(map(str, p))] = err
    return out


def _worst(errs: Dict[str, float]):
    path = max(errs, key=errs.get)
    return path, errs[path]


def _by_layer(grads, ref) -> Dict[str, list]:
    """Per layer of the stacked ``layers`` leaves: the largest |ref| and
    the largest error of a leaf over its own scale there."""
    errs, mags = [], []
    for g, r in zip(tree.leaves(grads["layers"]),
                    tree.leaves(ref["layers"])):
        top = r.reshape(r.shape[0], -1).abs().amax(1)
        diff = (g.to(r.dtype) - r).reshape(r.shape[0], -1).abs().amax(1)
        errs.append(diff / torch.clamp(top, min=1e-30))
        mags.append(top)
    return {"error": torch.stack(errs).amax(0).tolist(),
            "magnitude": torch.stack(mags).amax(0).tolist()}


def _cosine(grads, ref) -> float:
    """cos of the angle between two whole gradients (at ref's dtype)."""
    dot = sum((g.to(r.dtype) * r).sum() for g, r in
              zip(tree.leaves(grads), tree.leaves(ref)))
    norm = lambda t: torch.sqrt(sum((x.to(torch.float64) ** 2).sum()
                                    for x in tree.leaves(t)))
    return float(dot / (norm(grads) * norm(ref)))


def _versus_f64(cfg, p, batch) -> tuple:
    """The forward, the loss and the grads at `p` against the same code
    in float64 on `p` widened: (numbers, grads, float64's)."""
    loss_fn = make_loss_fn(cfg, remat=True)
    unread = tf.unread_leaves(cfg, batch)
    fwd = lambda q: tf.forward(q, cfg, batch.get("tokens"),
                               batch.get("inputs_embeds"),
                               batch.get("prefix_embeds"),
                               q_block=tf.TRAIN_BLOCK,
                               kv_block=tf.TRAIN_BLOCK)[0]
    p64 = _cast(p, torch.float64)
    with torch.no_grad():
        ref = fwd(p64)
        err = float((fwd(p).to(ref.dtype) - ref).abs().max())
        res = {"forward_vs_f64": err / float(ref.abs().max())}
        del ref
    loss64, g64 = value_and_grad(loss_fn, p64, batch, unread)
    del p64
    loss, g = value_and_grad(loss_fn, p, batch, unread)
    errs = leaf_errors(g, g64)
    path, worst = _worst(errs)
    top = sorted(errs, key=errs.get, reverse=True)[:4]
    res.update(loss=float(loss), loss_f64=float(loss64),
               loss_vs_f64=abs(float(loss) - float(loss64)) / max(
                   abs(float(loss64)), 1.0),
               grad_vs_f64=worst, grad_worst_leaf=path,
               grad_worst_leaves={k: errs[k] for k in top},
               grad_cosine=_cosine(g, g64))
    return res, g, g64


def first_layer(cfg, params):
    """The model cut to its first layer (the same weights, the same
    attention kind): where an SSD model's rounding is not yet amplified."""
    cut = dataclasses.replace(cfg, num_layers=1, global_layers=tuple(
        i for i in cfg.global_layers if i == 0))
    return cut, dict(params, layers=tree.map(lambda t: t[:1],
                                             params["layers"]))


def oracle_check(cfg, dev: torch.device, p32, seq: int) -> dict:
    """The step-0 loss and grads at f32 and bf16 against the same code in
    float64 on the same params (the bf16 ones widened) at 1 × `seq`
    tokens, with each dtype's forward error against float64 (the rule of
    the module's doc). Raises on a failed check, after every dtype's
    numbers."""
    batch = lm_batch(cfg, 0, 1, seq, dev)
    out, failed = {}, []
    for dt, dtype in DTYPES.items():
        p = p32 if dt == "f32" else _cast(p32, dtype)
        t0 = time.perf_counter()
        res, g, g64 = _versus_f64(cfg, p, batch)
        sync(dev)
        res["seconds"] = time.perf_counter() - t0
        res["loss_tol"] = F32_TOL if dt == "f32" else BF16_LOSS_TOL
        gtol = F32_TOL if dt == "f32" else BF16_GRAD_TOL
        if res["loss_vs_f64"] > res["loss_tol"]:
            failed.append(f"{dt}: step-0 loss against float64 "
                          f"{res['loss_vs_f64']:.3e} > {res['loss_tol']:.3e}")
        if not cfg.has_ssm:
            res["grad_tol"] = gtol
            if res["grad_vs_f64"] > gtol:
                failed.append(f"{dt}: grad of {res['grad_worst_leaf']} "
                              f"against float64 {res['grad_vs_f64']:.3e} > "
                              f"{gtol:.3e}")
            del g, g64
            out[dt] = res
            continue
        # the SSD amplifies the rounding layer by layer (PERF.md §6): the
        # whole model's grads are logged layer by layer; f32's direction
        # is held; every leaf is held on the first layer alone
        res["grad_by_layer"] = _by_layer(g, g64)
        del g, g64
        if dt == "f32":
            res["cosine_tol"] = min(SSD_FACTOR * res["forward_vs_f64"],
                                    SSD_CAP)
            if 1.0 - res["grad_cosine"] > res["cosine_tol"]:
                failed.append(f"{dt}: 1 - cos(grad, float64's) "
                              f"{1.0 - res['grad_cosine']:.3e} > "
                              f"{res['cosine_tol']:.3e}")
        cut_cfg, cut_p = first_layer(cfg, p)
        cut, g, g64 = _versus_f64(cut_cfg, cut_p, batch)
        del g, g64, cut_p
        cut["grad_tol"] = min(max(gtol, SSD_FACTOR * cut["forward_vs_f64"]),
                              SSD_CAP)
        res["first_layer"] = cut
        if cut["grad_vs_f64"] > cut["grad_tol"]:
            failed.append(f"{dt}: first layer alone: grad of "
                          f"{cut['grad_worst_leaf']} against float64 "
                          f"{cut['grad_vs_f64']:.3e} > "
                          f"{cut['grad_tol']:.3e}")
        del p
        out[dt] = res
    require(not failed, f"{cfg.name}: " + "; ".join(failed)
            + f" ({json.dumps(out)})")
    return out


def train_check(cfg, dev: torch.device, params, dt: str, seq: int,
                batch: int) -> dict:
    """WARM + TIMED steps from `params` (the second traced on a card),
    then batch 0's loss again, below step 0's. Returns the numbers."""
    steps = WARM + TIMED
    opt = AdamW(lr=cosine_warmup(LR, min(100, steps // 10 + 1), steps))
    step = make_train_step(cfg, opt, microbatches=MICROBATCHES, remat=True)
    state = opt.init(params)
    data = [lm_batch(cfg, i, batch, seq, dev) for i in range(steps)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, ms, res = [], [], {}
    for i in range(steps):
        def one():
            nonlocal params, state
            params, state, m = step(params, state, data[i])
            losses.append(float(m["loss"]))
            require(np.isfinite(losses[-1]) and np.isfinite(float(
                m["grad_norm"])), f"{cfg.name} {dt}: a non-finite step")
        if i == 1 and dev.type == "cuda":
            res["busy_ms"], res["top_kernels"] = device_trace(one, 1)
            continue
        _, t = host_ms(one, dev)
        if i >= WARM:
            ms.append(t)
    with torch.no_grad():
        after = float(tf.lm_loss(params, cfg, data[0]))
    require(after < losses[0], f"{cfg.name} {dt}: batch 0's loss "
            f"{after:.4f} after {steps} steps is not below step 0's "
            f"{losses[0]:.4f} (the steps' losses {losses})")
    step_ms = statistics.median(ms)
    flops = lm_model_flops(cfg, "train", seq, batch)
    res.update(step_ms_median=step_ms, step_ms=ms,
               tokens_per_s=batch * seq * 1e3 / step_ms,
               model_flops=flops,
               mfu=flops / (step_ms / 1e3) / peak_flops(dt),
               losses=losses, loss_after=after)
    if dt == "f32":  # TF32 off: cuBLAS's f32 products on the CUDA cores
        res["mfu_ffma"] = flops / (step_ms / 1e3) / PEAK_FFMA_FLOPS
    if dev.type == "cuda":
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        res["idle_share"] = 1.0 - res["busy_ms"] / step_ms
    return res


def full_width_check(cfg, dev: torch.device, seq: int = SEQ,
                     batch: int = BATCH, log: Callable = print) -> dict:
    """The oracle, then training at f32 and bf16, of one model; logs each
    part's seconds as it ends."""
    gen = torch.Generator(dev).manual_seed(0)
    p32 = tf.init_lm(gen, cfg, torch.float32, dev)
    t0 = time.perf_counter()
    out = {"oracle": oracle_check(cfg, dev, p32, seq)}
    out["seconds"] = {"oracle": time.perf_counter() - t0}
    log(f"  {cfg.name} float64 oracle: {out['seconds']['oracle']:.1f} s")
    for dt, dtype in DTYPES.items():
        t0 = time.perf_counter()
        params = p32 if dt == "f32" else _cast(p32, dtype)
        out[dt] = train_check(cfg, dev, params, dt, seq, batch)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["seconds"][dt] = time.perf_counter() - t0
        log(f"  {cfg.name} {dt} training: {out['seconds'][dt]:.1f} s")
    return out


def compare_steps(ours, ref, lr: float = LR) -> dict:
    """One train step's (params, opt_state, metrics) against another's
    (the rule of the module's doc); raises on a failed check. Returns the
    worst errors."""
    (p, st, m), (rp, rst, rm) = ours, ref
    f = lambda t: t.detach().float().cpu()
    worst = {}
    for k in ("loss", "grad_norm"):
        err = abs(float(m[k]) - float(rm[k])) / abs(float(rm[k]))
        require(err <= STEP_TOL, f"{k} {float(m[k])} against "
                f"{float(rm[k])}")
        worst[k] = err
    require(int(m["step"]) == int(rm["step"]), "step")
    bf16 = tree.leaves(rst["m"])[0].dtype == torch.bfloat16
    tol = BF16_STATE_TOL if bf16 else STEP_TOL
    for name in ("m", "v"):
        for path, a, b in zip(tree.paths(rst[name]),
                              tree.leaves(st[name]), tree.leaves(rst[name])):
            b = f(b)
            err = float((f(a) - b).abs().max()) / max(float(
                b.abs().max()), 1e-30)
            require(err <= tol, f"{name} {path}: {err:.3e} > {tol:.3e}")
            worst[name] = max(worst.get(name, 0.0), err)
    floor = NOISE * max(float(f(x).abs().max())
                        for x in tree.leaves(rst["m"]))
    for path, a, b, mref in zip(tree.paths(rp), tree.leaves(p),
                                tree.leaves(rp), tree.leaves(rst["m"])):
        a, b, sure = f(a), f(b), f(mref).abs() > floor
        diff = (a - b).abs()
        if bool(sure.any()):
            err = float(diff[sure].max()) / float(b.abs().max())
            require(err <= STEP_TOL, f"params {path}: {err:.3e}")
            worst["params"] = max(worst.get("params", 0.0), err)
        require(float(diff.max()) <= 2 * lr, f"params {path}: beyond 2 lr")
    return worst


def reduced_check(arch: str, dev: torch.device) -> dict:
    """One preset, reduced: a microbatched step on `dev` against the CPU,
    and remat on against off on `dev`."""
    cfg = get_config(arch, reduced=True)
    knobs = "bfloat16" if arch in BF16_KNOBS else None
    p_cpu = tf.init_lm(torch.Generator().manual_seed(0), cfg, torch.float32)
    b_cpu = lm_batch(cfg, 0, REDUCED_B, REDUCED_S, "cpu")
    steps = []
    for d in (dev, torch.device("cpu")):
        opt = AdamW(lr=constant(LR), state_dtype=knobs)
        step = make_train_step(cfg, opt, microbatches=MICROBATCHES,
                               grad_acc_dtype=knobs)
        params = tree.map(lambda t: t.to(d), p_cpu)
        batch = {k: v.to(d) for k, v in b_cpu.items()}
        steps.append(step(params, opt.init(params), batch))
    out = {"vs_cpu": compare_steps(steps[0], steps[1])}
    params = tree.map(lambda t: t.to(dev), p_cpu)
    batch = {k: v.to(dev) for k, v in b_cpu.items()}
    unread = tf.unread_leaves(cfg, batch)
    l0, g0 = value_and_grad(make_loss_fn(cfg), params, batch, unread)
    l1, g1 = value_and_grad(make_loss_fn(cfg, remat=True), params, batch,
                            unread)
    errs = leaf_errors(g1, g0)
    path, worst = _worst(errs)
    loss_err = abs(float(l1) - float(l0)) / abs(float(l0))
    require(loss_err <= REMAT_TOL and worst <= REMAT_TOL,
            f"{arch}: remat against no remat: loss {loss_err:.3e}, grad of "
            f"{path} {worst:.3e} > {REMAT_TOL}")
    out["remat"] = {"loss": loss_err, "grad": worst}
    return out


def run(dev: torch.device, archs=FULL_WIDTH, reduced_archs=ARCH_IDS,
        reduced: bool = False, log: Callable = print,
        card: Optional[str] = None) -> dict:
    """Every check; logs a line a model and dtype. `reduced` runs the
    full-width checks on the reduced configs at 64 tokens (a CPU
    rehearsal)."""
    where = card or (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    seq = 64 if reduced else SEQ
    out = {"full_width": {}, "reduced": {}}
    for arch in archs:
        cfg = get_config(arch, reduced=reduced)
        res = full_width_check(cfg, dev, seq=seq, log=log)
        out["full_width"][arch] = res
        for dt in DTYPES:
            o, r = res["oracle"][dt], res[dt]
            log(f"  {arch} {dt} B={BATCH} seq {seq} ({where}): step "
                f"{r['step_ms_median']:.2f} ms (median of {TIMED}), "
                f"{r['tokens_per_s']:.1f} tokens/s, model-FLOPs share "
                f"{r['mfu']:.4f}, busy "
                f"{r.get('busy_ms', float('nan')):.2f} ms (idle "
                f"{r.get('idle_share', float('nan')):.4f}), peak "
                f"{r.get('peak_memory_bytes', 0) / 2**30:.2f} GiB; loss "
                f"{r['losses'][0]:.4f} -> {r['loss_after']:.4f}; vs "
                f"float64: loss {o['loss_vs_f64']:.3e}, grad "
                f"{o['grad_vs_f64']:.3e} ({o['grad_worst_leaf']}), 1 - cos "
                f"{1 - o['grad_cosine']:.3e}, forward "
                f"{o['forward_vs_f64']:.3e}" + (
                    "; first layer alone: grad {:.3e} ({}) of {:.3e}, "
                    "forward {:.3e}".format(
                        o["first_layer"]["grad_vs_f64"],
                        o["first_layer"]["grad_worst_leaf"],
                        o["first_layer"]["grad_tol"],
                        o["first_layer"]["forward_vs_f64"])
                    if "first_layer" in o else ""))
        log(f"  {arch} seconds {json.dumps(res['seconds'])}")
    for arch in reduced_archs:
        out["reduced"][arch] = reduced_check(arch, dev)
    log(f"  reduced presets: {json.dumps(out['reduced'])}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs at 64 tokens in place of the "
                         "full-width models (a CPU rehearsal)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    card = None
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("lm_train_smoke runs on the GPU by default "
                               "and no CUDA device is available; pass "
                               "--device cpu --reduced for the CPU "
                               "rehearsal")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
            else None
        print(card or f"nvidia-smi failed: {smi.stderr.strip()}")
    t0 = time.perf_counter()
    out = run(dev, reduced=args.reduced, card=card)
    print(json.dumps(out))
    print(f"lm_train_smoke: all checks passed in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
