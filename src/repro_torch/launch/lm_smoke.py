"""The LM zoo served on the card: the checks and times of ``chip_smoke.py``
phase 36, also run alone and by ``tests/test_torch_lm_gpu.py``.

    PYTHONPATH=src python -m repro_torch.launch.lm_smoke           # card
    PYTHONPATH=src python -m repro_torch.launch.lm_smoke --reduced \\
        --device cpu                                               # rehearsal

Full width (``FULL_WIDTH``: qwen2-1.5b, and hymba-1.5b, whose sliding-
window layers read ring caches and whose SSD layers run beside them),
random weights from seed 0, batch 4, a 2048-token prompt, f32 (TF32 off)
and bf16 (the f32 weights cast):

  * decode consistency: the prompt's first 1536 tokens prefilled, the next
    32 decoded teacher-forced, each decoded row against ``forward``'s row
    (over the whole prompt) at the same position, in float64 (the same
    code: ``models.layers.acc_dtype``; within 1e-6, scaled), f32 and bf16.
    f32: decode's error against the float64 forward at most 3× the f32
    forward's own, and, for models without SSD layers, within rtol = atol
    = 2e-3, the reference's bound in ``tests/test_archs_smoke.py``
    (``F32_TOL`` says why hymba is held to the oracle alone); bf16: its
    gap at most 3× the gap between bf16's and f32's forward. The prefill's
    length is a multiple of the attention's blocks, which halve until they
    divide the sequence (an odd prefill would run blocks of one token);
  * the served path: ``make_prefill_step`` over the whole prompt, then 32
    greedy ``make_decode_step`` steps: prefill ms and decode ms a token on
    the host clock around synchronised work, tokens/s, peak memory, the
    decode's device-busy ms a step from ``torch.profiler`` over 4 more
    steps (its idle share against the untraced step), every token in the
    vocabulary and every logit finite; the decode bound: the params' and
    the cache's bytes, each read once a step, over ``roofline.hw.HBM_BW``;
  * ``multihead_attention`` at the model's prefill shape (hymba: its
    window) against a dense masked softmax (2e-4, scaled), timed beside
    ``F.scaled_dot_product_attention`` on the same inputs, a yardstick
    only (no library attention is on the path).

Every preset reduced (MoE at capacity_factor 8): prefill of 47 tokens and
one decode step against ``forward``'s last row (2e-3), three greedy
steps in the vocabulary; hubert (encoder-only) through
``make_encoder_step``. Any failed check raises. With ``--device cpu``
(``--reduced``: the reduced configs in place of the full-width ones, and a
short prompt) the same code runs as a rehearsal; its times are CPU times.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.frontend import fake_frontend_arrays
from repro_torch.roofline.hw import HBM_BW
from repro_torch.train import serve_step

FULL_WIDTH = ("qwen2-1.5b", "hymba-1.5b")
BATCH, PROMPT, PREFIX, CHECKED, NEW, PROFILED = 4, 2048, 1536, 32, 32, 4
# Decode against forward in f32: rtol = atol = 2e-3, the reference's bound
# (tests/test_archs_smoke.py:67-70, reduced, 48 tokens). At full width and
# 2048 tokens it holds for attention-only models; hymba's SSD layers
# amplify f32 rounding past it in its forward and its decode alike, so
# there the check is the float64 oracle's: decode's error against the same
# code run in float64 at most BF16_FACTOR x the f32 forward's own (applied
# to every model).
F32_TOL = 2e-3
BF16_FACTOR = 3.0   # bf16's decode gap against bf16's own gap to f32
F64_TOL = 1e-6      # float64 decode against float64 forward, scaled
ATTN_TOL = 2e-4     # DESIGN.md §4, scaled by max(1, max|ref|)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn: Callable, dev: torch.device):
    """(fn's result, ms on the host clock around synchronised work)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def _device_ms(fn: Callable, dev: torch.device, iters: int = 3) -> float:
    """ms a call of fn after a warm one: CUDA events on the card, the host
    clock elsewhere."""
    fn()
    if dev.type != "cuda":
        return host_ms(lambda: [fn() for _ in range(iters)], dev)[1] / iters
    torch.cuda.synchronize(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def _scaled_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    y, ref = y.float(), ref.float()
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def tree_bytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


def decode_bound_ms(params, cache) -> float:
    """The least time of a decode step: every param and every cache
    tensor read once (the attention reads the whole cache, the SSD its
    state) over the card's memory rate. The token's writes are a slot."""
    return 1e3 * (tree_bytes(params) + tree_bytes(cache["segments"])) / HBM_BW


def dense_attention(q, k, v, *, causal: bool, window: int = 0
                    ) -> torch.Tensor:
    """The plain version: one masked softmax over every key, in f32, the
    KV heads repeated to the query heads (head h reads KV head h // G)."""
    b, sq, hq, dh = q.shape
    g = hq // k.shape[2]
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * dh ** -0.5
    pos = torch.arange(sq, device=q.device)
    mask = torch.ones(sq, k.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vf)


def attention_check(cfg, dev: torch.device, batch: int, seq: int) -> dict:
    """``multihead_attention`` at the model's prefill shape (f32; a
    windowed layer where the model has one) against ``dense_attention``,
    and both beside ``F.scaled_dot_product_attention``'s time."""
    gen = torch.Generator(dev).manual_seed(1)
    window = 0 if all(tf.layer_flags(cfg)) else cfg.window_size
    mk = lambda h: torch.randn((batch, seq, h, cfg.head_dim), generator=gen,
                               device=dev)
    q, k, v = mk(cfg.num_heads), mk(cfg.num_kv_heads), mk(cfg.num_kv_heads)
    run = lambda: attn.multihead_attention(q, k, v, causal=True,
                                           window=window)
    err = _scaled_err(run(), dense_attention(q, k, v, causal=True,
                                             window=window))
    require(err <= ATTN_TOL, f"{cfg.name}: multihead_attention against "
            f"the dense plain version: {err:.3e} > {ATTN_TOL}")
    g = cfg.num_heads // cfg.num_kv_heads
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    pos = torch.arange(seq, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                            - window) if window else None
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=mask is None)
    return {"q": list(q.shape), "kv": list(k.shape), "window": window,
            "scaled_err": err, "ms": _device_ms(run, dev),
            "sdpa_ms": _device_ms(sdpa, dev)}


def device_trace(step: Callable, steps: int, top: int = 6) -> tuple:
    """(device-busy ms a step, the `top` device kernels by ms a step) of
    `step` from a ``torch.profiler`` trace of `steps` steps (a decode step
    here, a training step in ``lm_train_smoke``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity alone: the host's op events of a step number in the
    # thousands, and reading them back costs seconds
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in events)
    require(us > 0, "the trace holds no device events")
    rows = [{"name": e.key[:60],
             "ms": e.self_device_time_total / 1e3 / steps,
             "calls": e.count / steps}
            for e in sorted(events, key=lambda e: e.self_device_time_total,
                            reverse=True)[:top]]
    return us / 1e3 / steps, rows


def _consistency(params, cfg, tokens: torch.Tensor, prefix: int,
                 checked: int) -> tuple:
    """(``forward``'s logits over the whole prompt at positions prefix …
    prefix + checked - 1, the logits of `checked` teacher-forced decode
    steps at the same positions after a prefill of the first `prefix`
    tokens), as float64. The model is causal, so a row of the longer
    forward depends on the tokens up to its position alone."""
    logits, _ = tf.forward(params, cfg, tokens)
    rows = logits[:, prefix:prefix + checked].to(torch.float64)
    del logits
    _, cache = tf.prefill(params, cfg, tokens[:, :prefix],
                          max_len=prefix + checked)
    dec = []
    for t in range(prefix, prefix + checked):
        lg, cache = tf.decode_step(params, cfg, cache, tokens[:, t])
        dec.append(lg.to(torch.float64))
    return rows, torch.stack(dec, dim=1)


def _served(params, cfg, tokens: torch.Tensor, new: int,
            dev: torch.device) -> dict:
    """The served path's numbers: prefill of the prompt, `new` greedy
    steps, then PROFILED steps traced on the card."""
    s = tokens.shape[1]
    prefill = serve_step.make_prefill_step(cfg, max_len=s + new + PROFILED)
    step = serve_step.make_decode_step(cfg)
    prefill(params, {"tokens": tokens})  # warm (cuBLAS plans at 2048)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    (last, cache), prefill_ms = host_ms(
        lambda: prefill(params, {"tokens": tokens}), dev)
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    finite = torch.isfinite(last).all()
    out = [tok]

    def generate():
        nonlocal tok, cache, finite
        for _ in range(new):
            tok, lg, cache = step(params, cache, tok)
            finite = finite & torch.isfinite(lg).all()
            out.append(tok)

    _, decode_total = host_ms(generate, dev)
    gen_tokens = torch.stack(out, dim=1)
    require(bool(finite), f"{cfg.name}: a non-finite logit")
    require(int(gen_tokens.min()) >= 0
            and int(gen_tokens.max()) < cfg.vocab_size,
            f"{cfg.name}: a generated token outside the vocabulary")
    decode_ms = decode_total / new
    res = {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "tokens_per_s": tokens.shape[0] * 1e3 / decode_ms,
           "decode_bound_ms": decode_bound_ms(params, cache),
           "tokens_row0": gen_tokens[0].tolist()}
    if dev.type == "cuda":
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)

        def one():
            nonlocal tok, cache
            tok, _, cache = step(params, cache, tok)
        busy, res["decode_top_kernels"] = device_trace(one, PROFILED)
        res["decode_busy_ms_per_token"] = busy
        res["decode_idle_share"] = 1.0 - busy / decode_ms
    return res


def serve_check(cfg, dev: torch.device, batch: int = BATCH,
                prompt: int = PROMPT, prefix: int = PREFIX,
                checked: int = CHECKED, new: int = NEW) -> Dict[str, dict]:
    """Decode consistency and the served path's numbers of one model, f32
    and bf16, against the same code in float64 (see the module's doc).
    Raises on a failed check."""
    gen = torch.Generator(dev).manual_seed(0)
    p32 = tf.init_lm(gen, cfg, torch.float32, dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                           device=dev, dtype=torch.int32)
    out, rows = {}, {}
    with torch.inference_mode():
        for dt in ("f64",) + tuple(DTYPES):
            t0 = time.perf_counter()
            dtype = DTYPES.get(dt, torch.float64)
            params = p32 if dt == "f32" else tree.map(lambda t: t.to(dtype),
                                                      p32)
            rows[dt], dec = _consistency(params, cfg, tokens, prefix,
                                         checked)
            require(bool(torch.isfinite(rows[dt]).all()
                         and torch.isfinite(dec).all()),
                    f"{cfg.name} {dt}: a non-finite logit")
            gap = float((dec - rows[dt]).abs().max())
            res = {"decode_vs_forward_max_abs": gap}
            if dt == "f64":  # the decode path equals the forward path
                scale = max(float(rows[dt].abs().max()), 1.0)
                require(gap <= F64_TOL * scale,
                        f"{cfg.name} f64: decode against forward "
                        f"{gap:.4g} > {F64_TOL} x {scale:.4g}")
                out[dt] = dict(res, seconds=time.perf_counter() - t0)
                rows64 = rows[dt]
                del params, dec
                continue
            if dt == "f32":
                excess = float(((dec - rows[dt]).abs()
                                - F32_TOL * (1 + rows[dt].abs())).max())
                res.update(
                    allclose_excess=excess,
                    forward_vs_f64_max_abs=float(
                        (rows[dt] - rows64).abs().max()),
                    decode_vs_f64_max_abs=float((dec - rows64).abs().max()))
                require(res["decode_vs_f64_max_abs"]
                        <= BF16_FACTOR * res["forward_vs_f64_max_abs"],
                        f"{cfg.name} f32: decode against the float64 "
                        f"forward {res['decode_vs_f64_max_abs']:.4g} > "
                        f"{BF16_FACTOR}x the f32 forward's "
                        f"{res['forward_vs_f64_max_abs']:.4g}")
                # the reference's bound, where no SSD layer amplifies the
                # rounding past it (F32_TOL)
                require(excess <= 0 or cfg.has_ssm,
                        f"{cfg.name} f32: decode against forward beyond "
                        f"rtol = atol = {F32_TOL} (excess {excess:.4g})")
            else:
                ref_gap = float((rows[dt] - rows["f32"]).abs().max())
                res["bf16_vs_f32_forward_max_abs"] = ref_gap
                require(gap <= BF16_FACTOR * ref_gap,
                        f"{cfg.name} bf16: decode gap {gap:.4g} > "
                        f"{BF16_FACTOR}x the bf16/f32 gap {ref_gap:.4g}")
            del dec
            t1 = time.perf_counter()
            res.update(_served(params, cfg, tokens, new, dev))
            res["param_bytes"] = tree_bytes(params)
            res["seconds"] = {"checks": t1 - t0,
                              "served": time.perf_counter() - t1}
            out[dt] = res
            del params
    return out


def reduced_check(arch: str, dev: torch.device) -> dict:
    """One preset, reduced: decode consistency against ``forward`` (or
    hubert's encoder step), three greedy steps in the vocabulary."""
    cfg = get_config(arch, reduced=True)
    if cfg.num_experts:  # no capacity drops that differ across lengths
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    gen = torch.Generator(dev).manual_seed(0)
    params = tf.init_lm(gen, cfg, torch.float32, dev)
    b, s = 2, 48
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev, dtype=torch.int32)
    extra = fake_frontend_arrays(cfg, b, s, gen, device=dev)
    with torch.inference_mode():
        if not cfg.is_decoder:
            logits = serve_step.make_encoder_step(cfg)(params, extra)
            ref, _ = tf.forward(params, cfg, **extra)
            require(tuple(logits.shape) == (b, s, cfg.vocab_size)
                    and bool(torch.isfinite(logits).all())
                    and torch.equal(logits, ref),
                    f"{arch}: the encoder step")
            return {"encoder_logits": list(logits.shape)}
        full, _ = tf.forward(params, cfg, tokens, **extra)
        max_len = s + 4 + cfg.num_prefix_embeds
        _, cache = tf.prefill(params, cfg, tokens[:, :s - 1], **extra,
                              max_len=max_len)
        step = serve_step.make_decode_step(cfg)
        tok, lg, cache = step(params, cache, tokens[:, s - 1])
        diff = (lg - full[:, -1]).abs()
        excess = float((diff - F32_TOL * (1 + full[:, -1].abs())).max())
        require(excess <= 0, f"{arch}: decode against forward beyond "
                f"rtol = atol = {F32_TOL}")
        toks = [tok]
        for _ in range(3):
            tok, lg, cache = step(params, cache, tok)
            toks.append(tok)
        t = torch.stack(toks)
        require(bool(torch.isfinite(lg).all()) and int(t.min()) >= 0
                and int(t.max()) < cfg.vocab_size,
                f"{arch}: greedy steps")
        require(int(cache["len"]) == s + 3 + cfg.num_prefix_embeds,
                f"{arch}: cache len")
    return {"decode_vs_forward_max_abs": float(diff.max()),
            "allclose_excess": excess}


def run(dev: torch.device, archs=FULL_WIDTH, reduced_archs=ARCH_IDS,
        reduced: bool = False, log: Callable = print,
        card: Optional[str] = None) -> dict:
    """Every check; logs a line a model and dtype. `reduced` runs the
    full-width checks on the reduced configs with a short prompt (a CPU
    rehearsal)."""
    where = card or (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    sizes = (dict(batch=2, prompt=64, prefix=32, checked=8, new=4)
             if reduced else dict(batch=BATCH, prompt=PROMPT, prefix=PREFIX,
                                  checked=CHECKED, new=NEW))
    out = {"full_width": {}, "attention": {}, "reduced": {}}
    for arch in archs:
        cfg = get_config(arch, reduced=reduced)
        t0 = time.perf_counter()
        res = serve_check(cfg, dev, **sizes)
        out["full_width"][arch] = res
        log(f"  {arch} f64 (the oracle): decode vs forward max |d| "
            f"{res['f64']['decode_vs_forward_max_abs']:.3e}, "
            f"{res['f64']['seconds']:.1f} s")
        for dt, r in res.items():
            if dt == "f64":
                continue
            log(f"  {arch} {dt} B={sizes['batch']} prompt {sizes['prompt']}"
                f" ({where}): prefill {r['prefill_ms']:.2f} ms, decode "
                f"{r['decode_ms_per_token']:.4f} ms/token "
                f"({r['tokens_per_s']:.1f} tokens/s), bound "
                f"{r['decode_bound_ms']:.4f} ms, busy "
                f"{r.get('decode_busy_ms_per_token', float('nan')):.4f} ms "
                f"(idle {r.get('decode_idle_share', float('nan')):.4f}), "
                f"peak {r.get('peak_memory_bytes', 0) / 2**30:.2f} GiB; "
                f"decode vs forward max |d| "
                f"{r['decode_vs_forward_max_abs']:.3e}; seconds "
                f"{json.dumps(r['seconds'])}")
        a = attention_check(cfg, dev, sizes["batch"], sizes["prompt"])
        out["attention"][arch] = a
        log(f"  {arch} attention q {a['q']} kv {a['kv']} window "
            f"{a['window']} ({where}): scaled_err {a['scaled_err']:.3e}, "
            f"{a['ms']:.4f} ms, F.scaled_dot_product_attention "
            f"{a['sdpa_ms']:.4f} ms (yardstick); "
            f"{time.perf_counter() - t0:.1f} s")
    for arch in reduced_archs:
        out["reduced"][arch] = reduced_check(arch, dev)
    log(f"  reduced presets: {json.dumps(out['reduced'])}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs and a short prompt in place "
                         "of the full-width models (a CPU rehearsal)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("lm_smoke runs on the GPU by default and no "
                               "CUDA device is available; pass --device cpu "
                               "--reduced for the CPU rehearsal")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = None
    if dev.type == "cuda":  # the card's name and power limit
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
            else None
        print(card or f"nvidia-smi failed: {smi.stderr.strip()}")
    t0 = time.perf_counter()
    out = run(dev, reduced=args.reduced, card=card)
    print(json.dumps(out))
    print(f"lm_smoke: all checks passed in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
