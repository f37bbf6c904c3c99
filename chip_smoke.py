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
     for the wgrad also the staged yardstick ``wgrad_staged`` (rfftn of x
     and gz, truncation, einsum, matmul, sum; queued);
  8. kernel vs plain, partial launches — the row kernels (rdft, cdft with
     the forward and the padded-inverse operand, irdft; at rank 3 rdft and
     irdft are ``dft.outer_rdft`` / ``outer_irdft`` with the per-axis
     factors, held against the reference's Kronecker-combined product) and
     the fused core against their plain versions at phase 2's odd extents
     (ranks 2–3),
     fno2d full width at B=1 and B=8 and fno3d full width (hidden 32, 64³,
     modes 16³) at B=1, f32 ≤ 2e-4 and bf16 ≤ 2e-2 of the f32 plain
     version; the core at B=9 (per-mode W: two sample groups; shared W)
     at the odd extents; and the block kernel without wb (the bare
     spectral layer);
  9. serve partial — ``FNOServer(variant="partial")`` for fno2d at full
     width with phase 3's 12 requests: finite, equal to the staged path and
     to the full variant within the tolerances, exactly num_layers ×
     Σ(chunks × K) launches of each of rdft, core and irdft and no
     block_fwd (phase 21 serves fno3d through the partial path);
  10. train partial — phase 6 with ``fno_variant="partial"``: num_layers
     launches of each of rdft, core, irdft, gz_recompute, dx_adjoint and
     wgrad per step;
  11. times, partial — phase 4's serve window (the same seeded sizes) and
     phase 7's training window on the partial variant; CUDA events at fno2d
     B=8 for each partial launch beside its plain version, its one-call
     ``torch.fft`` yardstick (none for the core) and its bound (every
     launch queued behind a device spin, as ``time_ms`` says; cdft, icdft
     and the core also host-paced, as timed before; the core's log line
     has the weight bytes its plan reads a launch), fno3d's
     outer launches at B=1, and the whole served block forward, partial
     against full against the staged torch.fft block;
  12. per-mode kernels vs plain — weights [O,H,k_1..k_R]: the block
     kernel's forward, gz-recompute and dx-adjoint modes (dx reads the
     [H,O,K] swap as a view), the per-mode wgrad and the core, against
     their plain versions at phase 2's odd extents (ranks 1–3; the bare
     spectral layer at rank 1) and at fno2d-large full width (hidden 128,
     128×128, modes 32×32) B=8, f32 ≤ 2e-4 and bf16 ≤ 2e-2 of the f32
     plain chain;
  13. serve fno2d-large — ``FNOServer`` at full width (clusters of 16,
     134,350,977 parameters), max_batch 8, in both variants: phase 3's 12
     requests against the staged path with exact launch counts (full:
     block_fwd; partial: rdft, core, irdft), then a sustained window of
     LARGE_WINDOW single-step requests of seeded sizes 1–8 per precision
     and variant;
  14. train fno2d-large — phase 6 and phase 7's window at full width,
     Darcy batch 8, both variants, f32 and bf16: step-0 loss, grad norm and
     every leaf against the staged path, exact launches per step, the loss
     falls over 20 steps, 30 timed steps and peak device memory;
  15. times, per-mode — CUDA events at fno2d-large B=8 for each per-mode
     launch beside its plain version and its bound (W counted once at
     2·O·H·ΠK; the wgrad also beside ``wgrad_staged``; the core queued,
     its log line with the weight bytes its plan reads a launch, its
     clusters, how many the card runs at once and the waves), the row
     kernels at hidden 128 (checked
     against the f32
     plain version, timed queued beside it, ``torch.fft`` and the bound)
     and the served block forward
     in both variants; and the bare spectral layer (the rank-1 partial
     forward) at fno1d full width B=8, with its launches on one served
     fno1d partial request;
  16. kernel vs plain, spectral-only and cgemm — the bare layer's
     launches (forward; dx through the adjoint bundle, counted
     spectral_dx; the bypass-free wgrad, spectral_wgrad) at phase 2's odd
     extents (ranks 1–3, shared and per-mode W), fno2d full width B=8 and
     fno2d-large full width B=8, and ``ops.cgemm`` at the reference's test
     cases and the FNO's CGEMM shapes (64,64,8192) and (128,128,8192),
     f32 ≤ 2e-4 and bf16 ≤ 2e-2 of the f32 plain version;
  17. serve spectral-only — ``FNOServer`` for fno2d at full width with
     ``fuse_block=False`` (the paper's fusion: the kernels fuse each
     spectral conv, the bypass, bias and GELU are PyTorch ops), both
     variants: phase 3's 12 requests against the staged path with exact
     launch counts (full: spectral_fwd; partial: rdft, core, irdft; no
     block_fwd), then SPECTRAL_WINDOW single-step requests per precision
     and variant beside phase 4's whole-block window;
  18. train spectral-only — phase 6 and phase 7's window with
     ``fuse_block=False``: fno2d (Darcy batch 8, both variants, f32 and
     bf16) and fno2d-large (f32, both variants): step-0 parity of every
     leaf, exactly num_layers launches of each of spectral_fwd (or rdft,
     core, irdft), spectral_dx and spectral_wgrad per step and none of
     the whole-block kinds, the loss falls over 20 steps, 30 timed steps
     and peak device memory beside the whole-block windows;
  19. times, spectral-only and cgemm — CUDA events at fno2d B=8 and
     fno2d-large B=8 for spectral_fwd, spectral_dx and spectral_wgrad
     beside their plain versions, the staged torch.fft layer (a
     yardstick) and their bounds, and ``cgemm`` at (64,64,8192) and
     (128,128,8192) beside its plain version, ``torch.matmul`` on
     complex64 (f32) and its bound;
  20. fno3d kernels vs plain, and the linear block — the rank-3 preset at
     full width (hidden 32, 4 layers, 64³, modes 16³: clusters of 16, the
     block kernel's chains 2 s_1 rows a chunk), B=1 and B=8: the block forward,
     gz recompute, dx adjoint, wgrad, the bare forward and dx and the
     bypass-free wgrad against their plain versions (f32 ≤ 2e-4, bf16
     ≤ 2e-2 of the f32 plain chain), with the card's cluster occupancy
     and the waves B=8 takes; the partial variant's launches (rdft, cdft,
     icdft, irdft, core) at B=8 likewise; then the linear (TP-partial)
     block — wb, a
     bias, no activation, f32 out — at the odd extents (ranks 1–3), fno2d
     and fno3d full width, and ``ops.fno_block_nd(act="linear")`` driven
     forward and backward once at fno2d and fno3d B=8 per precision with
     the counts set to 0: one block_linear, one dx_adjoint, one wgrad,
     no gz_recompute, and equal to the staged path;
  21. serve fno3d — ``FNOServer`` at full width, max_batch 8, in the four
     fused designs (whole-block and spectral-only, full and partial
     variant): phase 3's 12 requests against the staged path with exact
     launch counts, then FNO3D_WINDOW single-step requests per precision
     for each of the four designs;
  22. train fno3d — phase 6 and phase 7's window at full width, diffusion
     batch 8, in the four fused designs, f32 and bf16: step-0 parity of
     every leaf, exactly num_layers launches of each kind per step, the
     loss falls over 20 steps, 30 timed steps and peak device memory;
  23. times, fno3d — CUDA events at fno3d B=8 for every launch of the
     four designs (block forward, gz, dx, wgrad; bare forward, dx and
     wgrad; rdft, core and irdft) and the linear block beside their plain
     versions (rdft and irdft queued), the row launches' torch.fft call
     or, for a fused launch,
     the staged torch.fft block or layer (a yardstick), and their bounds;
     the wgrads also beside ``wgrad_staged`` (with and without the bypass)
     and the wgrad at B=1 and B=7 (one wave of clusters of 16);
  24. fused ends vs plain — the block kernel's ends mode (the lifting MLP
     folded into the first block, the projection MLP into the last; one
     launch with both for a 1-layer model) against its plain version at
     fno2d and fno3d full width B=8 and fno2d-large (per-mode W) B=1 and
     B=8: lift, proj and both, f32 ≤ 2e-4, bf16 ≤ 2e-2 of the f32 plain
     version;
  25. serve with the fused ends — ``FNOServer`` for fno2d and fno3d at
     full width with ``fuse_ends``: phase 3's 12 requests against the
     staged model without the ends, exactly 2 block_ends and
     num_layers - 2 block_fwd launches per forward, then a sustained
     window per precision (ENDS_SERVED requests);
  26. train with the fused ends — phase 6 and phase 7's window for fno2d
     (Darcy) and fno3d (diffusion), batch 8, f32 and bf16: step-0 loss,
     grad norm and every leaf against the staged model without the
     ends, per step 2 block_ends and num_layers - 2 of each of the
     whole-block kinds (the end blocks' backward is staged PyTorch and
     launches no kernel), the loss falls over 20 steps, 30 timed steps
     and peak device memory beside the whole-block windows;
  27. times, fused ends — CUDA events at fno2d and fno3d B=8 for the
     lift and the projection launch (and both in one) beside their plain
     versions, the staged end MLP with the torch.fft block (a
     yardstick) and their bounds with the MLPs' bytes and operations;
  28. a shape the tensor-core chain cannot hold everywhere — fno2d's
     model at 256×256 with modes 32×32 (hidden 64; its wgrad's resident
     factors do not fit, so the wgrad plans the CUDA cores' chain, and the
     block kernel the tensor cores'): the block forward at its plan and
     with the CUDA cores' chain forced, and the wgrad, against their plain
     versions at B=2 (f32 ≤ 2e-4, bf16 ≤ 2e-2 of the f32 plain version),
     timed beside them and their bounds; the model served (4 requests,
     exact block_fwd launches, against the staged path, at the block's
     plan and again with the CUDA cores' chain forced, whose launches the
     forced row reports) and trained (the
     step-0 loss and every grad against the staged path, exactly
     num_layers launches of each whole-block kind, then one AdamW step
     with a finite loss).
  29. graphed serving — ``FNOServer`` serves the fused path through one
     CUDA graph per (bucket, K) (every phase above that serves through it
     does so too, its graphs captured before the launches are counted):
     fno2d f32 and bf16, fno3d, fno2d-large, the partial variant and the
     fused ends at one bucket each, rollouts at K = 1, 4, 8 — one replay
     each, exactly the forward's launches × K, the output equal to the
     eager ``step_with`` bit for bit; fno2d also at half its resolution
     through the same server (graphs of its own, bit for bit at both); two
     requests of one bucket back to back leave the first answer
     unchanged; then fno2d
     f32 at K=1 and K=8 graphed against the eager step, in turns (graphed,
     eager, eager, graphed): per-request p50 and p99 and sample-steps/s
     beside the card's name and power limit;
  30. resilient serving — ``ResilientServer`` for fno2d at full width, 2
     replicas, every canned chaos plan: ``STAT_KEYS`` and pool states
     equal to the same plan's run on the CPU, every answer (degraded ones
     from the staged path) within 2e-4 of the staged path, the launches
     exactly num_layers a request that reaches the graphs and a canary
     (the quiet plan: no degradation, num_layers a request); then the
     chaos gate (``launch/chaos_smoke.py``) at full width: the standard
     plan, an exact shed, a corrupt-checkpoint reload that rolls back bit
     for bit, a valid reload whose params the graphs serve (against the
     staged path with those params);
  31. continuous batching — ``ContinuousBatchingServer`` over the graphed
     fno2d server: a seeded schedule of 2-step rollouts at 1.2× the
     capacity calibrated from measured graphed steps (``QUEUE_STATS``
     conserved, no request served late, outputs finite, p50 / p99 on the
     virtual clock), then ``launch/serve_replay_smoke.py``'s fixed model
     at full width: its exact counts, a deterministic replay, and
     num_layers × K launches a K-step rollout (K = 1, 4);
  32. the Trainer — fno2d at full width, Darcy batch 8, 30 steps, a
     checkpoint every 10; a NaN batch at one step, a failed save at one
     checkpoint and an injected failure that ``run_with_restarts``
     recovers from: one NaN skip, one save retry, one restart, and after
     the restore the loss of every step within 2e-4 of a run with the
     same NaN step and no failure.
  33. the DP×TP mesh — the block's TP shard shapes ([O, H/tp] at the
     rank's rows: fno2d at tp 2 (B=8 and the training step's B=4) and tp
     4, fno3d at tp 2, fno2d-large per-mode at tp 2) for the linear block,
     dx adjoint and wgrad against their plain versions (f32 ≤ 2e-4, bf16
     ≤ 2e-2 of the f32 plain version), the linear block timed host-paced
     and queued beside its plain version, its bound and the one-rank
     linear block at fno2d B=8; then ranks spawned on this host's card(s)
     (``launch.mesh.spawn``, ``launch.mesh_cases``; gloo, the collectives
     staged through the host; the kernels built here first): fno2d f32
     and bf16 on (1,2), (2,2) and (1,4), the partial variant, fno3d and
     fno2d-large on (1,2), against the one-rank graphed server (phase 3's
     tolerances), each rank's launches exactly num_layers block_linear a
     forward (rdft, core, irdft with the partial variant); one fno2d
     training step on (2,2) (Darcy batch 8): the step-0 loss, grad norm
     and every gathered grad against the one-rank fused step, 3 launches a
     block a rank (block_linear, dx_adjoint, wgrad). Logs the card count
     and the backend; nccl with two ranks on one card must refuse, and
     with two cards or more (1,2) also runs over nccl.
  34. tuned plans — the committed cache of tuned launch plans
     (``repro_torch.tuning``) is fresh on this checkout
     (``check_tuning_cache``, the core's entries replanned through the
     card's library; a stale cache is fatal); every cached entry of
     fno2d, fno2d-large and fno3d at B=8 and B=1 (f32, bf16, the five
     kinds) launched at its plan against its plain version (phase 2's
     tolerances); each of their entries (B=1, 2, 4, 8) whose plan differs
     from the rule plan on this card timed against it in turns (tuned,
     rule, rule, tuned), queued, beside the card's name and power limit; fno2d and fno3d served (one bucket,
     K=1 and K=4, f32 and bf16) at the cached plans and with the config
     pinning the block forward's rule plan (``with_block_plan``), and one
     batch-8 training step's loss and grads at the cached plans and at
     the rule plans (the cache switched off): exact launches, equal
     outputs; the launch lint at full width (fno2d's launch counts and
     casts, ``launch/lint.py``) and ``check_smem`` over every preset with
     the card's libraries. Every phase above launches at the plans the
     resolver gives (the cached ones where an entry serves the launch).
  35. tiled shapes — the shapes whose spectra do not fit one cluster of
     the block and wgrad kernels (``configs.TILED``: fno2d at hidden 256,
     fno2d-large's per-mode model there, fno2d at 256² modes 64², fno3d at
     hidden 64, fno3d at 128³), which the planners tile (a hidden k-loop
     of hc channels a block, ot out tiles a sample): each shape's plans on
     this card with their tiling fields; every block mode (gelu, gelu_vjp,
     the adjoint dx, the bare forward) and the wgrad with and without the
     bypass against their plain versions at B=2 (f32 ≤ 2e-4, bf16 ≤ 2e-2);
     each model, whole-block and spectral-only, f32 and bf16: served
     through ``FNOServer`` (graphed; K=1 and K=4) against the staged path
     with exactly num_layers launches a step, the step-0 loss and every
     grad against the staged path (2e-4 / 5e-2) with exactly one launch of
     each kind a layer, and 5 AdamW steps whose loss falls; the tiled
     block forward and wgrad at B=8 timed queued beside their plain
     versions, the staged ``torch.fft`` block (``wgrad_staged`` for the
     wgrad) and the bound.
  36. LM serving (``launch/lm_smoke.py``; no TPU kernel lies on this path,
     so it holds the port against itself and plain versions):
     qwen2-1.5b and hymba-1.5b (ring caches, window-slice attention, SSD)
     at full width, random weights from seed 0, batch 4, a 2048-token
     prompt, f32 (TF32 off) and bf16, and the same code in float64 as the
     oracle: 32 teacher-forced decode steps after a 1536-token prefill
     against ``forward``'s rows (float64 within 1e-6; f32 within 3× the f32
     forward's own error against float64, and rtol = atol = 2e-3 where no
     SSD layer amplifies the rounding; bf16 within 3× bf16's own gap to
     f32), the served prefill and
     32 greedy decode steps (tokens in the vocabulary, logits finite) with
     prefill ms, decode ms a token, tokens/s, peak memory, device-busy ms
     a step and the decode bound (params and cache bytes over the card's
     memory rate), ``multihead_attention`` at the prefill shape against a
     dense masked softmax (2e-4) beside ``F.scaled_dot_product_attention``
     (a yardstick); every preset reduced: decode against forward (2e-3),
     greedy steps, hubert's encoder step. It needs no kernel, so it runs
     right after phase 1 starts the builds, while nvcc compiles on the
     host's other cores (its host-bound decode times share the host with
     them).
  37. LM training (``launch/lm_train_smoke.py``; no TPU kernel lies on
     this path either): qwen2-1.5b and hymba-1.5b at full width, random
     weights from seed 0, train_4k's 4096 tokens, a global batch of 4 as
     2 microbatches of 2, per-layer remat, the attention in blocks of
     1024 (``transformer.TRAIN_BLOCK``), the Zipf token stream, f32 (TF32
     off) and bf16 params: the step-0 loss and grads at 1 × 4096 against
     the same code in float64 on the same params (f32 2e-4; bf16 loss
     2e-2, grads 5e-2; a grad scaled by its leaf's magnitude floored at
     1e-3 of the tree's largest; hymba, whose SSD amplifies the rounding
     layer by layer: the same loss limits, its f32 gradient's direction,
     1 − cos, within 3× the f32 forward's own error and at most 0.1, and
     every leaf's grad on the model cut to its first layer within the
     dtype's limit or 3× the cut's forward error, at most 0.1; its whole
     grads' error logged layer by layer); 2 warm steps (the second traced by
     ``torch.profiler``) and 5 timed: step ms (median, host clock),
     tokens/s, the model-FLOPs share of the card's peak, busy / idle
     share, peak memory; batch 0's loss after the steps below step 0's;
     every preset reduced: a 2-microbatch step on the card against the
     CPU (nemotron-4-340b and arctic-480b with bf16 accumulation and
     AdamW state) and remat against none. It runs after phase 36,
     beside the builds.

Each phase's seconds are printed. The last two lines are a
``{"kernels": [...]}`` JSON object and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
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
if os.path.isdir(os.path.join(SRC, "repro_torch")) and SRC not in sys.path:
    sys.path.insert(0, SRC)
try:
    # The H100's published rates and each launch's least time, from the
    # port's roofline (``repro_torch.roofline``); the tests read the rates
    # and bounds through this module too.
    from repro_torch.roofline.analysis import (  # noqa: E402,F401
        PARTIAL_LAUNCHES, block_flops, bound_ms, bound_parts, cgemm_bound,
        cgemm_bound_parts, dense_dft_flops)
    from repro_torch.roofline.hw import (  # noqa: E402,F401
        HBM_BW as PEAK_BYTES, PEAK_3XTF32_FLOPS, PEAK_BF16_FLOPS,
        PEAK_F32_FLOPS, PEAK_FFMA_FLOPS)
except ImportError as exc:
    sys.exit(f"chip_smoke: {SRC}/repro_torch is not importable ({exc}): run "
             f"from a checkout of the repository")

F32_TOL = 2e-4   # DESIGN.md §4: f32 port == reference
BF16_TOL = 2e-2  # DESIGN.md §4: bf16 forward within 2e-2 of the f32 reference
BF16_GRAD_TOL = 5e-2  # DESIGN.md §4: bf16 grads within 5e-2 of f32
DEVICE = "cuda"
WINDOW_REQUESTS = 500      # requests per precision in the sustained window
TRAIN_STEPS = 20           # AdamW steps on one batch: the loss must fall
TRAIN_WINDOW = 30          # timed training steps per precision after those
BLOCK_REPLACES = "src/repro/kernels/engine.py:307"
WGRAD_REPLACES = "src/repro/kernels/engine.py:634"
BLOCK_SOURCE = "src/repro_torch/csrc/fused_block.cu"
WGRAD_SOURCE = "src/repro_torch/csrc/fused_wgrad.cu"
BACKWARD = ("gz_recompute", "dx_adjoint", "wgrad")
SPECTRAL = ("spectral_fwd", "spectral_dx", "spectral_wgrad")
DTYPES = ("float32", "bfloat16")
ROWS_SOURCE = "src/repro_torch/csrc/dft_rows.cu"
CORE_SOURCE = "src/repro_torch/csrc/fused_core.cu"
LARGE = "fno2d-large"        # per-mode weights, hidden 128 (phases 12–15)
LARGE_WINDOW = 200         # requests per precision in phase 13's window
SPECTRAL_WINDOW = 200     # requests per precision and variant, phase 17
FNO3D = "fno3d"            # the rank-3 preset at full width (phases 20–23)
FNO3D_WINDOW = 200         # requests per precision and design, phase 21
# fno3d's fused designs: (fuse_block, variant) by name.
FNO3D_DESIGNS = {"block full": (True, "full"),
                 "block partial": (True, "partial"),
                 "spectral full": (False, "full"),
                 "spectral partial": (False, "partial")}
# The fused model ends (phases 24–27): checked at three presets, served
# and trained at two, with a sustained window of this many requests per
# precision.
ENDS_ARCHS = ("fno2d", "fno3d", "fno2d-large")
ENDS_SERVED = {"fno2d": 200, "fno3d": 50}
ENDS = ("lift", "proj", "both")
QUEUE_CYCLES = 100_000_000  # ~50 ms of device spin ahead of queued timing
CGEMM_SOURCE = "src/repro_torch/csrc/cgemm.cu"
CGEMM_REPLACES = "src/repro/kernels/cgemm.py:45"
# ops.cgemm's shapes (M, K, N): the reference's test cases, then the FNO's
# CGEMM (out channels × hidden × B·ΠK at fno2d and fno2d-large, B=8).
CGEMM_SHAPES = ((32, 16, 24), (128, 128, 128), (37, 19, 23), (256, 8, 64),
                (130, 257, 129), (64, 64, 8192), (128, 128, 8192))
CGEMM_FNO = CGEMM_SHAPES[-2:]
# Phase 28: fno2d's model at a shape whose wgrad the tensor-core chain
# cannot hold (2D 256², modes 32, hidden 64), at this batch.
REFUSED = {"spatial": (256, 256), "modes": (32, 32)}
REFUSED_BATCH = 2
# Phases 29–32: requests per turn of the graphed / eager comparison at K=1
# (a quarter at K=8), requests of the continuous-batching replay, and the
# Trainer's steps.
GRAPH_REQUESTS = 200
QUEUE_REQUESTS = 64
TRAINER_STEPS = 30
# Phase 33: the DP×TP mesh's ranks on this host, their collectives'
# backend where they share a card, the global batch, and each spawn's
# limit in seconds; which phase-33 runs each shard shape's launches come
# from, by (mesh, case names).
MESH_BACKEND = "gloo"
MESH_BATCH = 8
MESH_SPAWN_S = 300.0
SHARD_RUNS = {"fno2d_tp2": ((1, 2), ("fno2d f32", "fno2d bf16")),
              "fno2d_tp2_B4": ((2, 2), ("fno2d f32", "fno2d bf16",
                                        "train grads", "train step")),
              "fno2d_tp4": ((1, 4), ("fno2d f32", "fno2d bf16")),
              "fno3d_tp2": ((1, 2), ("fno3d f32",)),
              "fno2d-large_tp2": ((1, 2), ("fno2d-large f32",)),
              "fno2d_one_rank": (None, ())}
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


def core_w_bytes(engine, torch, dtype, b, h, o, spatial, modes,
                 per_mode=False) -> int:
    """The W bytes one core launch reads at this block as its plan counts
    them (per-mode W once a group of up to 8 samples): a planned figure,
    printed on the log lines only."""
    from repro_torch.kernels import build
    p = math.prod(modes[1:])
    return engine.core_plan(build.load_fused_core(), getattr(torch, dtype),
                            b, h, o, spatial[0], modes[0], p, per_mode,
                            modes[1] if len(modes) > 1 else 1)["w_bytes"]


def time_ms(fn, iters: int, warmup: int = 3, queued: bool = False) -> float:
    """Device ms per call of `fn` over `iters` calls between CUDA events.
    Launches of tens of µs are paced by the host's enqueue (the wrapper's
    checks and the ctypes call); queued=True enqueues them all behind a
    spin on the card first, so the events time the device alone."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wgrad_staged(torch, x, gz, modes, per_mode=False, bypass=True):
    """The weight gradients as staged PyTorch calls on f32 copies of x and
    gz (a yardstick for row 2; the port never calls it): ``rfftn`` of both
    over the spatial axes, each axis truncated to its first modes, the
    ``einsum`` for dW (summed over the modes for shared W, per mode
    otherwise), and with the bypass one ``tensordot`` (a matmul over batch
    and points) for dW_b and a sum for dbias."""
    r = x.dim() - 2
    axes = tuple(range(2, 2 + r))
    keep = (Ellipsis,) + tuple(slice(0, k) for k in modes)
    eq = "bo...,bh...->oh..." if per_mode else "bo...,bh...->oh"
    x32, g32 = x.float(), gz.float()
    xs = x32.reshape(x.shape[0], x.shape[1], -1)
    gs = g32.reshape(gz.shape[0], gz.shape[1], -1)

    def run():
        a = torch.fft.rfftn(x32, dim=axes)[keep]
        g = torch.fft.rfftn(g32, dim=axes)[keep]
        out = [torch.einsum(eq, g, a)]
        if bypass:
            out += [torch.tensordot(gs, xs, dims=([0, 2], [0, 2])),
                    gs.sum(dim=(0, 2))]
        return out
    return run


def staged_wgrad_ms(torch, x, gz, modes, per_mode=False, bypass=True):
    """Device ms of ``wgrad_staged``, queued behind a spin on the card."""
    return time_ms(wgrad_staged(torch, x, gz, modes, per_mode, bypass), 10,
                   queued=True)


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
    # one nvcc per source, all started together; phases 36 and 37, which
    # need no kernel, run while they compile (finish_builds waits for them)
    pool = concurrent.futures.ThreadPoolExecutor(len(build.SOURCES))
    futures = [pool.submit(build.build, name) for name in build.SOURCES]
    return card, (pool, futures, time.perf_counter())


def finish_builds(build, builds) -> None:
    """Wait for phase 1's builds (raising the first that failed) and log
    each one's nvcc seconds and ptxas lines."""
    pool, futures, t0 = builds
    try:
        for future in futures:
            future.result()
    finally:
        pool.shutdown()
    log(f"  build: {time.perf_counter() - t0:.2f} s for {build.SOURCES}")
    for name in build.SOURCES:
        info = build.BUILD_INFO[name]
        log(f"  {name}: nvcc {info['seconds']:.2f} s "
            f"(cached={info['cached']})")
        for line in info["ptxas"]:
            log(f"    {line}")


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
    for srv in servers.values():  # build and capture outside the count
        srv.warm((1, 4))
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
                       phase="4", requests=WINDOW_REQUESTS, per_request=None):
    """Sustained serving, one precision at a time: `requests`
    single-step requests of seeded sizes 1–8 back to back, each waited for
    (one request in flight, as a client that needs its answer). Latency is
    the host clock from call to answer; throughput is every sample-step over
    the whole window's wall time. `names` are the f32 and bf16 servers,
    `kinds` the launch kinds each layer launches (`per_request`: launches of
    each kind per request, num_layers each by default); the sizes are the
    same for every variant."""
    srv0 = servers[names[0]]
    log(f"== phase {phase}: times — sustained serve window, "
        f"{srv0.cfg.name} full width, {names}")
    shape = (srv0.cfg.in_channels,) + tuple(srv0.cfg.spatial)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    pool = torch.randn((64,) + shape, generator=gen, device=DEVICE)
    stats = {}
    for name in names:
        srv = servers[name]
        rng = np.random.default_rng(3)
        sizes = rng.integers(1, 9, size=requests)
        offs = rng.integers(0, 64 - 8, size=requests)
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
        per = per_request or {k: num_layers for k in kinds}
        want = {(k, dt): n * requests for k, n in per.items()}
        if dict(engine.LAUNCHES) != want:
            raise AssertionError(f"window launches {dict(engine.LAUNCHES)} "
                                 f"!= {want}")
        if not all(bool(torch.isfinite(y).all()) for y in outs):
            raise AssertionError(f"non-finite output in the {name} window")
        lat = np.asarray(lat)
        buckets = np.asarray([srv.buckets[np.searchsorted(srv.buckets, n)]
                              for n in sizes])
        st = {"requests": requests, "sample_steps": int(sizes.sum()),
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


def block_launches(engine, args, gy, gz, mats):
    """A block's launches, each as fn(plain) running the kernel or its
    plain version, with the arguments the fused path gives them: the
    forward; gz from gy; dx from `gz` through the adjoint bundle with the
    weights' transposed view (as ``ops.fno_block_nd``'s backward passes
    them); the weight gradients (per mode for per-mode weights)."""
    x, wr, wi, wb, bias = args
    wbt = wb.t().contiguous()
    block = lambda plain: (engine.fused_block_plain if plain
                           else engine.fused_block)
    return {
        "block_fwd": lambda plain: block(plain)(*args, mats["forward"]),
        "gz_recompute": lambda plain: block(plain)(
            *args, mats["forward"], act="gelu_vjp", gy=gy),
        "dx_adjoint": lambda plain: block(plain)(
            gz, wr.transpose(0, 1), wi.transpose(0, 1), wbt, None,
            mats["adjoint"], act="linear",
            **({} if plain else {"adjoint": True})),
        "wgrad": lambda plain: (
            engine.fused_wgrad_plain if plain else engine.fused_wgrad)(
                x, gz, mats["wgrad"], per_mode=wr.ndim > 2),
    }


def run_backward(engine, args, gy, mats, *, plain=False, gz=None):
    """The backward's three launches (or their plain versions). A given
    `gz` feeds dx and wgrad in place of the one computed here."""
    fns = block_launches(engine, args, gy, gz, mats)
    gz0 = fns["gz_recompute"](plain)
    if gz is None:
        fns = block_launches(engine, args, gy, gz0, mats)
    return gz0, fns["dx_adjoint"](plain), fns["wgrad"](plain)


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


def phase_train(torch, configs, fno_mod, batch_fn, tree, ts, optim,
                engine, variant="full", phase="6", arch="fno2d",
                fuse_block=True, presets=("f32", "bf16"), fuse_ends=False):
    """Step-0 parity of the fused path (full or partial variant; whole-block
    kernels, or with fuse_block=False the spectral-layer kernels; with
    fuse_ends the end MLPs folded into the first and last block) with the
    staged one, the launch structure, and TRAIN_STEPS AdamW steps on one
    batch per precision preset."""
    log(f"== phase {phase}: train {arch} at full width, variant {variant}, "
        f"fuse_block {fuse_block}, fuse_ends {fuse_ends}")
    bwd = engine.KINDS[1:] if fuse_block else engine.SPECTRAL_KINDS[1:]
    fwd = ((engine.KINDS[0] if fuse_block else engine.SPECTRAL_KINDS[0],)
           if variant == "full" else engine.PARTIAL_KINDS)
    cfg = configs.with_fuse_block(configs.get_config(arch), fuse_block)
    cfg = configs.with_fuse_ends(cfg, fuse_ends)
    staged = dataclasses.replace(cfg, path="staged", fuse_block=False)
    layers = cfg.num_layers
    # Launches of each kind per training step: num_layers each, or with the
    # ends two block_ends and the interior blocks' four kinds.
    per_step = {k: layers for k in fwd + bwd}
    if fuse_ends:
        per_step = {k: n for k, n in [("block_ends", 2)] + [
            (k, layers - 2) for k in engine.KINDS] if n}
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg, DEVICE)
    batch = batch_fn(cfg, 8, DEVICE)(0)
    for k, v in batch.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite training batch {k}")
    log(f"  batch x {tuple(batch['x'].shape)} y {tuple(batch['y'].shape)}; "
        f"params {cfg.param_count()}")
    loss_ref, g_ref = ts.value_and_grad(
        ts.make_loss_fn(staged, fno_path="staged"), params, batch)
    gn_ref = float(optim.global_norm(g_ref))
    log(f"  staged f32: loss {float(loss_ref):.6f} grad_norm {gn_ref:.6f}")
    total = TRAIN_STEPS + TRAIN_WINDOW
    runs, counts = {}, {}
    for preset in presets:
        tol = F32_TOL if preset == "f32" else BF16_GRAD_TOL
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
        want = {(k, dt): n for k, n in per_step.items()}
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
        want = {(k, dt): n * TRAIN_STEPS for k, n in per_step.items()}
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
    per precision, continuing each run of `runs`. The peak counts every
    tensor alive on the card, the other runs' params and AdamW state
    included; ``resident_bytes`` is what was allocated when the window
    began."""
    stats = {}
    for dt, (step, p, st) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
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
                     "resident_bytes": resident,
                     "final_loss": float(m["loss"])}
        log(f"  {dt}: step ms median {stats[dt]['step_ms_median']:.4f} p90 "
            f"{stats[dt]['step_ms_p90']:.4f}; "
            f"{stats[dt]['samples_per_s']:.2f} samples/s; peak memory "
            f"{stats[dt]['peak_memory_bytes']} B (resident at the start "
            f"{resident} B)")
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
        gz = engine.fused_block(*args, mats["forward"], act="gelu_vjp", gy=gy)
        launch = block_launches(engine, args, gy, gz, mats)
        leaves = [a.detach().clone().requires_grad_(True)
                  for a in (x, wr, wi, wb, bias.reshape(-1))]
        y = ops.fno_block_nd(*leaves, modes, path="ref")
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            y, leaves, gy, retain_graph=True), 10)
        staged_ms = staged_wgrad_ms(torch, x, gz, modes)
        log(f"  {dt} wgrad staged (rfftn, einsum, matmul, sum; f32 copies, "
            f"queued): {staged_ms:.4f} ms")
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
                "torch_fft_bwd_ms": bwd_ms,
                **({"torch_staged_ms": staged_ms} if kind == "wgrad"
                   else {})})
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
    dtype). rdft/irdft transform the outer axes (one axis at rank 2; at
    rank 3 ``dft.outer_rdft`` / ``outer_irdft`` with the per-axis factors,
    held against the reference's Kronecker-combined product); cdft/icdft
    are the s_1 stage as standalone row launches."""
    r = len(spatial)
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s, sc=1.0: (sc * torch.randn(s, generator=gen)).to(DEVICE)
    n1, k1 = spatial[0], modes[0]
    osp, omd = tuple(spatial[1:]), tuple(modes[1:])
    n_out, p = math.prod(osp), math.prod(omd)
    spec = tuple(modes[r - 1:0:-1])
    row = lambda kind, sp, md: {
        dt: spectral.row_operand_tensors(kind, sp, md, dt, DEVICE)
        for dt in DTYPES}
    if r == 2:
        rdft = (dft.rdft, dft.rdft_plain, [rnd(b, h, n1, n_out)],
                row("rdft", osp, omd))
        irdft = (dft.irdft, dft.irdft_plain,
                 [rnd(b, o, n1, p), rnd(b, o, n1, p)], row("irdft", osp, omd))
    else:
        pairs = lambda k2, k3: {dt: (row(k2, osp[:1], omd[:1])[dt],
                                     row(k3, osp[1:], omd[1:])[dt])
                                for dt in DTYPES}
        rdft = (dft.outer_rdft, dft.outer_rdft_plain,
                [rnd(b, h, n1, *osp)], pairs("cdft", "cdft"))
        irdft = (dft.outer_irdft, dft.outer_irdft_plain,
                 [rnd(b, o, n1, *spec), rnd(b, o, n1, *spec)],
                 pairs("icdft", "irdft"))
    core_ops = {dt: spectral.operand_tensors(spatial, modes, dt,
                                             DEVICE)[2 * r - 2:2 * r + 2]
                for dt in DTYPES}
    return {
        "rdft": rdft,
        "cdft": (dft.cdft, dft.cdft_plain,
                 [rnd(b * h * p, n1), rnd(b * h * p, n1)],
                 row("cdft", (n1,), (k1,))),
        "icdft": (dft.cdft, dft.cdft_plain,
                  [rnd(b * o * p, k1), rnd(b * o * p, k1)],
                  row("icdft", (n1,), (k1,))),
        "irdft": irdft,
        "core": (engine.fused_core, engine.fused_core_plain,
                 [rnd(b, h, n1, *spec), rnd(b, h, n1, *spec),
                  rnd(o, h, sc=1.0 / h), rnd(o, h, sc=1.0 / h)], core_ops),
    }


def check_partial(torch, cases, name, errs):
    """Each of ``partial_cases``' launches against its plain version: f32
    on the same inputs (≤ 2e-4), bf16 against the f32 plain version
    (≤ 2e-2); the errors go into `errs` by (name, kind, dtype)."""
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


def phase_partial_vs_plain(torch, engine, spectral, dft, configs):
    log("== phase 8: kernel vs plain on the card, partial launches")
    errs = {}
    for seed, (name, b, h, o, spatial, modes) in enumerate(
            partial_shapes(configs)):
        check_partial(torch, partial_cases(torch, spectral, dft, engine, b,
                                           h, o, spatial, modes, 500 + seed),
                      name, errs)
    # The core at B=9, per-mode and shared W at the odd extents: the
    # per-mode plan's two sample groups (8 + 1), the shared plan's nine
    # one-sample tiles.
    odd = [c for c in check_shapes(configs) if c[0] in ("odd_r2", "odd_r3")]
    for seed, (name, _, h, o, spatial, modes) in enumerate(odd):
        ins, ops = per_mode_core_case(torch, spectral, 9, h, o, spatial,
                                      modes, 530 + seed)
        first = (slice(None), slice(None)) + (0,) * len(modes)
        shared = ins[:2] + [w[first].contiguous() for w in ins[2:4]]
        for layout, args in (("per-mode", ins), ("shared", shared)):
            ref = engine.fused_core_plain(*args, *ops["float32"])
            y = engine.fused_core(*args, *ops["float32"])
            y16 = engine.fused_core(*[a.to(torch.bfloat16) for a in args],
                                    *ops["bfloat16"])
            torch.cuda.synchronize()
            key = f"{name}_B9_{layout}"
            errs[(key, "core", "float32")] = e = errors(y, ref)
            check(f"{name} B=9 {layout} f32 core vs plain", e[1], F32_TOL)
            errs[(key, "core", "bfloat16")] = e = errors(y16, ref)
            check(f"{name} B=9 {layout} bf16 core vs f32 plain", e[1],
                  BF16_TOL)
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


def phase_serve_partial(torch, np, sfs, engine, servers):
    log("== phase 9: serve the partial variant, fno2d full width")
    cfg = servers["fused"].cfg
    params = servers["fused"].params
    for name, base in (("partial", "fused"), ("partial_bf16", "bf16")):
        servers[name] = sfs.FNOServer(servers[base].cfg, params,
                                      device=DEVICE, variant="partial",
                                      max_batch=8)
    shape = (cfg.in_channels,) + tuple(cfg.spatial)
    for name in ("partial", "partial_bf16"):  # capture outside the count
        servers[name].warm((1, 4))
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
    return counts


def library_call(torch, kind, ins, spatial, modes):
    """The one torch.fft call that computes a row launch's function, on its
    f32 inputs (a yardstick; the port never calls it), or None (core).
    rdft / irdft transform the outer axes s_2..s_R (rfftn / irfftn over
    the rows after the leading (b, h, s_1) viewed as those axes; the
    kernels' spectrum columns run k_R..k_2), cdft / icdft the s_1 axis."""
    n1, k1 = spatial[0], modes[0]
    osp, omd = tuple(spatial[1:]), tuple(modes[1:])
    axes = tuple(range(-len(osp), 0))
    if kind == "rdft":
        x = ins[0].reshape(*ins[0].shape[:3], *osp)
        keep = (Ellipsis,) + tuple(slice(0, k) for k in omd)
        return lambda: torch.fft.rfftn(x, dim=axes)[keep]
    if kind == "core":
        return None
    c = torch.complex(*ins)
    if kind == "cdft":
        return lambda: torch.fft.fft(c, dim=-1)[..., :k1]
    if kind == "icdft":
        return lambda: torch.fft.ifft(c, n=n1, dim=-1)
    c = c.reshape(*c.shape[:3], *omd[::-1])  # columns k_R..k_2
    lead = c.dim() - len(omd)
    c = c.permute(*range(lead), *reversed(range(lead, c.dim())))
    return lambda: torch.fft.irfftn(c, s=osp, dim=axes)


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
    rows = []
    for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                         ("bfloat16", PEAK_BF16_FLOPS, 2)):
        tdt = getattr(torch, dt)
        t = {}
        for kind in PARTIAL_LAUNCHES:
            fn, plain, ins, mats = cases[kind]
            a = [x.to(tdt) for x in ins]
            m = mats[dt]
            lib = library_call(torch, kind, ins, spatial, modes)
            # Tens of µs: device time only (queued behind a spin).
            t[kind] = {
                "ms": time_ms(lambda: fn(*a, *m), 20, queued=True),
                "plain_ms": time_ms(lambda: plain(*a, *m), 10, queued=True),
                "library_ms": (time_ms(lib, 20, queued=True) if lib
                               else None),
                "bound": bound_ms(kind, b, h, o, spatial, modes, eb, peak)}
            if kind in ("cdft", "icdft"):  # also as they were timed before
                t[kind]["ms_host_paced"] = time_ms(lambda: fn(*a, *m), 20)
                t[kind]["library_ms_host_paced"] = time_ms(lib, 20)
            if kind == "core":  # as the first core was timed
                t[kind]["ms_host_paced"] = time_ms(lambda: fn(*a, *m), 20)
                wb = core_w_bytes(engine, torch, dt, b, h, o, spatial, modes)
                log(f"  {dt} core: host-paced kernel_ms="
                    f"{t[kind]['ms_host_paced']:.4f}; planned W bytes a "
                    f"launch {wb}")
            log(f"  {dt} {kind}: kernel_ms={t[kind]['ms']:.4f} plain_ms="
                f"{t[kind]['plain_ms']:.4f} library_ms="
                f"{t[kind]['library_ms']} bound_us="
                f"{1e3 * t[kind]['bound'][0]:.2f} ({t[kind]['bound'][1]})"
                + (f"; paced by the host: kernel_ms="
                   f"{t[kind]['ms_host_paced']:.4f} library_ms="
                   f"{t[kind]['library_ms_host_paced']:.4f}"
                   if kind in ("cdft", "icdft") else ""))
        for kind in ("rdft", "irdft"):  # fno3d's outer launches at B=1
            fn, _, ins, mats = cases3[kind]
            a = [x.to(tdt) for x in ins]
            t[kind]["ms_fno3d_b1"] = time_ms(lambda: fn(*a, *mats[dt]), 5,
                                             queued=True)
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
                row.update({"ms_host_paced": t["core"]["ms_host_paced"],
                            "timing": "queued behind a device spin: device "
                                      "time only"})
            elif kind in ("rdft", "irdft"):
                row["ms_fno3d_b1"] = t[kind]["ms_fno3d_b1"]
            if kind == "cdft":  # the padded inverse operand, same kernel
                keys = ("ms", "plain_ms", "library_ms", "ms_host_paced",
                        "library_ms_host_paced")
                row.update({"ms_host_paced": t["cdft"]["ms_host_paced"],
                            "library_ms_host_paced":
                                t["cdft"]["library_ms_host_paced"],
                            "timing": "queued behind a device spin: device "
                                      "time only"})
                row.update({f"{key}_inverse": t["icdft"][key]
                            for key in keys})
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


# ---------------------------------------------------------------------------
# fno2d-large: per-mode spectral weights [O,H,k_1..k_R], hidden 128
# ---------------------------------------------------------------------------
def per_mode_shapes(configs):
    """Phase 12's shapes: phase 2's odd extents at ranks 1–3 and
    fno2d-large at full width, B=8."""
    shapes = [c for c in check_shapes(configs) if c[0].startswith("odd")]
    big = configs.get_config(LARGE)
    shapes.append(("fno2d_large_B8", 8, big.hidden, big.hidden, big.spatial,
                   big.modes))
    return shapes


def per_mode_inputs(b, h, o, spatial, modes, seed, device):
    """x, per-mode wr/wi [O,H,k_1..k_R] (scaled 1/H), wb, bias [O,1]."""
    x, _, _, wb, bias = block_inputs(b, h, o, spatial, seed, device)
    import torch
    gen = torch.Generator().manual_seed(seed)
    w = lambda: (torch.randn((o, h) + tuple(modes), generator=gen) / h).to(
        device)
    return [x, w(), w(), wb, bias]


def run_block(engine, args, gy, mats, *, plain=False, gz=None):
    """The block's four launches (or their plain versions): y, then
    ``run_backward``'s gz, dx and weight gradients."""
    block = engine.fused_block_plain if plain else engine.fused_block
    return (block(*args, mats["forward"]),
            *run_backward(engine, args, gy, mats, plain=plain, gz=gz))


def per_mode_core_case(torch, spectral, b, h, o, spatial, modes, seed):
    """The core's f32 inputs at a block of this shape with per-mode W, and
    its s_1 operands by dtype."""
    r = len(spatial)
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s, sc=1.0: (sc * torch.randn(s, generator=gen)).to(DEVICE)
    spec = tuple(modes[r - 1:0:-1])
    ins = [rnd(b, h, spatial[0], *spec), rnd(b, h, spatial[0], *spec),
           rnd(o, h, *modes, sc=1.0 / h), rnd(o, h, *modes, sc=1.0 / h)]
    ops = {dt: spectral.operand_tensors(spatial, modes, dt,
                                        DEVICE)[2 * r - 2:2 * r + 2]
           for dt in DTYPES}
    return ins, ops


def phase_per_mode_vs_plain(torch, engine, spectral, configs):
    log("== phase 12: per-mode kernels vs plain on the card")
    errs = {}
    for seed, (name, b, h, o, spatial, modes) in enumerate(
            per_mode_shapes(configs)):
        args32 = per_mode_inputs(b, h, o, spatial, modes, 700 + seed, DEVICE)
        gy32 = torch.randn((b, o) + tuple(spatial),
                           generator=torch.Generator().manual_seed(seed)
                           ).to(DEVICE)
        m32 = backward_mats(spectral, spatial, modes, "float32")
        # f32: each launch against its plain version on the same inputs.
        y, gz, dx, dw = run_block(engine, args32, gy32, m32)
        py, pgz, pdx, pdw = run_block(engine, args32, gy32, m32,
                                         plain=True, gz=gz)
        torch.cuda.synchronize()
        for kind, a, ref in (("block_fwd", [y], [py]),
                             ("gz_recompute", [gz], [pgz]),
                             ("dx_adjoint", [dx], [pdx]),
                             ("wgrad", dw, pdw)):
            errs[(name, kind, "float32")] = e = errors(a, ref)
            check(f"{name} per-mode f32 {kind} vs plain", e[1], F32_TOL)
        del y, dx, dw, py, pgz, pdx, pdw
        # bf16: the kernels' chain against the f32 plain chain.
        ref = run_block(engine, args32, gy32, m32, plain=True)
        args16 = [a.to(torch.bfloat16) for a in args32]
        m16 = backward_mats(spectral, spatial, modes, "bfloat16")
        ours = run_block(engine, args16, gy32.to(torch.bfloat16), m16)
        torch.cuda.synchronize()
        for kind, a, r in zip(("block_fwd", "gz_recompute", "dx_adjoint"),
                              ours[:3], ref[:3]):
            errs[(name, kind, "bfloat16")] = e = errors([a], [r])
            check(f"{name} per-mode bf16 {kind} vs f32 plain", e[1],
                  BF16_TOL)
        errs[(name, "wgrad", "bfloat16")] = e = errors(ours[3], ref[3])
        check(f"{name} per-mode bf16 wgrad vs f32 plain", e[1], BF16_TOL)
        del ours, ref, args16
        if len(spatial) == 1:  # the bare spectral layer (rank-1 partial)
            x, wr, wi = args32[:3]
            bare = engine.fused_block(x, wr, wi, None, None, m32["forward"],
                                      act="linear")
            pbare = engine.fused_block_plain(x, wr, wi, None, None,
                                             m32["forward"], act="linear")
            torch.cuda.synchronize()
            check(f"{name} per-mode f32 bare spectral vs plain",
                  rel_err(bare, pbare), F32_TOL)
            continue
        ins, ops = per_mode_core_case(torch, spectral, b, h, o, spatial,
                                      modes, 750 + seed)
        ref = engine.fused_core_plain(*ins, *ops["float32"])
        yc = engine.fused_core(*ins, *ops["float32"])
        yc16 = engine.fused_core(*[a.to(torch.bfloat16) for a in ins],
                                 *ops["bfloat16"])
        torch.cuda.synchronize()
        errs[(name, "core", "float32")] = e = errors(yc, ref)
        check(f"{name} per-mode f32 core vs plain", e[1], F32_TOL)
        errs[(name, "core", "bfloat16")] = e = errors(yc16, ref)
        check(f"{name} per-mode bf16 core vs f32 plain", e[1], BF16_TOL)
        del ins, ref, yc, yc16
    return errs


def phase_serve_large(torch, np, configs, fno_mod, sfs, engine):
    """fno2d-large served at full width in both variants: phase 3's 12
    requests against the staged path, with exact launch counts."""
    log("== phase 13: serve fno2d-large at full width, full and partial")
    cfg = configs.with_fuse_block(configs.get_config(LARGE))
    fused = dataclasses.replace(cfg, path="fused")
    log(f"  config: hidden={cfg.hidden} layers={cfg.num_layers} "
        f"spatial={cfg.spatial} modes={cfg.modes} weight_mode="
        f"{cfg.weight_mode} params={cfg.param_count()}")
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg, DEVICE)
    leaves = sum(t.numel() for t in
                 [v for blk in params["blocks"] for d in blk.values()
                  for v in d.values()]
                 + [v for k in ("lift1", "lift2", "proj1", "proj2")
                    for v in params[k].values()])
    log(f"  parameters {leaves} "
        f"(spectral weight {tuple(params['blocks'][0]['spectral']['wr'].shape)})")
    servers = {}
    for name, c, variant in (
            ("fused", fused, "full"),
            ("bf16", configs.with_precision(fused, "bf16"), "full"),
            ("partial", fused, "partial"),
            ("partial_bf16", configs.with_precision(fused, "bf16"),
             "partial"),
            ("staged", dataclasses.replace(cfg, path="staged",
                                           fuse_block=False), "full")):
        servers[name] = sfs.FNOServer(c, params, device=DEVICE,
                                      variant=variant, max_batch=8)
    shape = (cfg.in_channels,) + tuple(cfg.spatial)
    for srv in servers.values():  # build and capture outside the count
        srv.warm((1, 4))
    counts = {}
    for variant, names, kinds in (
            ("full", ("fused", "bf16"), ("block_fwd",)),
            ("partial", ("partial", "partial_bf16"), engine.PARTIAL_KINDS)):
        plan = [(x, k, names[1] if bf16 else names[0])
                for x, k, bf16 in serve_requests(torch, np, shape)]
        expect = expected_launches(plan, kinds, cfg.num_layers,
                                   servers[names[0]].buckets[-1])
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        outs = [servers[name](x, rollout_steps=k) for x, k, name in plan]
        torch.cuda.synchronize()
        counts[variant] = dict(engine.LAUNCHES)
        log(f"  {variant}: launches {counts[variant]} expected {expect}")
        if counts[variant] != expect:
            raise AssertionError(f"kernel launches {counts[variant]} != "
                                 f"{expect}")
        for (x, k, name), y in zip(plan, outs):
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"non-finite serve output ({name}, "
                                     f"K={k})")
            tol = F32_TOL if name in ("fused", "partial") else BF16_TOL
            check(f"serve {LARGE} {name} n={x.shape[0]} K={k} vs staged f32",
                  rel_err(y, servers["staged"](x, rollout_steps=k)), tol)
        del outs
    return counts, servers


def phase_large_times(torch, engine, spectral, dft, ops, configs, sfs,
                      fno_mod, errs, serve_counts, train_counts):
    """CUDA events at fno2d-large B=8 for each per-mode launch beside its
    plain version and its bound, the row kernels at hidden 128 and the
    served block forward in both variants; then the bare spectral layer
    (the rank-1 partial forward) at fno1d full width, B=8, with its
    launches on a served fno1d partial request."""
    log("== phase 15: times — per-mode launches at fno2d-large B=8")
    big = configs.get_config(LARGE)
    b, h, o = 8, big.hidden, big.hidden
    spatial, modes = big.spatial, big.modes
    args32 = per_mode_inputs(b, h, o, spatial, modes, 800, DEVICE)
    gy32 = torch.randn((b, o) + tuple(spatial),
                       generator=torch.Generator().manual_seed(801)).to(DEVICE)
    core_ins, core_ops = per_mode_core_case(torch, spectral, b, h, o,
                                            spatial, modes, 802)
    row_cases = partial_cases(torch, spectral, dft, engine, b, h, o, spatial,
                              modes, 803)
    rows, extra = [], {}
    for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                         ("bfloat16", PEAK_BF16_FLOPS, 2)):
        tdt = getattr(torch, dt)
        args = [a.to(tdt) for a in args32]
        x, wr, wi, wb, bias = args
        gy = gy32.to(tdt)
        mats = backward_mats(spectral, spatial, modes, dt)
        gz = engine.fused_block(*args, mats["forward"], act="gelu_vjp", gy=gy)
        cins = [a.to(tdt) for a in core_ins]
        launch = block_launches(engine, args, gy, gz, mats)
        launch["core"] = lambda plain: (
            engine.fused_core_plain if plain else engine.fused_core)(
                *cins, *core_ops[dt])
        sources = {"wgrad": (WGRAD_SOURCE, WGRAD_REPLACES),
                   "core": (CORE_SOURCE, PARTIAL_REPLACES["core"])}
        staged_ms = staged_wgrad_ms(torch, x, gz, modes, per_mode=True)
        log(f"  {dt} wgrad per-mode staged (rfftn, einsum, matmul, sum; f32 "
            f"copies, queued): {staged_ms:.4f} ms")
        for kind, fn in launch.items():
            kms = time_ms(lambda: fn(False), 10)
            pms = time_ms(lambda: fn(True), 5)
            core = {}
            if kind == "core":  # device time (queued); the plan logged
                from repro_torch.kernels import build
                shape = (b, h, o, spatial[0], modes[0], modes[1], True,
                         modes[1])
                plan = engine.core_plan(build.load_fused_core(), tdt, *shape)
                at_once = engine.core_max_clusters(build.load_fused_core(),
                                                   tdt, *shape)
                tiles = plan["groups"] * plan["ptiles"]
                core = {"ms_host_paced": kms}
                kms = time_ms(lambda: fn(False), 10, queued=True)
                log(f"  {dt} core per-mode: host-paced kernel_ms="
                    f"{core['ms_host_paced']:.4f}; planned: W bytes a "
                    f"launch {plan['w_bytes']}, {tiles} clusters of "
                    f"{plan['cluster']}, the card runs {at_once} at once: "
                    f"{-(-tiles // at_once)} waves")
            t_bytes, t_ops = bound_parts(kind, b, h, o, spatial, modes, eb,
                                         peak, per_mode=True)
            bms, by = bound_ms(kind, b, h, o, spatial, modes, eb, peak,
                               per_mode=True)
            log(f"  {dt} {kind} per-mode: kernel_ms={kms:.4f} plain_ms="
                f"{pms:.4f} bound_us={1e3 * bms:.2f} ({by}; bytes "
                f"{1e3 * t_bytes:.2f} us, operations {1e3 * t_ops:.2f} us)")
            src, rep = sources.get(kind, (BLOCK_SOURCE, BLOCK_REPLACES))
            if kind in ("block_fwd", "core"):
                launches = serve_counts["full" if kind == "block_fwd"
                                        else "partial"].get((kind, dt), 0)
            else:
                launches = train_counts["full"][dt].get((kind, dt), 0)
            e = errs[("fno2d_large_B8", kind, dt)]
            rows.append({
                "name": f"{kind}_per_mode_{'f32' if dt == 'float32' else 'bf16'}",
                "route": "cuda", "source": src, "replaces": rep,
                "launches": launches,
                "launches_train": train_counts[
                    "partial" if kind == "core" else "full"][dt].get(
                        (kind, dt), 0),
                "max_abs_err": e[0], "scaled_err": e[1],
                "tol": F32_TOL if dt == "float32" else BF16_TOL,
                "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
                "library_ms": None,
                "library_note": "no single PyTorch call computes it",
                **core,
                **({"torch_staged_ms": staged_ms} if kind == "wgrad"
                   else {})})
        for kind in ("rdft", "irdft"):  # the row kernels at hidden 128
            fn, plain, ins, rmats = row_cases[kind]
            a, m = [v.to(tdt) for v in ins], rmats[dt]
            e = errors(as_tuple(fn(*a, *m)),
                       as_tuple(plain(*ins, *rmats["float32"])))
            check(f"fno2d-large B=8 {dt} {kind} vs f32 plain", e[1],
                  F32_TOL if dt == "float32" else BF16_TOL)
            lib = library_call(torch, kind, ins, spatial, modes)
            kms = extra[f"{kind}_{dt}_ms"] = time_ms(
                lambda: fn(*a, *m), 20, queued=True)
            pms = time_ms(lambda: plain(*a, *m), 10, queued=True)
            lms = time_ms(lib, 20, queued=True)
            t_bytes, t_ops = bound_parts(kind, b, h, o, spatial, modes, eb,
                                         peak)
            bms, by = bound_ms(kind, b, h, o, spatial, modes, eb, peak)
            log(f"  {dt} {kind} fno2d-large B=8: kernel_ms={kms:.4f} "
                f"plain_ms={pms:.4f} library_ms={lms:.4f} bound_us="
                f"{1e3 * bms:.2f} ({by})")
            rows.append({
                "name": f"{kind}_large_{'f32' if dt == 'float32' else 'bf16'}",
                "route": "cuda", "source": ROWS_SOURCE,
                "replaces": PARTIAL_REPLACES[kind],
                "shape": "fno2d-large B=8",
                "launches": serve_counts["partial"].get((kind, dt), 0),
                "launches_train": train_counts["partial"][dt].get(
                    (kind, dt), 0),
                "max_abs_err": e[0], "scaled_err": e[1],
                "tol": F32_TOL if dt == "float32" else BF16_TOL,
                "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
                "library_ms": lms})
        # The served block forward, partial (3 launches + tail) and full.
        bias1 = bias.reshape(-1)
        with torch.no_grad():
            for variant in ("partial", "full"):
                extra[f"block_{variant}_{dt}_ms"] = time_ms(
                    lambda: ops.fno_block_nd(x, wr, wi, wb, bias1, modes,
                                             variant=variant), 10)
        log(f"  {dt} fno2d-large: {extra}")
        del args, gz, cins
    del row_cases, core_ins
    rows += bare_spectral_times(torch, engine, spectral, configs, sfs,
                                fno_mod)
    log(f"  max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    return rows, extra


def bare_spectral_times(torch, engine, spectral, configs, sfs, fno_mod):
    """The block kernel without wb (``spectral_fwd``), the rank-1 partial
    forward: launches on one served fno1d request of 8 samples through
    the partial variant, then CUDA events at fno1d full width B=8 beside
    the plain version and the bound."""
    c1 = configs.with_fuse_block(configs.get_config("fno1d"))
    p1 = fno_mod.init_fno(torch.Generator().manual_seed(0), c1, DEVICE)
    rows = []
    for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                         ("bfloat16", PEAK_BF16_FLOPS, 2)):
        c = dataclasses.replace(c1, path="fused")
        if dt == "bfloat16":
            c = configs.with_precision(c, "bf16")
        srv = sfs.FNOServer(c, p1, device=DEVICE, variant="partial",
                            max_batch=8)
        x8 = torch.randn((8, c1.in_channels) + tuple(c1.spatial),
                         generator=torch.Generator().manual_seed(810)
                         ).to(DEVICE)
        srv(x8)  # warm
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        y8 = srv(x8)
        torch.cuda.synchronize()
        launches = dict(engine.LAUNCHES)
        want = {("spectral_fwd", dt): c1.num_layers}
        if launches != want or not bool(torch.isfinite(y8).all()):
            raise AssertionError(f"fno1d partial request: launches "
                                 f"{launches} != {want}, or non-finite")
        b, h = 8, c1.hidden
        x, wr, wi = [a.to(getattr(torch, dt)) for a in block_inputs(
            b, h, h, c1.spatial, 811, DEVICE)[:3]]
        x32, wr32, wi32 = [a.float() for a in (x, wr, wi)]
        m = spectral.operand_tensors(c1.spatial, c1.modes, dt, DEVICE)
        m32 = spectral.operand_tensors(c1.spatial, c1.modes, "float32",
                                       DEVICE)
        run = lambda plain: (engine.fused_block_plain if plain
                             else engine.fused_block)(
            x, wr, wi, None, None, m, act="linear")
        ref = engine.fused_block_plain(x32, wr32, wi32, None, None, m32,
                                       act="linear")
        e = errors([run(False)], [ref])
        check(f"fno1d B8 {dt} bare spectral vs f32 plain", e[1],
              F32_TOL if dt == "float32" else BF16_TOL)
        kms = time_ms(lambda: run(False), 20)
        pms = time_ms(lambda: run(True), 10)
        bms, by = bound_ms("spectral_fwd", b, h, h, c1.spatial, c1.modes,
                           eb, peak)
        log(f"  {dt} spectral_fwd fno1d B=8: kernel_ms={kms:.4f} plain_ms="
            f"{pms:.4f} bound_us={1e3 * bms:.3f} ({by}); launches on one "
            f"served partial request {launches}")
        rows.append({
            "name": f"spectral_fwd_{'f32' if dt == 'float32' else 'bf16'}",
            "route": "cuda", "source": BLOCK_SOURCE,
            "replaces": BLOCK_REPLACES,
            "launches": launches[("spectral_fwd", dt)],
            "launches_note": "one served fno1d partial request of 8",
            "max_abs_err": e[0], "scaled_err": e[1],
            "tol": F32_TOL if dt == "float32" else BF16_TOL,
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None})
    return rows



# ---------------------------------------------------------------------------
# The spectral-only path (fuse_block off: the paper's fusion of each
# spectral conv, the bypass, bias and GELU in PyTorch) and the standalone
# complex product
# ---------------------------------------------------------------------------
def spectral_shapes(configs):
    """Phase 16's shapes (name, B, H, O, spatial, modes, per_mode): phase
    2's odd extents at ranks 1–3 with shared and per-mode W, fno2d at full
    width and fno2d-large (per-mode W) at full width, B=8."""
    odd = [c for c in check_shapes(configs) if c[0].startswith("odd")]
    shapes = [c + (False,) for c in odd]
    shapes += [(f"{c[0]}_per_mode",) + c[1:] + (True,) for c in odd]
    full, big = configs.get_config("fno2d"), configs.get_config(LARGE)
    shapes.append(("fno2d_B8", 8, full.hidden, full.hidden, full.spatial,
                   full.modes, False))
    shapes.append(("fno2d_large_B8", 8, big.hidden, big.hidden, big.spatial,
                   big.modes, True))
    return shapes


def spectral_inputs(torch, b, h, o, spatial, modes, per_mode, seed):
    """x [B,H,s…], gy [B,O,s…] and wr, wi (shared [O,H] or per-mode
    [O,H,k…], scaled 1/H) in f32 on the card."""
    if per_mode:
        x, wr, wi = per_mode_inputs(b, h, o, spatial, modes, seed,
                                    DEVICE)[:3]
    else:
        x, wr, wi = block_inputs(b, h, o, spatial, seed, DEVICE)[:3]
    gy = torch.randn((b, o) + tuple(spatial),
                     generator=torch.Generator().manual_seed(seed)).to(DEVICE)
    return x, gy, wr, wi


def spectral_launches(engine, x, gy, wr, wi, mats):
    """The bare layer's launches as the spectral-only path issues them,
    each as fn(plain) running the kernel or its plain version: the
    forward; dx from gy through the adjoint bundle with the weights'
    transposed view (counted spectral_dx); the bypass-free wgrad (per mode
    for per-mode weights)."""
    wrt, wit = wr.transpose(0, 1), wi.transpose(0, 1)
    block = lambda plain: (engine.fused_block_plain if plain
                           else engine.fused_block)
    return {
        "spectral_fwd": lambda plain: block(plain)(
            x, wr, wi, None, None, mats["forward"], act="linear"),
        "spectral_dx": lambda plain: block(plain)(
            gy, wrt, wit, None, None, mats["adjoint"], act="linear",
            **({} if plain else {"adjoint": True})),
        "spectral_wgrad": lambda plain: (
            engine.fused_wgrad_plain if plain else engine.fused_wgrad)(
                x, gy, mats["wgrad"], per_mode=wr.ndim > 2,
                with_bypass=False),
    }


def cgemm_planes(torch, m, k, n, seed):
    """ar, ai [M,K], br, bi [K,N] in f32 on the card."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(DEVICE)
            for s in ((m, k), (m, k), (k, n), (k, n))]


def phase_spectral_vs_plain(torch, engine, spectral, configs, ops,
                            cgemm_k):
    """The bare layer's three launches and the complex product against
    their plain versions (f32 ≤ 2e-4 on the same inputs, bf16 ≤ 2e-2 of
    the f32 plain version); then ``ops.cgemm`` driven at the FNO's CGEMM
    shapes with the counts set to 0: its launches."""
    log("== phase 16: kernel vs plain on the card, spectral-only launches "
        "and cgemm")
    errs = {}
    for seed, (name, b, h, o, spatial, modes, pm) in enumerate(
            spectral_shapes(configs)):
        ins32 = spectral_inputs(torch, b, h, o, spatial, modes, pm,
                                900 + seed)
        run32 = spectral_launches(engine, *ins32, backward_mats(
            spectral, spatial, modes, "float32"))
        ins16 = [a.to(torch.bfloat16) for a in ins32]
        run16 = spectral_launches(engine, *ins16, backward_mats(
            spectral, spatial, modes, "bfloat16"))
        for kind in run32:
            ref = as_tuple(run32[kind](True))
            errs[(name, kind, "float32")] = e = errors(
                as_tuple(run32[kind](False)), ref)
            check(f"{name} f32 {kind} vs plain", e[1], F32_TOL)
            errs[(name, kind, "bfloat16")] = e = errors(
                as_tuple(run16[kind](False)), ref)
            check(f"{name} bf16 {kind} vs f32 plain", e[1], BF16_TOL)
            del ref
        del ins32, ins16, run32, run16
    for seed, (m, k, n) in enumerate(CGEMM_SHAPES):
        planes = cgemm_planes(torch, m, k, n, 950 + seed)
        ref = cgemm_k.cgemm_plain(*planes)
        for dt, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
            out = cgemm_k.cgemm(*[p.to(getattr(torch, dt)) for p in planes])
            errs[((m, k, n), "cgemm", dt)] = e = errors(out, ref)
            check(f"cgemm ({m},{k},{n}) {dt} vs f32 plain", e[1], tol)
    # ops.cgemm, the standalone op (no model path runs it, in the
    # reference neither), driven once per FNO CGEMM shape and precision.
    counts = {}
    for mkn in CGEMM_FNO:
        ins = [[p.to(getattr(torch, dt)) for p in
                cgemm_planes(torch, *mkn, 970)] for dt in DTYPES]
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        outs = [ops.cgemm(*planes) for planes in ins]
        torch.cuda.synchronize()
        counts[mkn] = dict(engine.LAUNCHES)
        want = {("cgemm", dt): 1 for dt in DTYPES}
        log(f"  ops.cgemm {mkn}: launches {counts[mkn]}")
        if counts[mkn] != want or not all(bool(torch.isfinite(c).all())
                                          for pair in outs for c in pair):
            raise AssertionError(f"ops.cgemm {mkn} launches {counts[mkn]} "
                                 f"!= {want}, or non-finite")
    return errs, counts


def phase_serve_spectral(torch, np, configs, sfs, engine, servers):
    """fno2d at full width with fuse_block off, both variants: phase 3's
    12 requests against the staged path, with exact launch counts."""
    log("== phase 17: serve fno2d spectral-only (fuse_block off), full "
        "width, full and partial")
    cfg = dataclasses.replace(servers["fused"].cfg, fuse_block=False)
    c16 = configs.with_precision(cfg, "bf16")
    params = servers["fused"].params
    names = {"full": ("spectral", "spectral_bf16"),
             "partial": ("spectral_partial", "spectral_partial_bf16")}
    for variant, (n32, n16) in names.items():
        for name, c in ((n32, cfg), (n16, c16)):
            servers[name] = sfs.FNOServer(c, params, device=DEVICE,
                                          variant=variant, max_batch=8)
    shape = (cfg.in_channels,) + tuple(cfg.spatial)
    for pair in names.values():  # build and capture outside the count
        for name in pair:
            servers[name].warm((1, 4))
    counts = {}
    for variant, kinds in (("full", ("spectral_fwd",)),
                           ("partial", engine.PARTIAL_KINDS)):
        n32, n16 = names[variant]
        plan = [(x, k, n16 if bf16 else n32)
                for x, k, bf16 in serve_requests(torch, np, shape)]
        expect = expected_launches(plan, kinds, cfg.num_layers,
                                   servers[n32].buckets[-1])
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        outs = [servers[name](x, rollout_steps=k) for x, k, name in plan]
        torch.cuda.synchronize()
        counts[variant] = dict(engine.LAUNCHES)
        log(f"  {variant}: launches {counts[variant]} expected {expect}")
        if counts[variant] != expect:
            raise AssertionError(f"kernel launches {counts[variant]} != "
                                 f"{expect}")
        for (x, k, name), y in zip(plan, outs):
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"non-finite serve output ({name}, "
                                     f"K={k})")
            check(f"serve {name} n={x.shape[0]} K={k} vs staged f32",
                  rel_err(y, servers["staged"](x, rollout_steps=k)),
                  BF16_TOL if name == n16 else F32_TOL)
        del outs
    return counts, names


def phase_spectral_times(torch, engine, spectral, ops, configs, cgemm_k,
                         errs, serve_counts, train_counts, cgemm_counts):
    """CUDA events for the bare layer's launches at fno2d B=8 (shared W)
    and fno2d-large B=8 (per-mode W) and for the complex product at the
    FNO's CGEMM shapes, beside the plain versions, a library call where
    one computes the same function, and the bounds. Per-mode rows carry
    their bf16 times as extra keys: fno2d-large trains spectral-only in
    f32 only, so its bf16 launches are on no driven path."""
    log("== phase 19: times — spectral-only launches at fno2d and "
        "fno2d-large B=8, cgemm")
    rows = []
    for arch, pm in (("fno2d", False), (LARGE, True)):
        c = configs.get_config(arch)
        b, h, o = 8, c.hidden, c.hidden
        key = "fno2d_large_B8" if pm else "fno2d_B8"
        ins32 = spectral_inputs(torch, b, h, o, c.spatial, c.modes, pm, 960)
        by_kind = {}
        for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                             ("bfloat16", PEAK_BF16_FLOPS, 2)):
            x, gy, wr, wi = [a.to(getattr(torch, dt)) for a in ins32]
            launch = spectral_launches(engine, x, gy, wr, wi, backward_mats(
                spectral, c.spatial, c.modes, dt))
            fft_ms = time_ms(lambda: ops.spectral_layer_nd(
                x, wr, wi, c.modes, path="ref"), 5)
            for kind, fn in launch.items():
                t_bytes, t_ops = bound_parts(kind, b, h, o, c.spatial,
                                             c.modes, eb, peak, per_mode=pm)
                bms, by = bound_ms(kind, b, h, o, c.spatial, c.modes, eb,
                                   peak, per_mode=pm)
                t = {"ms": time_ms(lambda: fn(False), 10),
                     "plain_ms": time_ms(lambda: fn(True), 5),
                     "bound_ms": bms, "bound_by": by,
                     "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
                     "max_abs_err": errs[(key, kind, dt)][0],
                     "scaled_err": errs[(key, kind, dt)][1]}
                by_kind[(kind, dt)] = t
                log(f"  {arch} {dt} {kind}: kernel_ms={t['ms']:.4f} "
                    f"plain_ms={t['plain_ms']:.4f} torch_fft_layer_ms="
                    f"{fft_ms:.4f} bound_us={1e3 * bms:.2f} ({by}; bytes "
                    f"{1e3 * t_bytes:.2f} us, operations "
                    f"{1e3 * t_ops:.2f} us)")
                if kind == "spectral_fwd":
                    t["torch_fft_layer_ms"] = fft_ms
            del x, gy, wr, wi, launch
        del ins32
        tc = train_counts[(arch, "full")]
        for kind in SPECTRAL:
            for dt in (("float32",) if pm else DTYPES):
                t = by_kind[(kind, dt)]
                suffix = "_per_mode" if pm else (
                    "_fno2d" if kind == "spectral_fwd" else "")
                row = {
                    "name": f"{kind}{suffix}_"
                            f"{'f32' if dt == 'float32' else 'bf16'}",
                    "route": "cuda",
                    "source": (WGRAD_SOURCE if kind == "spectral_wgrad"
                               else BLOCK_SOURCE),
                    "replaces": (WGRAD_REPLACES if kind == "spectral_wgrad"
                                 else BLOCK_REPLACES),
                    "shape": f"{arch} B=8",
                    "launches": (serve_counts["full"].get((kind, dt), 0)
                                 if kind == "spectral_fwd" and not pm
                                 else tc[dt].get((kind, dt), 0)),
                    "launches_train": tc[dt].get((kind, dt), 0),
                    "tol": F32_TOL if dt == "float32" else BF16_TOL,
                    "library_ms": None,
                    "library_note": "no single PyTorch call computes it",
                    **t}
                if pm:  # bf16 beside the f32 row
                    t16 = by_kind[(kind, "bfloat16")]
                    row.update({f"{k}_bf16": t16[k] for k in
                                ("ms", "plain_ms", "bound_ms",
                                 "max_abs_err", "scaled_err")})
                rows.append(row)
    for seed, (m, k, n) in enumerate(CGEMM_FNO):
        planes32 = cgemm_planes(torch, m, k, n, 980 + seed)
        a_c = torch.complex(planes32[0], planes32[1])  # built beforehand
        b_c = torch.complex(planes32[2], planes32[3])
        lib_ms = time_ms(lambda: torch.matmul(a_c, b_c), 20, queued=True)
        lib_paced = time_ms(lambda: torch.matmul(a_c, b_c), 20)
        for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                             ("bfloat16", PEAK_BF16_FLOPS, 2)):
            planes = [p.to(getattr(torch, dt)) for p in planes32]
            kms = time_ms(lambda: cgemm_k.cgemm(*planes), 20, queued=True)
            paced = time_ms(lambda: cgemm_k.cgemm(*planes), 20)
            pms = time_ms(lambda: cgemm_k.cgemm_plain(*planes), 10,
                          queued=True)
            t_bytes, t_ops = cgemm_bound_parts(m, k, n, eb, peak)
            bms, by = cgemm_bound(m, k, n, eb, peak)
            lib = lib_ms if dt == "float32" else None
            log(f"  cgemm ({m},{k},{n}) {dt}: kernel_ms={kms:.4f} plain_ms="
                f"{pms:.4f} library_ms={lib} bound_us={1e3 * bms:.2f} "
                f"({by}); paced by the host: kernel_ms={paced:.4f} "
                f"library_ms={lib_paced:.4f}")
            e = errs[((m, k, n), "cgemm", dt)]
            rows.append({
                "name": f"cgemm_{m}x{k}x{n}_"
                        f"{'f32' if dt == 'float32' else 'bf16'}",
                "route": "cuda", "source": CGEMM_SOURCE,
                "replaces": CGEMM_REPLACES, "shape": f"M={m} K={k} N={n}",
                "launches": cgemm_counts[(m, k, n)].get(("cgemm", dt), 0),
                "launches_note": "ops.cgemm driven once at this shape; no "
                                 "model path runs it (nor the reference's)",
                "max_abs_err": e[0], "scaled_err": e[1],
                "tol": F32_TOL if dt == "float32" else BF16_TOL,
                "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
                "library_ms": lib, "ms_host_paced": paced,
                "timing": "queued behind a device spin: device time only",
                "library_note": ("torch.matmul on complex64 tensors built "
                                 "beforehand" if lib is not None else
                                 "no complex bf16 product in PyTorch")})
        del planes32, a_c, b_c
    return rows


# ---------------------------------------------------------------------------
# fno3d at full width on every fused path, and the linear (TP-partial) block
# ---------------------------------------------------------------------------
def fno3d_shapes(configs):
    """Phase 20's fno3d shapes: full width at B=1 and B=8."""
    f3 = configs.get_config(FNO3D)
    return [(f"fno3d_B{b}", b, f3.hidden, f3.hidden, f3.spatial, f3.modes)
            for b in (1, 8)]


def linear_shapes(configs):
    """The linear block's shapes: phase 2's odd extents at ranks 1–3, fno2d
    and fno3d at full width, B=8."""
    shapes = [c for c in check_shapes(configs) if c[0].startswith("odd")]
    shapes.append(next(c for c in check_shapes(configs)
                       if c[0] == "fno2d_B8"))
    return shapes + fno3d_shapes(configs)[1:]


def linear_block(engine, args, mats, f32, plain=False):
    """The linear (TP-partial) block launch: wb, the bias, no activation,
    y in f32 — or its plain version."""
    fn = engine.fused_block_plain if plain else engine.fused_block
    return fn(*args, mats, act="linear", out_dtype=f32)


def cluster_waves(engine, build, configs):
    """The card's answer for fno3d's plans: how many clusters of the
    block and wgrad kernels it holds at once, and the waves B=8 takes."""
    f3 = configs.get_config(FNO3D)
    h, spatial, modes = f3.hidden, f3.spatial, f3.modes
    waves = {}
    for dt, code in (("float32", 0), ("bfloat16", 1)):
        for kind, lib, pick, prefix in (
                ("block", build.load_fused_block(), engine.pick_plan,
                 "fused_block"),
                ("wgrad", build.load_fused_wgrad(), engine.pick_wgrad_plan,
                 "fused_wgrad")):
            plan = pick(lib, code, 8, h, h, spatial, modes)
            fits = engine._max_clusters(lib, prefix, code, len(spatial),
                                        plan["cluster"], plan["smem"])
            if fits < 1:
                raise AssertionError(f"fno3d {kind} {dt}: the card holds no "
                                     f"cluster of plan {plan}")
            waves[f"{kind} {dt}"] = {"plan": plan, "clusters_at_once": fits,
                                     "waves_at_B8": -(-8 // fits)}
            log(f"  fno3d {kind} {dt}: plan {plan}; the card holds {fits} "
                f"clusters of {plan['cluster']} at once: B=8 takes "
                f"{-(-8 // fits)} wave(s)")
    return waves


def phase_fno3d_vs_plain(torch, engine, spectral, dft, ops, configs, build):
    """fno3d's launches at full width (the partial variant's at B=8, the
    served and trained batch; phase 8 checks them at B=1) and the linear
    block against their plain versions, the card's cluster occupancy,
    and the linear block driven through ``ops.fno_block_nd`` with its
    launches counted."""
    log("== phase 20: kernel vs plain on the card, fno3d full width and "
        "the linear (TP-partial) block")
    waves = cluster_waves(engine, build, configs)
    errs = {}
    bf16 = torch.bfloat16
    for seed, (name, b, h, o, spatial, modes) in enumerate(
            fno3d_shapes(configs)):
        args32 = block_inputs(b, h, o, spatial, 1000 + seed, DEVICE)
        gy32 = torch.randn((b, o) + tuple(spatial),
                           generator=torch.Generator().manual_seed(1000 + seed)
                           ).to(DEVICE)
        m32 = backward_mats(spectral, spatial, modes, "float32")
        m16 = backward_mats(spectral, spatial, modes, "bfloat16")
        x, wr, wi = args32[:3]
        # f32: each launch against its plain version on the same inputs.
        y, gz, dx, dw = run_block(engine, args32, gy32, m32)
        py, pgz, pdx, pdw = run_block(engine, args32, gy32, m32, plain=True,
                                      gz=gz)
        got = {"block_fwd": ([y], [py]), "gz_recompute": ([gz], [pgz]),
               "dx_adjoint": ([dx], [pdx]), "wgrad": (dw, pdw)}
        for kind, fn in spectral_launches(engine, x, gy32, wr, wi,
                                          m32).items():
            got[kind] = (as_tuple(fn(False)), as_tuple(fn(True)))
        torch.cuda.synchronize()
        for kind, (a, ref) in got.items():
            errs[(name, kind, "float32")] = e = errors(a, ref)
            check(f"{name} f32 {kind} vs plain", e[1], F32_TOL)
        del y, gz, dx, dw, py, pgz, pdx, pdw, got
        # bf16: the kernels' chain against the f32 plain chain.
        ref = dict(zip(engine.KINDS, run_block(engine, args32, gy32, m32,
                                               plain=True)))
        ours = dict(zip(engine.KINDS, run_block(
            engine, [a.to(bf16) for a in args32], gy32.to(bf16), m16)))
        sp32 = spectral_launches(engine, x, gy32, wr, wi, m32)
        sp16 = spectral_launches(engine, *[a.to(bf16) for a in
                                           (x, gy32, wr, wi)], m16)
        for kind in SPECTRAL:
            ref[kind], ours[kind] = sp32[kind](True), sp16[kind](False)
        torch.cuda.synchronize()
        for kind in ours:
            errs[(name, kind, "bfloat16")] = e = errors(
                as_tuple(ours[kind]), as_tuple(ref[kind]))
            check(f"{name} bf16 {kind} vs f32 plain", e[1], BF16_TOL)
        del ref, ours, sp32, sp16
    name, b, h, o, spatial, modes = fno3d_shapes(configs)[1]
    check_partial(torch, partial_cases(torch, spectral, dft, engine, b, h, o,
                                       spatial, modes, 1040), name, errs)
    # The linear block: wb, a bias, no activation, f32 out.
    f32 = torch.float32
    for seed, (name, b, h, o, spatial, modes) in enumerate(
            linear_shapes(configs)):
        args32 = block_inputs(b, h, o, spatial, 1050 + seed, DEVICE)
        m32 = spectral.operand_tensors(spatial, modes, "float32", DEVICE)
        m16 = spectral.operand_tensors(spatial, modes, "bfloat16", DEVICE)
        ref = linear_block(engine, args32, m32, f32, plain=True)
        y = linear_block(engine, args32, m32, f32)
        y16 = linear_block(engine, [a.to(bf16) for a in args32], m16, f32)
        torch.cuda.synchronize()
        if y.dtype != f32 or y16.dtype != f32:
            raise AssertionError(f"linear block emitted {y16.dtype}, not f32")
        errs[(name, "block_linear", "float32")] = e = errors([y], [ref])
        check(f"{name} f32 block_linear (bias, f32 out) vs plain", e[1],
              F32_TOL)
        errs[(name, "block_linear", "bfloat16")] = e = errors([y16], [ref])
        check(f"{name} bf16 block_linear (bias, f32 out) vs f32 plain",
              e[1], BF16_TOL)
    linear_counts = drive_linear_block(torch, engine, ops, configs)
    return errs, waves, linear_counts


def drive_linear_block(torch, engine, ops, configs):
    """``ops.fno_block_nd(act="linear", out_dtype=f32)`` forward and
    backward once per precision at fno2d and fno3d B=8 (f32 master
    leaves), with the counts set to 0 just before: one block_linear, one
    dx_adjoint and one wgrad each, no gz_recompute; the output and every
    grad against the staged path's autograd (f32 ≤ 2e-4, bf16 output
    ≤ 2e-2 and grads ≤ 5e-2, each leaf to its own magnitude)."""
    counts = {}
    for name, b, h, o, spatial, modes in linear_shapes(configs)[-2:]:
        x, wr, wi, wb, bias = block_inputs(b, h, o, spatial, 1080, DEVICE)
        leaves = lambda: [a.detach().clone().requires_grad_(True)
                          for a in (x, wr, wi, wb, bias.reshape(-1))]
        staged = leaves()
        y_ref = ops.fno_block_nd(*staged, modes, path="staged", act="linear")
        g_ref = torch.autograd.grad(torch.sin(y_ref).sum(), staged)
        runs = {}
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        for preset in ("f32", "bf16"):
            ls = leaves()
            y = ops.fno_block_nd(
                *ls, modes, policy=configs.PrecisionPolicy.from_name(preset),
                act="linear", out_dtype=torch.float32)
            runs[preset] = (y, torch.autograd.grad(torch.sin(y).sum(), ls))
        torch.cuda.synchronize()
        counts[name] = dict(engine.LAUNCHES)
        want = {(k, dt): 1 for k in engine.LINEAR_KINDS for dt in DTYPES}
        log(f"  {name} ops.fno_block_nd(act='linear') forward+backward, f32 "
            f"and bf16: launches {counts[name]}")
        if counts[name] != want:
            raise AssertionError(f"linear block launches {counts[name]} != "
                                 f"{want}")
        for preset, (y, g) in runs.items():
            fwd_tol, grad_tol = ((F32_TOL, F32_TOL) if preset == "f32"
                                 else (BF16_TOL, BF16_GRAD_TOL))
            if y.dtype != torch.float32:
                raise AssertionError(f"linear block {preset} emitted "
                                     f"{y.dtype}")
            check(f"{name} {preset} linear block vs staged",
                  rel_err(y.detach(), y_ref.detach()), fwd_tol)
            for leaf, a, r in zip(("x", "wr", "wi", "wb", "bias"), g, g_ref):
                check(f"{name} {preset} linear block grad {leaf} vs staged",
                      leaf_err(a, r), grad_tol)
    return counts


def phase_serve_fno3d(torch, np, configs, fno_mod, sfs, engine):
    """fno3d at full width in the four fused designs: phase 3's 12
    requests against the staged path with exact launch counts (the
    staged outputs are computed once for all designs)."""
    log("== phase 21: serve fno3d at full width, every fused design")
    base = configs.get_config(FNO3D)
    log(f"  config: hidden={base.hidden} layers={base.num_layers} "
        f"spatial={base.spatial} modes={base.modes} params "
        f"{base.param_count()}")
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), base, DEVICE)
    staged = sfs.FNOServer(dataclasses.replace(base, path="staged",
                                               fuse_block=False), params,
                           device=DEVICE, max_batch=8)
    shape = (base.in_channels,) + tuple(base.spatial)
    reqs = serve_requests(torch, np, shape)
    refs = [staged(x, rollout_steps=k) for x, k, _ in reqs]
    servers, counts = {}, {}
    for design, (fuse, variant) in FNO3D_DESIGNS.items():
        c = dataclasses.replace(configs.with_fuse_block(base, fuse),
                                path="fused")
        names = (f"{design} f32", f"{design} bf16")
        for name, cc in zip(names, (c, configs.with_precision(c, "bf16"))):
            srv = servers[name] = sfs.FNOServer(cc, params, device=DEVICE,
                                                variant=variant, max_batch=8)
            srv.warm((1, 4))  # build and capture outside the count
        kinds = ((engine.KINDS[0] if fuse else engine.SPECTRAL_KINDS[0],)
                 if variant == "full" else engine.PARTIAL_KINDS)
        plan = [(x, k, names[1] if bf16 else names[0])
                for x, k, bf16 in reqs]
        expect = expected_launches(plan, kinds, base.num_layers,
                                   servers[names[0]].buckets[-1])
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        outs = [servers[name](x, rollout_steps=k) for x, k, name in plan]
        torch.cuda.synchronize()
        counts[design] = dict(engine.LAUNCHES)
        log(f"  {design}: launches {counts[design]} expected {expect}")
        if counts[design] != expect:
            raise AssertionError(f"kernel launches {counts[design]} != "
                                 f"{expect}")
        for (x, k, name), y, ref in zip(plan, outs, refs):
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"non-finite serve output ({name}, "
                                     f"K={k})")
            check(f"serve fno3d {name} n={x.shape[0]} K={k} vs staged f32",
                  rel_err(y, ref), BF16_TOL if name == names[1] else F32_TOL)
        del outs
    return counts, servers


def fno3d_partial_times(torch, engine, spectral, dft, configs, errs,
                        serve_counts, train_counts):
    """The partial variant's launches at fno3d B=8 (rdft and irdft over
    the outer 64×64 axes, the core over s_1): CUDA events beside the
    plain version, the torch.fft call (none for the core) and the bound;
    launches summed over the two partial designs of phases 21 and 22."""
    f3 = configs.get_config(FNO3D)
    b, h, o = 8, f3.hidden, f3.hidden
    spatial, modes = f3.spatial, f3.modes
    cases = partial_cases(torch, spectral, dft, engine, b, h, o, spatial,
                          modes, 1220)
    designs = ("block partial", "spectral partial")
    rows = []
    for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                         ("bfloat16", PEAK_BF16_FLOPS, 2)):
        for kind in ("rdft", "core", "irdft"):
            fn, plain, ins, mats = cases[kind]
            a = [x.to(getattr(torch, dt)) for x in ins]
            m = mats[dt]
            lib = library_call(torch, kind, ins, spatial, modes)
            # Device time only (queued), the core too.
            kms = time_ms(lambda: fn(*a, *m), 10, queued=True)
            pms = time_ms(lambda: plain(*a, *m), 3, queued=True)
            lms = time_ms(lib, 10, queued=True) if lib else None
            core = {}
            if kind == "core":  # as the first core was timed
                core = {"ms_host_paced": time_ms(lambda: fn(*a, *m), 10)}
                wb = core_w_bytes(engine, torch, dt, b, h, o, spatial, modes)
                log(f"  {dt} core fno3d B=8: host-paced kernel_ms="
                    f"{core['ms_host_paced']:.4f}; planned W bytes a launch "
                    f"{wb}")
            t_bytes, t_ops = bound_parts(kind, b, h, o, spatial, modes, eb,
                                         peak)
            bms, by = bound_ms(kind, b, h, o, spatial, modes, eb, peak)
            launches = sum(serve_counts[d].get((kind, dt), 0)
                           for d in designs)
            train = sum(train_counts[d][dt].get((kind, dt), 0)
                        for d in designs)
            e = errs[("fno3d_B8", kind, dt)]
            log(f"  {dt} {kind} fno3d B=8: kernel_ms={kms:.4f} plain_ms="
                f"{pms:.4f} library_ms={lms} bound_us={1e3 * bms:.2f} "
                f"({by}); launches {launches} served, {train} in 20 "
                f"training steps")
            rows.append({
                "name": f"{kind}_fno3d_{'f32' if dt == 'float32' else 'bf16'}",
                "route": "cuda",
                "source": CORE_SOURCE if kind == "core" else ROWS_SOURCE,
                "replaces": PARTIAL_REPLACES[kind],
                "shape": "fno3d B=8", "launches": launches,
                "launches_train": train,
                "launches_note": "summed over the whole-block and "
                                 "spectral-only partial designs",
                "max_abs_err": e[0], "scaled_err": e[1],
                "tol": F32_TOL if dt == "float32" else BF16_TOL,
                "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
                "library_ms": lms, **core,
                **({"library_note": "no single PyTorch call computes "
                                    "cDFT_s1 -> CGEMM -> icDFT_s1"}
                   if kind == "core" else {})})
    del cases
    return rows


def phase_fno3d_times(torch, engine, spectral, dft, ops, configs, errs,
                      serve_counts, train_counts, linear_counts):
    """CUDA events at fno3d B=8 for each launch of the four designs and
    the linear block, beside the plain version, the library call (the
    row launches' torch.fft call; for a fused launch, where no single
    PyTorch call computes it, the staged torch.fft block or layer as a
    yardstick) and the bound."""
    log("== phase 23: times — fno3d launches at B=8")
    f3 = configs.get_config(FNO3D)
    b, h, o = 8, f3.hidden, f3.hidden
    spatial, modes = f3.spatial, f3.modes
    args32 = block_inputs(b, h, o, spatial, 1200, DEVICE)
    gy32 = torch.randn((b, o) + tuple(spatial),
                       generator=torch.Generator().manual_seed(1201)
                       ).to(DEVICE)
    # Where each kind's launches on the main path were counted: the served
    # forward's (serve) and the training step's (train) design.
    served = {"block_fwd": "block full", "spectral_fwd": "spectral full"}
    rows = []
    for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                         ("bfloat16", PEAK_BF16_FLOPS, 2)):
        tdt = getattr(torch, dt)
        args = [a.to(tdt) for a in args32]
        x, wr, wi, wb, bias = args
        gy = gy32.to(tdt)
        mats = backward_mats(spectral, spatial, modes, dt)
        gz = engine.fused_block(*args, mats["forward"], act="gelu_vjp", gy=gy)
        launch = block_launches(engine, args, gy, gz, mats)
        launch.update(spectral_launches(engine, x, gy, wr, wi, mats))
        launch["block_linear"] = lambda plain: linear_block(
            engine, args, mats["forward"], torch.float32, plain)
        bias1 = bias.reshape(-1)
        fft_block = time_ms(lambda: ops.fno_block_nd(
            x, wr, wi, wb, bias1, modes, path="ref"), 5)
        fft_layer = time_ms(lambda: ops.spectral_layer_nd(
            x, wr, wi, modes, path="ref"), 5)
        # The block forward at B=1 and at B=7 (one wave of the 7 clusters
        # of 16 the card holds) beside B=8 (two waves).
        waves = {f"ms_b{n}": time_ms(lambda: engine.fused_block(
            x[:n], wr, wi, wb, bias, mats["forward"]), 10) for n in (1, 7)}
        log(f"  {dt} block_fwd fno3d by batch: {waves}")
        # The wgrad at B=1 and B=7 (one wave), and its staged yardstick
        # with and without the bypass.
        wwaves = {f"ms_b{n}": time_ms(lambda: engine.fused_wgrad(
            x[:n], gz[:n], mats["wgrad"]), 10) for n in (1, 7)}
        staged = {k: staged_wgrad_ms(torch, x, g, modes, bypass=k == "wgrad")
                  for k, g in (("wgrad", gz), ("spectral_wgrad", gy))}
        log(f"  {dt} wgrad fno3d by batch: {wwaves}; staged (f32 copies, "
            f"queued): {staged}")
        for kind, fn in launch.items():
            kms = time_ms(lambda: fn(False), 10)
            pms = time_ms(lambda: fn(True), 3)
            t_bytes, t_ops = bound_parts(kind, b, h, o, spatial, modes, eb,
                                         peak)
            bms, by = bound_ms(kind, b, h, o, spatial, modes, eb, peak)
            fft = fft_layer if kind in SPECTRAL else fft_block
            design = "spectral full" if kind in SPECTRAL else "block full"
            if kind == "block_linear":
                launches = linear_counts["fno3d_B8"].get((kind, dt), 0)
                train = None
            else:
                train = train_counts[design][dt].get((kind, dt), 0)
                launches = (serve_counts[served[kind]].get((kind, dt), 0)
                            if kind in served else train)
            e = errs[("fno3d_B8", kind, dt)]
            log(f"  {dt} {kind} fno3d B=8: kernel_ms={kms:.4f} plain_ms="
                f"{pms:.4f} torch_fft_ms={fft:.4f} bound_us={1e3 * bms:.2f} "
                f"({by}; bytes {1e3 * t_bytes:.2f} us, operations "
                f"{1e3 * t_ops:.2f} us); launches {launches} served/driven, "
                f"{train} in 20 training steps")
            wgrad = kind in ("wgrad", "spectral_wgrad")
            rows.append({
                "name": f"{kind}_fno3d_{'f32' if dt == 'float32' else 'bf16'}",
                "route": "cuda",
                "source": WGRAD_SOURCE if wgrad else BLOCK_SOURCE,
                "replaces": WGRAD_REPLACES if wgrad else BLOCK_REPLACES,
                "shape": "fno3d B=8", "launches": launches,
                "launches_train": train,
                **({"launches_note": "ops.fno_block_nd(act='linear') driven "
                                     "forward and backward once at this "
                                     "shape"}
                   if kind == "block_linear" else {}),
                "max_abs_err": e[0], "scaled_err": e[1],
                "tol": F32_TOL if dt == "float32" else BF16_TOL,
                "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
                "library_ms": None,
                "library_note": "no single PyTorch call computes it",
                ("torch_fft_layer_ms" if kind in SPECTRAL
                 else "torch_fft_ms"): fft,
                **(waves if kind == "block_fwd" else {}),
                **(wwaves if kind == "wgrad" else {}),
                **({"torch_staged_ms": staged[kind]} if wgrad else {})})
        del args, gz, launch
    rows += fno3d_partial_times(torch, engine, spectral, dft, configs, errs,
                                serve_counts, train_counts)
    # The linear block at fno2d B=8 (its other driven shape).
    c2 = configs.get_config("fno2d")
    args32 = block_inputs(8, c2.hidden, c2.hidden, c2.spatial, 1210, DEVICE)
    for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                         ("bfloat16", PEAK_BF16_FLOPS, 2)):
        args = [a.to(getattr(torch, dt)) for a in args32]
        mats = spectral.operand_tensors(c2.spatial, c2.modes, dt, DEVICE)
        run = lambda plain: linear_block(engine, args, mats, torch.float32,
                                         plain)
        kms, pms = time_ms(lambda: run(False), 20), time_ms(
            lambda: run(True), 10)
        bms, by = bound_ms("block_linear", 8, c2.hidden, c2.hidden,
                           c2.spatial, c2.modes, eb, peak)
        e = errs[("fno2d_B8", "block_linear", dt)]
        log(f"  {dt} block_linear fno2d B=8: kernel_ms={kms:.4f} plain_ms="
            f"{pms:.4f} bound_us={1e3 * bms:.2f} ({by})")
        rows.append({
            "name": "block_linear_fno2d_"
                    f"{'f32' if dt == 'float32' else 'bf16'}",
            "route": "cuda", "source": BLOCK_SOURCE,
            "replaces": BLOCK_REPLACES, "shape": "fno2d B=8",
            "launches": linear_counts["fno2d_B8"].get(("block_linear", dt),
                                                      0),
            "launches_note": "ops.fno_block_nd(act='linear') driven forward "
                             "and backward once at this shape",
            "max_abs_err": e[0], "scaled_err": e[1],
            "tol": F32_TOL if dt == "float32" else BF16_TOL,
            "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "library_note": "no single PyTorch call computes it"})
    log(f"  max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    return rows


def ends_dims(cfg):
    """(C_in, L, Lp, C_out) of a preset's model ends: both MLPs are
    lifting_dim wide (2·hidden by default)."""
    lw = cfg.lifting_dim or 2 * cfg.hidden
    return cfg.in_channels, lw, lw, cfg.out_channels


def ends_inputs(torch, cfg, b, seed):
    """x (the hidden input), x_in (the raw input), the block's operands
    [wr, wi, wb, bias] and the two ends in the kernel's layout (lift
    (l1 [L,C_in], b1 [L,1], l2 [H,L], b2 [H,1]), proj (p1 [Lp,H],
    b1 [Lp,1], p2 [C_out,Lp], b2 [C_out,1])), f32 on the card."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.tensor(sc * rng.normal(size=s),
                                         dtype=torch.float32, device=DEVICE)
    h, spatial = cfg.hidden, tuple(cfg.spatial)
    cin, lw, lp, cout = ends_dims(cfg)
    wshape = (h, h) + (tuple(cfg.modes) if cfg.weight_mode == "per_mode"
                       else ())
    block = [mk(*wshape, sc=1.0 / h), mk(*wshape, sc=1.0 / h),
             mk(h, h, sc=1.0 / h), mk(h, 1, sc=0.3)]
    lift = (mk(lw, cin, sc=0.7), mk(lw, 1, sc=0.3), mk(h, lw, sc=lw ** -0.5),
            mk(h, 1, sc=0.3))
    proj = (mk(lp, h, sc=h ** -0.5), mk(lp, 1, sc=0.3),
            mk(cout, lp, sc=lp ** -0.5), mk(cout, 1, sc=0.3))
    return mk(b, h, *spatial), mk(b, cin, *spatial), block, lift, proj


def ends_launch(engine, which, x, xin, block, lift, proj, mats,
                plain=False):
    """The lift, proj or both launch of the block kernel (or its plain
    version) on the inputs of ``ends_inputs``."""
    fn = engine.fused_block_plain if plain else engine.fused_block
    if which == "lift":
        return fn(xin, *block, mats, lift=lift)
    if which == "proj":
        return fn(x, *block, mats, proj=proj)
    return fn(xin, *block, mats, lift=lift, proj=proj)


def ends_dims_of(which, cfg):
    """``bound_parts``' ends=(C_in, L, Lp, C_out) of one ends launch."""
    cin, lw, lp, cout = ends_dims(cfg)
    return (cin, lw if which != "proj" else 0, lp if which != "lift" else 0,
            cout)


def phase_ends_vs_plain(torch, engine, spectral, configs):
    """The block kernel's ends mode against its plain version at fno2d,
    fno3d (B=8) and fno2d-large (per-mode W, B=1 and B=8) full width: the
    lift, the projection and both in one launch, f32 ≤ 2e-4 and bf16
    ≤ 2e-2 of the f32 plain version."""
    log("== phase 24: kernel vs plain on the card, the fused model ends")
    errs = {}
    bf16 = torch.bfloat16
    for seed, arch in enumerate(ENDS_ARCHS):
        cfg = configs.get_config(arch)
        spatial, modes = cfg.spatial, cfg.modes
        m32 = spectral.operand_tensors(spatial, modes, "float32", DEVICE)
        m16 = spectral.operand_tensors(spatial, modes, "bfloat16", DEVICE)
        for b in ((1, 8) if arch == LARGE else (8,)):
            x, xin, block, lift, proj = ends_inputs(torch, cfg, b,
                                                    2400 + seed)
            c16 = lambda ts: [t.to(bf16) for t in ts]
            for which in ENDS:
                ref = ends_launch(engine, which, x, xin, block, lift, proj,
                                  m32, plain=True)
                y = ends_launch(engine, which, x, xin, block, lift, proj,
                                m32)
                y16 = ends_launch(engine, which, x.to(bf16), xin.to(bf16),
                                  c16(block), c16(lift), c16(proj), m16)
                torch.cuda.synchronize()
                name = f"{arch}_B{b} {which}"
                errs[(arch, b, which, "float32")] = e = errors([y], [ref])
                check(f"{name} f32 block_ends vs plain", e[1], F32_TOL)
                errs[(arch, b, which, "bfloat16")] = e = errors([y16], [ref])
                check(f"{name} bf16 block_ends vs f32 plain", e[1], BF16_TOL)
                del ref, y, y16
            del x, xin, block, lift, proj
    return errs


def phase_serve_ends(torch, np, configs, fno_mod, sfs, engine):
    """fno2d and fno3d at full width with the fused ends: phase 3's 12
    requests with exact launch counts (2 block_ends and num_layers - 2
    block_fwd per forward) against the staged model without the ends,
    then a sustained window of ENDS_SERVED[arch] requests per precision."""
    log("== phase 25: serve fno2d and fno3d with the fused ends at full "
        "width")
    counts, stats = {}, {}
    for arch, window in ENDS_SERVED.items():
        base = configs.with_fuse_block(configs.get_config(arch))
        layers = base.num_layers
        params = fno_mod.init_fno(torch.Generator().manual_seed(0), base,
                                  DEVICE)
        staged = sfs.FNOServer(dataclasses.replace(base, path="staged",
                                                   fuse_block=False),
                               params, device=DEVICE, max_batch=8)
        shape = (base.in_channels,) + tuple(base.spatial)
        reqs = serve_requests(torch, np, shape)
        refs = [staged(x, rollout_steps=k) for x, k, _ in reqs]
        del staged
        c = dataclasses.replace(configs.with_fuse_ends(base), path="fused")
        names = (f"{arch} ends f32", f"{arch} ends bf16")
        servers = {}
        for name, cc in zip(names, (c, configs.with_precision(c, "bf16"))):
            srv = servers[name] = sfs.FNOServer(cc, params, device=DEVICE,
                                                max_batch=8)
            srv.warm((1, 4))  # build and capture outside the count
        plan = [(x, k, names[1] if bf16 else names[0])
                for x, k, bf16 in reqs]
        top = servers[names[0]].buckets[-1]
        expect = expected_launches(plan, ("block_ends",), 2, top)
        expect.update(expected_launches(plan, ("block_fwd",), layers - 2,
                                        top))
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        outs = [servers[name](x, rollout_steps=k) for x, k, name in plan]
        torch.cuda.synchronize()
        counts[arch] = dict(engine.LAUNCHES)
        log(f"  {arch} ends: launches {counts[arch]} expected {expect}")
        if counts[arch] != expect:
            raise AssertionError(f"kernel launches {counts[arch]} != "
                                 f"{expect}")
        for (x, k, name), y, ref in zip(plan, outs, refs):
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"non-finite serve output ({name}, "
                                     f"K={k})")
            check(f"serve {name} n={x.shape[0]} K={k} vs staged f32",
                  rel_err(y, ref), BF16_TOL if name == names[1] else F32_TOL)
        del outs, refs
        stats[arch] = phase_serve_window(
            torch, np, servers, engine, layers, names=names,
            kinds=("block_ends", "block_fwd"), phase="25", requests=window,
            per_request={"block_ends": 2, "block_fwd": layers - 2})
        del servers
    return counts, stats


def phase_ends_times(torch, engine, spectral, ops, configs, errs,
                     serve_counts, train_counts):
    """CUDA events at fno2d and fno3d B=8 for the lift and the projection
    launch (and both in one, the 1-layer model's) beside the plain
    version, the staged yardstick (the end MLP as PyTorch ops and the
    torch.fft block, one unit) and the bound with the MLPs' bytes and
    multiply-adds."""
    log("== phase 27: times — the ends launches at B=8")
    rows = []
    bf16 = torch.bfloat16
    for seed, arch in enumerate(ENDS_SERVED):
        cfg = configs.get_config(arch)
        b, h = 8, cfg.hidden
        spatial, modes = cfg.spatial, cfg.modes
        x32, xin32, block32, lift32, proj32 = ends_inputs(torch, cfg, b,
                                                          2700 + seed)
        for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                             ("bfloat16", PEAK_BF16_FLOPS, 2)):
            c = lambda ts: [t.to(getattr(torch, dt)) for t in ts]
            x, xin = x32.to(getattr(torch, dt)), xin32.to(getattr(torch, dt))
            block, lift, proj = c(block32), c(lift32), c(proj32)
            mats = spectral.operand_tensors(spatial, modes, dt, DEVICE)
            wr, wi, wb, bias = block
            # The model's layout of the ends for the staged yardstick.
            model = lambda e: (e[0].t(), e[1].reshape(-1), e[2].t(),
                               e[3].reshape(-1))
            both_ms = None
            for which in ENDS:
                run = lambda plain: ends_launch(engine, which, x, xin, block,
                                                lift, proj, mats, plain)
                kms = time_ms(lambda: run(False), 10)
                if which == "both":
                    both_ms = kms
                    continue
                pms = time_ms(lambda: run(True), 3)
                inp = xin if which == "lift" else x
                stage = lambda: ops.fno_block_ends_nd(
                    inp, wr, wi, wb, bias.reshape(-1), modes,
                    lift=model(lift) if which == "lift" else None,
                    proj=model(proj) if which == "proj" else None,
                    path="ref")
                fft = time_ms(stage, 5)
                dims = ends_dims_of(which, cfg)
                t_bytes, t_ops = bound_parts("block_ends", b, h, h, spatial,
                                             modes, eb, peak, ends=dims)
                bms, by = bound_ms("block_ends", b, h, h, spatial, modes,
                                   eb, peak, ends=dims)
                launches = serve_counts[arch].get(("block_ends", dt), 0)
                train = train_counts[arch][dt].get(("block_ends", dt), 0)
                e = errs[(arch, 8, which, dt)]
                log(f"  {dt} block_ends {which} {arch} B=8: kernel_ms="
                    f"{kms:.4f} plain_ms={pms:.4f} staged_ms={fft:.4f} "
                    f"bound_us={1e3 * bms:.2f} ({by}; bytes "
                    f"{1e3 * t_bytes:.2f} us, operations {1e3 * t_ops:.2f} "
                    f"us); block_ends launches {launches} served, {train} "
                    f"in 20 training steps")
                rows.append({
                    "name": f"block_ends_{which}_{arch}_"
                            f"{'f32' if dt == 'float32' else 'bf16'}",
                    "route": "cuda", "source": BLOCK_SOURCE,
                    "replaces": BLOCK_REPLACES, "shape": f"{arch} B=8",
                    "launches": launches, "launches_train": train,
                    "launches_note": "block_ends launches of phase 25's "
                                     "requests: one lift and one projection "
                                     "launch per forward, counted together",
                    "max_abs_err": e[0], "scaled_err": e[1],
                    "tol": F32_TOL if dt == "float32" else BF16_TOL,
                    "ms": kms, "plain_ms": pms, "bound_ms": bms,
                    "bound_by": by, "bound_bytes_ms": t_bytes,
                    "bound_operations_ms": t_ops, "library_ms": None,
                    "library_note": "no single PyTorch call computes it",
                    "torch_fft_ms": fft,
                    "torch_fft_note": f"the staged {which} MLP and the "
                                      f"torch.fft block, one unit"})
            log(f"  {dt} block_ends both {arch} B=8 (the 1-layer model's "
                f"launch): kernel_ms={both_ms:.4f}")
            rows[-2]["ms_both"] = both_ms
            del x, xin, block, lift, proj, mats
    log(f"  max_memory_allocated={torch.cuda.max_memory_allocated()} B")
    return rows


def phase_refused_shape(torch, engine, spectral, configs, fno_mod, sfs, ts,
                        optim, tree, build):
    """Phase 28: the block kernel at its plan and with the CUDA cores'
    chain forced, and the wgrad at its plan (the CUDA cores' chain), at
    2D 256² modes 32 hidden 64 against their plain versions; the model
    served and trained there."""
    log(f"== phase 28: a formerly refused shape, {REFUSED}")
    cfg = dataclasses.replace(configs.with_fuse_block(
        configs.get_config("fno2d")), **REFUSED)
    b, h = REFUSED_BATCH, cfg.hidden
    spatial, modes = cfg.spatial, cfg.modes
    block_plan = engine.pick_plan(build.load_fused_block(), 0, b, h, h,
                                  spatial, modes)
    wgrad_plan = engine.pick_wgrad_plan(build.load_fused_wgrad(), 0, b, h,
                                        h, spatial, modes)
    log(f"  plans: block {block_plan}; wgrad {wgrad_plan}")
    if block_plan["chain"] != "tc" or wgrad_plan["chain"] != "fma":
        raise AssertionError("the block should plan the tensor cores' chain "
                             "and the wgrad the CUDA cores' here")
    # The model, served and trained, with the counts from 0.
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg, DEVICE)
    fused = dataclasses.replace(cfg, path="fused")
    staged = dataclasses.replace(cfg, path="staged", fuse_block=False)
    shape = (cfg.in_channels,) + tuple(spatial)
    gen = torch.Generator().manual_seed(2801)
    reqs = [torch.randn((n,) + shape, generator=gen).to(DEVICE)
            for n in (1, 2, 2, 1)]
    counts = {}
    for preset in ("f32", "bf16"):
        c = configs.with_precision(fused, preset)
        dt = c.precision.compute_dtype
        srv = sfs.FNOServer(c, params, device=DEVICE, max_batch=b)
        ref = sfs.FNOServer(staged, params, device=DEVICE, max_batch=b)
        srv.warm()  # build, plan and capture outside the count
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        outs = [srv(x) for x in reqs]
        torch.cuda.synchronize()
        counts[("serve", dt)] = dict(engine.LAUNCHES)
        want = {("block_fwd", dt): cfg.num_layers * len(reqs)}
        if counts[("serve", dt)] != want:
            raise AssertionError(f"launches {counts[('serve', dt)]} != "
                                 f"{want}")
        tol = F32_TOL if preset == "f32" else BF16_TOL
        for x, y in zip(reqs, outs):
            check(f"serve {preset} n={x.shape[0]} vs staged f32",
                  rel_err(y, ref(x)), tol)
        # Served again with the block's CUDA cores' chain forced: the plan
        # the planner takes where the tensor cores' chain does not fit
        # (a server of its own, whose graphs capture the forced plan).
        with engine.forced_chain("fma"):
            fma = sfs.FNOServer(c, params, device=DEVICE, max_batch=b)
            fma.warm()
            torch.cuda.synchronize()
            engine.LAUNCHES.clear()
            outs = [fma(x) for x in reqs]
            torch.cuda.synchronize()
            counts[("serve_fma", dt)] = dict(engine.LAUNCHES)
        if counts[("serve_fma", dt)] != want:
            raise AssertionError(f"launches {counts[('serve_fma', dt)]} != "
                                 f"{want}")
        for x, y in zip(reqs, outs):
            check(f"serve {preset} n={x.shape[0]} CUDA cores' chain vs "
                  f"staged f32", rel_err(y, ref(x)), tol)
        batch = {"x": torch.randn((b,) + shape, generator=gen).to(DEVICE),
                 "y": torch.randn((b, cfg.out_channels) + tuple(spatial),
                                  generator=gen).to(DEVICE)}
        loss_ref, g_ref = ts.value_and_grad(
            ts.make_loss_fn(staged, fno_path="staged"), params, batch)
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        loss, g = ts.value_and_grad(ts.make_loss_fn(c, fno_path="fused"),
                                    params, batch)
        torch.cuda.synchronize()
        counts[("train", dt)] = dict(engine.LAUNCHES)
        want = {(k, dt): cfg.num_layers for k in engine.KINDS}
        if counts[("train", dt)] != want:
            raise AssertionError(f"launches {counts[('train', dt)]} != "
                                 f"{want}")
        gtol = F32_TOL if preset == "f32" else BF16_GRAD_TOL
        check(f"train {preset} step-0 loss vs staged f32",
              abs(float(loss) - float(loss_ref)) / abs(float(loss_ref)),
              gtol)
        for a, r in zip(tree.leaves(g), tree.leaves(g_ref)):
            check(f"train {preset} grad", leaf_err(a, r), gtol)
        opt = optim.AdamW(lr=optim.cosine_warmup(1e-3, 1, 10))
        step = ts.make_train_step(c, opt, fno_path="fused")
        _, _, m = step(params, opt.init(params), batch)
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"{preset}: a training step's loss is not "
                                 f"finite")
        log(f"  {preset}: served {len(reqs)} requests, step-0 loss "
            f"{float(loss):.6f} (staged {float(loss_ref):.6f}), one AdamW "
            f"step loss {float(m['loss']):.6f}; launches "
            f"{counts[('serve', dt)]} {counts[('train', dt)]}")
        del srv, ref, fma
    # Each kernel against its plain version, and its time.
    args32 = block_inputs(b, h, h, spatial, 2802, DEVICE)
    gz32 = torch.randn((b, h) + tuple(spatial),
                       generator=torch.Generator().manual_seed(2803)
                       ).to(DEVICE)
    rows = []
    for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                         ("bfloat16", PEAK_BF16_FLOPS, 2)):
        tag = "f32" if dt == "float32" else "bf16"
        tol = F32_TOL if dt == "float32" else BF16_TOL
        tdt = getattr(torch, dt)
        args = [a.to(tdt) for a in args32]
        x, gz = args[0], gz32.to(tdt)
        m32 = backward_mats(spectral, spatial, modes, "float32")
        mats = backward_mats(spectral, spatial, modes, dt)
        ref = engine.fused_block_plain(*args32, m32["forward"])
        wref = engine.fused_wgrad_plain(args32[0], gz32, m32["wgrad"])
        cases = {"block_fwd": (None, lambda: engine.fused_block(
                     *args, mats["forward"]),
                     lambda: engine.fused_block_plain(*args,
                                                      mats["forward"])),
                 "block_fwd_fma": ("fma", lambda: engine.fused_block(
                     *args, mats["forward"]),
                     lambda: engine.fused_block_plain(*args,
                                                      mats["forward"])),
                 "wgrad": (None, lambda: engine.fused_wgrad(
                     x, gz, mats["wgrad"]),
                     lambda: engine.fused_wgrad_plain(x, gz,
                                                      mats["wgrad"]))}
        for name, (chain, run, plain) in cases.items():
            with engine.forced_chain(chain):
                out = run()
                torch.cuda.synchronize()
                outs = out if name == "wgrad" else (out,)
                e = errors(outs, wref if name == "wgrad" else (ref,))
                check(f"{name} {tag} kernel vs plain", e[1], tol)
                kms = time_ms(run, 10)
            pms = time_ms(plain, 3)
            kind = "wgrad" if name == "wgrad" else "block_fwd"
            bms, by = bound_ms(kind, b, h, h, spatial, modes, eb, peak)
            where = ("train" if name == "wgrad" else
                     "serve_fma" if chain else "serve")
            launches = counts[(where, dt)].get((kind, dt), 0)
            log(f"  {dt} {name} B={b}: kernel_ms={kms:.4f} plain_ms="
                f"{pms:.4f} bound_us={1e3 * bms:.2f} ({by}); launches "
                f"{launches} ({where})")
            rows.append({
                "name": f"{name}_256x256m32_{tag}", "route": "cuda",
                "source": WGRAD_SOURCE if name == "wgrad" else BLOCK_SOURCE,
                "replaces": (WGRAD_REPLACES if name == "wgrad"
                             else BLOCK_REPLACES),
                "shape": f"2D 256x256 modes 32 hidden {h} B={b}",
                "chain": chain or (wgrad_plan if name == "wgrad"
                                   else block_plan)["chain"],
                "launches": launches,
                **({"launches_note": "the block kernel's launches serving "
                                     "the same requests with the CUDA "
                                     "cores' chain forced (the planner "
                                     "takes the tensor cores' here)"}
                   if chain else {}),
                "max_abs_err": e[0], "scaled_err": e[1], "tol": tol,
                "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "library_ms": None,
                "library_note": "no single PyTorch call computes it"})
    return rows


# ---------------------------------------------------------------------------
# The runtime around the kernels: graphed serving, the resilient and
# continuous-batching tiers, the Trainer
# ---------------------------------------------------------------------------
def graph_cases(configs):
    """Phase 29's servers: (name, config, variant, bucket)."""
    f2 = dataclasses.replace(configs.with_fuse_block(
        configs.get_config("fno2d")), path="fused")
    fused = lambda arch: dataclasses.replace(configs.with_fuse_block(
        configs.get_config(arch)), path="fused")
    return [("fno2d f32", f2, "full", 8),
            ("fno2d bf16", configs.with_precision(f2, "bf16"), "full", 8),
            ("fno3d f32", fused(FNO3D), "full", 4),
            (f"{LARGE} f32", fused(LARGE), "full", 4),
            ("fno2d partial f32", f2, "partial", 4),
            ("fno2d ends f32", configs.with_fuse_ends(f2), "full", 4)]


def per_step_launches(cfg, variant, engine):
    """Launches one forward of `cfg` runs, by kind."""
    layers, dt = cfg.num_layers, cfg.precision.compute_dtype
    if variant == "partial":
        return {(k, dt): layers for k in engine.PARTIAL_KINDS}
    if cfg.fuse_ends:
        return {("block_ends", dt): 2, ("block_fwd", dt): layers - 2}
    return {("block_fwd", dt): layers}


def phase_graphs(torch, np, configs, fno_mod, sfs, engine, card):
    """Phase 29: the served forward and the K-step rollout as CUDA graphs,
    against the eager path of the same server."""
    log("== phase 29: graphed serving — CUDA graphs against the eager path")
    out = {"checks": {}, "times": {}}
    for name, cfg, variant, bucket in graph_cases(configs):
        params = fno_mod.init_fno(torch.Generator().manual_seed(29), cfg,
                                  DEVICE)
        srv = sfs.FNOServer(cfg, params, device=DEVICE, variant=variant,
                            max_batch=8)
        if not srv.graphed:
            raise AssertionError(f"{name}: the fused server on the card is "
                                 f"not graphed")
        gen = torch.Generator().manual_seed(2900)
        shape = (cfg.in_channels,) + tuple(cfg.spatial)
        n = bucket - 1 if bucket > 1 else 1  # padded rows in the bucket
        x1, x2 = (torch.randn((n,) + shape, generator=gen).to(DEVICE)
                  for _ in range(2))
        per = per_step_launches(cfg, variant, engine)
        res = {}
        for k in (1, 4, 8):
            srv(x1, rollout_steps=k)  # build and capture outside the count
            torch.cuda.synchronize()
            engine.LAUNCHES.clear()
            y = srv(x1, rollout_steps=k)
            torch.cuda.synchronize()
            got = dict(engine.LAUNCHES)
            want = {key: v * k for key, v in per.items()}
            if got != want:
                raise AssertionError(f"{name} K={k}: one replay ran {got}, "
                                     f"want {want}")
            ref = srv.step_with(srv.params, x1, k)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(y, ref))
            err = rel_err(y, ref)
            res[k] = {"launches": sum(got.values()), "bitwise": bitwise,
                      "scaled_err": err}
            log(f"  {name} bucket {bucket} n={n} K={k}: one replay, "
                f"launches {got}; graphed == eager bitwise: {bitwise} "
                f"(scaled err {err:.3e})")
            if not bitwise:
                raise AssertionError(f"{name} K={k}: the graphed output "
                                     f"differs from the eager path "
                                     f"(scaled err {err:.3e})")
        # Aliasing: the graph's output buffer is overwritten by the next
        # replay of the bucket; the server hands out copies.
        y1 = srv(x1)
        keep = y1.clone()
        y2 = srv(x2)
        torch.cuda.synchronize()
        if not torch.equal(y1, keep) or torch.equal(y1, y2):
            raise AssertionError(f"{name}: a later request of the bucket "
                                 f"changed an earlier answer")
        log(f"  {name}: two requests of bucket {bucket} back to back, the "
            f"first answer unchanged: ok")
        if name == "fno2d f32":
            # Another resolution through the same server: graphs of its
            # own, equal to the eager path; the first resolution's stay.
            half = tuple(s // 2 for s in cfg.spatial)
            xh = torch.randn((n, cfg.in_channels) + half,
                             generator=gen).to(DEVICE)
            count = len(srv._graphs)
            yh = srv(xh)
            same = (torch.equal(yh, srv.step_with(srv.params, xh, 1))
                    and torch.equal(srv(x1), srv.step_with(srv.params, x1, 1))
                    and len(srv._graphs) == count + 1)
            log(f"  {name}: a request at {half} beside {tuple(cfg.spatial)}"
                f": its own graph, graphed == eager bitwise at both: {same}")
            if not same:
                raise AssertionError(f"{name}: serving at {half} broke the "
                                     f"graphs' agreement with the eager path")
        out["checks"][name] = res
        del srv
    # Graphed against the eager step_with, in turns, at fno2d K=1 and K=8.
    cfg = graph_cases(configs)[0][1]
    params = fno_mod.init_fno(torch.Generator().manual_seed(29), cfg, DEVICE)
    srv = sfs.FNOServer(cfg, params, device=DEVICE, max_batch=8)
    shape = (cfg.in_channels,) + tuple(cfg.spatial)
    pool = torch.randn((64,) + shape, generator=torch.Generator(
        device=DEVICE).manual_seed(2901), device=DEVICE)
    for k, requests in ((1, GRAPH_REQUESTS), (8, GRAPH_REQUESTS // 4)):
        srv.warm((k,))
        rng = np.random.default_rng(2902)
        sizes = rng.integers(1, 9, size=requests)
        offs = rng.integers(0, 64 - 8, size=requests)
        modes = {"graphed": lambda x: srv(x, rollout_steps=k),
                 "eager": lambda x: srv.step_with(srv.params, x, k)}
        lat = {m: [] for m in modes}
        wall = {m: 0.0 for m in modes}
        for m in ("eager", "graphed"):  # warm both outside the turns
            modes[m](pool[:8])
        for turn in ("graphed", "eager", "eager", "graphed"):
            torch.cuda.synchronize()
            t_all = time.perf_counter()
            for n, off in zip(sizes, offs):
                t0 = time.perf_counter()
                modes[turn](pool[off:off + n])
                torch.cuda.synchronize()
                lat[turn].append(1e3 * (time.perf_counter() - t0))
            wall[turn] += time.perf_counter() - t_all
        row = {}
        for m in modes:
            a = np.asarray(lat[m])
            row[m] = {"p50_ms": float(np.percentile(a, 50)),
                      "p99_ms": float(np.percentile(a, 99)),
                      "sample_steps_per_s": float(2 * k * sizes.sum())
                      / wall[m], "requests": 2 * requests}
        out["times"][f"K={k}"] = row
        log(f"  fno2d f32 K={k}, {requests} requests of seeded sizes 1-8 "
            f"per turn, turns graphed, eager, eager, graphed ({card}): "
            f"graphed p50 {row['graphed']['p50_ms']:.4f} ms p99 "
            f"{row['graphed']['p99_ms']:.4f} ms "
            f"{row['graphed']['sample_steps_per_s']:.2f} sample-steps/s; "
            f"eager p50 {row['eager']['p50_ms']:.4f} ms p99 "
            f"{row['eager']['p99_ms']:.4f} ms "
            f"{row['eager']['sample_steps_per_s']:.2f} sample-steps/s")
    return out


def phase_resilient(torch, configs, fno_mod, engine):
    """Phase 30: the resilient runtime on the card, fno2d at full width, 2
    replicas, every canned plan (the stats held against the same plan on
    the CPU), then the chaos gate (the standard plan, shedding, a corrupt
    reload that rolls back, a valid reload the graphs serve)."""
    from repro_torch.distributed import faults as flt
    from repro_torch.launch import chaos_smoke
    from repro_torch.train import serve_runtime as srt

    log("== phase 30: resilient serving, fno2d full width, 2 replicas")
    cfg = dataclasses.replace(configs.with_fuse_block(
        configs.get_config("fno2d")), path="fused")
    small = dataclasses.replace(configs.with_fuse_block(
        configs.get_config("fno2d", reduced=True)), path="fused")
    staged = dataclasses.replace(cfg, path="staged", fuse_block=False)
    params = fno_mod.init_fno(torch.Generator().manual_seed(30), cfg,
                              DEVICE)
    gen = torch.Generator().manual_seed(3000)
    x = torch.randn((4, cfg.in_channels) + tuple(cfg.spatial), generator=gen)
    with torch.no_grad():
        want = fno_mod.apply_fno(params, staged, x.to(DEVICE)).cpu()
    offered = 5
    out = {}
    for name in sorted(flt.canned_chaos_plans()):
        plan = flt.canned_chaos_plans()[name]
        rs = srt.ResilientServer(cfg, params, device=DEVICE, replicas=2,
                                 max_batch=8, backoff_base_s=1e-3,
                                 fault_plan=plan)
        rs.primary.warm()  # build and capture outside the count
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        for _ in range(offered):
            rs.submit(x)
        ys = rs.drain()
        torch.cuda.synchronize()
        launches = dict(engine.LAUNCHES)
        cpu = srt.ResilientServer(
            small, fno_mod.init_fno(torch.Generator().manual_seed(30),
                                    small),
            device="cpu", replicas=2, max_batch=8, backoff_base_s=1e-3,
            fault_plan=flt.canned_chaos_plans()[name])
        xs = torch.randn((4, small.in_channels) + tuple(small.spatial),
                         generator=torch.Generator().manual_seed(3001))
        for _ in range(offered):
            cpu.submit(xs)
        cpu.drain()
        if tuple(rs.stats) != srt.ResilientServer.STAT_KEYS or \
                rs.stats != cpu.stats or \
                rs.pool.states() != cpu.pool.states():
            raise AssertionError(f"plan {name}: stats {rs.stats} pool "
                                 f"{rs.pool.states()} != the CPU run's "
                                 f"{cpu.stats} {cpu.pool.states()}")
        if rs.stats["degraded"] != plan.count(kinds=("kernel", "nan")):
            raise AssertionError(f"plan {name}: degraded "
                                 f"{rs.stats['degraded']} != planned")
        errs = [rel_err(y, want) for y in ys]
        for e in errs:
            check(f"plan {name} answer vs staged f32", e, F32_TOL)
        # Every request reaches the graphs but those an injected kernel
        # fault stops first; every reinstated replica ran one eager canary.
        dt = cfg.precision.compute_dtype
        on_graphs = offered - plan.count(kinds=("kernel",))
        want_launches = {("block_fwd", dt): cfg.num_layers * (
            on_graphs + rs.stats["reinstated"])}
        if launches != want_launches or (
                name == "quiet" and rs.stats["degraded"] != 0):
            raise AssertionError(f"plan {name}: launches {launches} != "
                                 f"{want_launches}, or degraded "
                                 f"{rs.stats['degraded']}")
        out[name] = {"stats": dict(rs.stats), "launches": launches,
                     "max_scaled_err": max(errs)}
        log(f"  plan {name}: stats {rs.stats} pool {rs.pool.states()} "
            f"(== the CPU run's); launches {launches} ({on_graphs} "
            f"requests on the graphs, {rs.stats['reinstated']} canaries); "
            f"worst answer vs staged {max(errs):.3e}")
        del rs
    gate = chaos_smoke.run(cfg, DEVICE, max_batch=8)
    log(f"  chaos gate (launch/chaos_smoke.py) at full width: stats "
        f"{gate['stats']} pool {gate['pool']}; answers vs staged "
        f"{gate['max_scaled_err']:.3e}; after the valid reload the graphs "
        f"serve the new params: {gate['swap_scaled_err']:.3e} vs staged")
    out["gate"] = gate
    return out


def phase_queue(torch, np, configs, fno_mod, sfs):
    """Phase 31: the continuous-batching tier over the graphed server,
    fno2d at full width: a seeded schedule at 1.2x the calibrated capacity
    (the reference's ``benchmarks/bench_e2e.run_replay`` recipe), then the
    exact counts of ``launch/serve_replay_smoke.py``'s fixed model."""
    from repro_torch.launch import serve_fno as cli
    from repro_torch.launch import serve_replay_smoke as smoke
    from repro_torch.train import serve_queue as sq

    log("== phase 31: continuous batching, fno2d full width")
    cfg = dataclasses.replace(configs.with_fuse_block(
        configs.get_config("fno2d")), path="fused")
    params = fno_mod.init_fno(torch.Generator().manual_seed(31), cfg, DEVICE)
    max_batch, steps, requests = 8, 2, QUEUE_REQUESTS
    server = sfs.FNOServer(cfg, params, device=DEVICE, max_batch=max_batch)
    base = cli.calibrate(server, steps)
    top = server.buckets[-1]
    rate_hz = 1.2 * (top / base[top]) / ((1 + max_batch) / 2)
    deadline_s = 20 * base[top]
    cbs = sq.ContinuousBatchingServer(
        server, queue_limit=2 * max_batch, coalesce_s=1.0 / rate_hz,
        clock=sq.VirtualClock(), service_model=lambda b, k: base[b])
    sched = sq.poisson_schedule(7, requests, rate_hz=rate_hz,
                                max_n=max_batch, rollout_steps=steps,
                                deadline_s=deadline_s)
    rng = np.random.default_rng(7)
    xs = [torch.from_numpy(rng.normal(size=(a.n, cfg.in_channels)
                                      + tuple(cfg.spatial)).astype(
                                          np.float32)) for a in sched]
    rep = cbs.replay(sched, lambda a, i: xs[i])
    s, lat, qd = rep["stats"], rep["latency"], rep["queue_depth"]
    if set(s) != set(sq.QUEUE_STATS) or \
            s["offered"] != s["accepted"] + s["shed"] or \
            s["accepted"] != (s["completed"] + s["deadline_exceeded"]
                              + s["failed"]) or s["offered"] != requests:
        raise AssertionError(f"QUEUE_STATS not conserved: {s}")
    for r in cbs.requests.values():
        if r.status == "done":
            if r.t_complete > r.deadline_t + 1e-12:
                raise AssertionError(f"request {r.idx} served late")
            if not bool(torch.isfinite(r.y).all()):
                raise AssertionError(f"request {r.idx}: non-finite output")
    log(f"  service model ms by bucket (graphed, K={steps}, measured): "
        f"{ {b: round(1e3 * t, 4) for b, t in base.items()} }; rate "
        f"{rate_hz:.1f} req/s (1.2x capacity), deadline "
        f"{1e3 * deadline_s:.3f} ms")
    log(f"  stats {s}; latency p50 {1e3 * lat['p50']:.4f} ms p99 "
        f"{1e3 * lat['p99']:.4f} ms over {lat['count']} completed "
        f"(virtual clock); queue depth p50 {qd['p50']:.1f} p99 "
        f"{qd['p99']:.1f} max {qd['max']:.0f}; no request served late")
    # The gate's fixed synthetic model: exact, machine-independent counts.
    gate_srv = sfs.FNOServer(cfg, params, device=DEVICE,
                             max_batch=smoke.MAX_N, quantum=smoke.QUANTUM)
    gcbs, grep = smoke.replay_once(gate_srv)
    smoke.check_replay(gcbs, grep)
    if smoke.replay_once(gate_srv)[1] != grep:
        raise AssertionError("the gate's replay is not deterministic")
    k_launches = smoke.rollout_launches(gate_srv)
    log(f"  serve_replay_smoke's fixed model at full width: stats "
        f"{grep['stats']} == its exact counts; deterministic; rollout "
        f"block_fwd launches by K {k_launches}")
    return {"stats": s, "latency": lat, "queue_depth": qd,
            "service_model_s": base, "rate_hz": rate_hz,
            "deadline_s": deadline_s, "gate": grep["stats"]}


def phase_trainer(torch, configs, fno_mod, batch_fn, ts, optim):
    """Phase 32: the Trainer, fno2d at full width, Darcy batch 8, 30
    steps, a checkpoint every 10; the plan poisons one step with NaN,
    fails one save and kills the run once. The losses after the restore
    equal those of a run with the same NaN step and no failure."""
    import tempfile

    from repro_torch.distributed import faults as flt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    log("== phase 32: the Trainer, fno2d full width, batch 8, 30 steps")
    cfg = dataclasses.replace(configs.with_fuse_block(
        configs.get_config("fno2d")), path="fused")
    params = fno_mod.init_fno(torch.Generator().manual_seed(32), cfg, DEVICE)
    data = batch_fn(cfg, 8, DEVICE)
    nan_at, io_at, fail_at = 3, 10, 15

    def trainer(d, faults, fail=None):
        opt = optim.AdamW(lr=optim.cosine_warmup(1e-3, 4, TRAINER_STEPS))
        tc = TrainerConfig(total_steps=TRAINER_STEPS, ckpt_dir=d,
                           ckpt_every=10, log_every=1, ckpt_backoff_s=0.01)
        return Trainer(tc, ts.make_train_step(cfg, opt, fno_path="fused"),
                       data, params, opt.init(params), fail_at=fail,
                       fault_plan=flt.FaultPlan(faults))

    nan = flt.Fault("nan", at=nan_at, scope="train")
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        t = time.perf_counter()
        a = trainer(d1, [nan, flt.Fault("ckpt_io", at=io_at,
                                        scope="train")],
                    {fail_at: RuntimeError("injected node failure")})
        out = a.run_with_restarts()
        wall = time.perf_counter() - t
        b = trainer(d2, [nan])
        ref = b.run()
    if (a.restarts, out["nan_skipped"], out["ckpt_save_retries"],
            out["final_step"]) != (1, 1, 1, TRAINER_STEPS):
        raise AssertionError(f"restarts {a.restarts}, nan_skipped "
                             f"{out['nan_skipped']}, save retries "
                             f"{out['ckpt_save_retries']}, final step "
                             f"{out['final_step']}")
    losses = {m["step"]: m["loss"] for m in ref["metrics"]}
    after = [m for m in out["metrics"]][-(TRAINER_STEPS - io_at):]
    if [m["step"] for m in after] != list(range(io_at, TRAINER_STEPS)):
        raise AssertionError(f"the restarted run logged steps "
                             f"{[m['step'] for m in after]}")
    worst = max(abs(m["loss"] - losses[m["step"]])
                / max(abs(losses[m["step"]]), 1e-30) for m in after)
    check("losses after the restore vs the uninterrupted run", worst,
          F32_TOL)
    log(f"  restarts {a.restarts}, nan_skipped {out['nan_skipped']}, save "
        f"retries {out['ckpt_save_retries']}; restored at step {io_at} "
        f"(the failure at {fail_at}); loss {after[0]['loss']:.6f} -> "
        f"{after[-1]['loss']:.6f}, worst relative difference from the "
        f"uninterrupted run {worst:.3e}; {wall:.2f} s for the faulty run")
    if not after[-1]["loss"] < losses[0]:
        raise AssertionError("the loss did not fall over the run")
    return {"restarts": a.restarts, "nan_skipped": out["nan_skipped"],
            "ckpt_save_retries": out["ckpt_save_retries"],
            "worst_rel_loss_diff": worst}


# ---------------------------------------------------------------------------
# Phase 33: the DP×TP mesh (ranks of this host; the card(s) it has)
# ---------------------------------------------------------------------------
def shard_shapes(configs):
    """The block's TP shards on phase 33's path, (name, B, H/tp, O,
    spatial, modes, per_mode): each rank's batch rows and hidden slice."""
    f2, f3, lg = (configs.get_config(a) for a in ("fno2d", FNO3D, LARGE))
    return [("fno2d_tp2", 8, f2.hidden // 2, f2.hidden, f2.spatial,
             f2.modes, False),
            ("fno2d_tp2_B4", 4, f2.hidden // 2, f2.hidden, f2.spatial,
             f2.modes, False),
            ("fno2d_tp4", 8, f2.hidden // 4, f2.hidden, f2.spatial,
             f2.modes, False),
            ("fno3d_tp2", 8, f3.hidden // 2, f3.hidden, f3.spatial,
             f3.modes, False),
            ("fno2d-large_tp2", 8, lg.hidden // 2, lg.hidden, lg.spatial,
             lg.modes, True)]


def phase_shards_vs_plain(torch, engine, spectral, configs):
    """Each TP shard shape's launches (the linear block, dx adjoint, wgrad)
    against their plain versions, f32 on the same inputs and bf16 against
    the f32 plain version; the linear block timed alone (host-paced) and
    queued beside its plain version and bound, and the one-rank linear
    block at fno2d B=8 beside them."""
    log("== phase 33: the DP×TP mesh — the block's TP shard shapes vs plain")
    f32 = torch.float32
    rows, errs = [], {}
    f2 = configs.get_config("fno2d")
    shapes = shard_shapes(configs) + [
        ("fno2d_one_rank", 8, f2.hidden, f2.hidden, f2.spatial, f2.modes,
         False)]
    for seed, (name, b, h, o, spatial, modes, per_mode) in enumerate(
            shapes, 3300):
        args32 = (per_mode_inputs(b, h, o, spatial, modes, seed, DEVICE)
                  if per_mode else list(block_inputs(b, h, o, spatial, seed,
                                                     DEVICE)))
        gen = torch.Generator().manual_seed(seed)
        gz32 = torch.randn((b, o) + tuple(spatial), generator=gen).to(DEVICE)
        for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                             ("bfloat16", PEAK_BF16_FLOPS, 2)):
            tdt = getattr(torch, dt)
            args = [a.to(tdt) for a in args32]
            gz = gz32.to(tdt)
            mats = backward_mats(spectral, spatial, modes, dt)
            m32 = backward_mats(spectral, spatial, modes, "float32")
            fns = block_launches(engine, args, None, gz, mats)
            fns32 = block_launches(engine, args32, None, gz32, m32)
            launch = {
                "block_linear": lambda plain, a=args, m=mats: linear_block(
                    engine, a, m["forward"], f32, plain),
                "dx_adjoint": fns["dx_adjoint"], "wgrad": fns["wgrad"]}
            plain32 = {
                "block_linear": as_tuple(linear_block(
                    engine, args32, m32["forward"], f32, True)),
                "dx_adjoint": as_tuple(fns32["dx_adjoint"](True)),
                "wgrad": as_tuple(fns32["wgrad"](True))}
            for kind, fn in launch.items():
                y = as_tuple(fn(False))
                torch.cuda.synchronize()
                errs[(name, kind, dt)] = e = errors(y, plain32[kind])
                check(f"{name} {dt} {kind} vs f32 plain", e[1],
                      F32_TOL if dt == "float32" else BF16_TOL)
            run = launch["block_linear"]
            kms = time_ms(lambda: run(False), 20)
            qms = time_ms(lambda: run(False), 20, queued=True)
            pms = time_ms(lambda: run(True), 10)
            dx_ms = time_ms(lambda: launch["dx_adjoint"](False), 20,
                            queued=True)
            wg_ms = time_ms(lambda: launch["wgrad"](False), 20, queued=True)
            bms, by = bound_ms("block_linear", b, h, o, spatial, modes, eb,
                               peak, per_mode)
            e = errs[(name, "block_linear", dt)]
            tag = "f32" if dt == "float32" else "bf16"
            log(f"  {name} [O={o}, H/tp={h}] B={b} {dt}: block_linear "
                f"kernel_ms={kms:.4f} queued_ms={qms:.4f} plain_ms="
                f"{pms:.4f} bound_us={1e3 * bms:.2f} ({by}); dx_adjoint "
                f"queued_ms={dx_ms:.4f}; wgrad queued_ms={wg_ms:.4f}")
            rows.append({
                "name": f"block_linear_{name}_{tag}", "route": "cuda",
                "shard": name, "dtype": dt,
                "source": BLOCK_SOURCE, "replaces": BLOCK_REPLACES,
                "shape": f"B={b} H={h} O={o} spatial={tuple(spatial)} "
                         f"modes={tuple(modes)} per_mode={per_mode}",
                "launches": 0, "max_abs_err": e[0], "scaled_err": e[1],
                "tol": F32_TOL if dt == "float32" else BF16_TOL,
                "ms": kms, "queued_ms": qms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "library_ms": None,
                "library_note": "no single PyTorch call computes it",
                "dx_adjoint_queued_ms": dx_ms, "wgrad_queued_ms": wg_ms})
        del args32, gz32
    return rows


def mesh_jobs(np, configs, batch_fn):
    """Phase 33's spawns: (mesh, cases by name), every case's params from
    seed 0 on every rank, the global batch of 8 from numpy seed 33 (the
    training batch Darcy's first)."""
    def cfg(arch, preset="f32"):
        return dataclasses.replace(configs.with_precision(
            configs.with_fuse_block(configs.get_config(arch)), preset),
            path="fused")
    rng = np.random.default_rng(33)
    xs = {a: rng.normal(size=(MESH_BATCH, c.in_channels) + c.spatial
                        ).astype(np.float32)
          for a, c in ((a, configs.get_config(a))
                       for a in ("fno2d", FNO3D, LARGE))}
    batch = {k: v.cpu().numpy() for k, v in
             batch_fn(cfg("fno2d"), MESH_BATCH, "cpu")(0).items()}
    fwd = lambda arch, preset="f32", **kw: {
        "kind": "forward", "cfg": cfg(arch, preset), "seed": 0,
        "x": xs[arch], **kw}
    both = {"fno2d f32": fwd("fno2d"), "fno2d bf16": fwd("fno2d", "bf16")}
    return [
        ((1, 2), {**both, "fno2d f32 partial": fwd("fno2d",
                                                   variant="partial"),
                  "fno3d f32": fwd(FNO3D), f"{LARGE} f32": fwd(LARGE)}),
        ((2, 2), {**both,
                  "train grads": {"kind": "grads", "cfg": cfg("fno2d"),
                                  "seed": 0, "batch": batch},
                  "train step": {"kind": "train", "cfg": cfg("fno2d"),
                                 "seed": 0, "batch": batch}}),
        ((1, 4), both),
    ], xs, batch


def phase_mesh(torch, np, configs, fno_mod, sfs, ts, optim, tree, engine,
               batch_fn):
    """Ranks of this host on its card(s), gloo (the collectives staged
    through the host): fno2d f32 and bf16 on (1,2), (2,2) and (1,4); the
    partial variant, fno3d and fno2d-large (per-mode W) on (1,2); one fno2d
    training step on (2,2). Each against the one-rank graphed server or
    fused step; each rank's launches exact; over nccl on (1,2) where the
    host has two cards."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import mesh_cases as mc
    log("== phase 33: the DP×TP mesh — sharded forward and training step")
    cards = torch.cuda.device_count()
    log(f"  torch.cuda.device_count()={cards}; backend {MESH_BACKEND} for "
        f"the ranks on {cards} card(s): collectives staged through the "
        f"host")
    try:
        mesh_mod.check_backend("nccl", torch.device(DEVICE, 0), 2)
        nccl_on_one = "accepted"
    except ValueError as e:
        nccl_on_one = f"refused: {e}"
    log(f"  nccl with 2 ranks on this host: {nccl_on_one}")
    if cards < 2 and nccl_on_one == "accepted":
        raise AssertionError("nccl must refuse two ranks on one card")
    jobs, xs, batch = mesh_jobs(np, configs, batch_fn)
    if cards >= 2:
        jobs.append(((1, 2), {"nccl fno2d f32": dict(
            jobs[0][1]["fno2d f32"])}))
    layers = configs.get_config("fno2d").num_layers
    refs, servers = {}, {}

    def single(case):
        c, variant = case["cfg"], case.get("variant", "full")
        key = (c.name, id(case["x"]), c.precision.compute_dtype, variant)
        if key not in refs:
            params = fno_mod.init_fno(torch.Generator().manual_seed(0), c)
            srv = sfs.FNOServer(c, params, device=DEVICE, variant=variant,
                                max_batch=MESH_BATCH)
            refs[key] = srv(torch.from_numpy(case["x"]).to(DEVICE))
            torch.cuda.synchronize()
            servers[key] = srv.graphed
            del srv, params
        return refs[key]

    launches = {}
    for mesh, cases in jobs:
        backend = "nccl" if "nccl fno2d f32" in cases else MESH_BACKEND
        t = time.perf_counter()
        job = {"mesh": mesh, "backend": backend, "device": DEVICE,
               "cases": list(cases.values())}
        ranks = mesh_mod.spawn(mc.run_rank, mesh[0] * mesh[1], job,
                               timeout_s=MESH_SPAWN_S)
        log(f"  mesh dp{mesh[0]}xtp{mesh[1]} over {backend}: "
            f"{len(cases)} cases on {mesh[0] * mesh[1]} ranks in "
            f"{time.perf_counter() - t:.1f} s (spawn, build load and "
            f"cases, eager: not a deployment's speed)")
        for i, (name, case) in enumerate(cases.items()):
            res = [r[i] for r in ranks]
            c = case["cfg"]
            dt = c.precision.compute_dtype
            tp_on = mesh[1] > 1 and c.hidden % mesh[1] == 0
            if case["kind"] == "forward":
                if case.get("variant") == "partial":
                    want = {f"{k}/{dt}": layers for k in engine.PARTIAL_KINDS}
                else:
                    want = {f"{'block_linear' if tp_on else 'block_fwd'}/"
                            f"{dt}": c.num_layers}
                ref = single(case)
                tol = F32_TOL if dt == "float32" else BF16_TOL
                for rank, r in enumerate(res):
                    check(f"dp{mesh[0]}xtp{mesh[1]} {name} rank {rank} vs "
                          f"the one-rank graphed server",
                          rel_err(torch.from_numpy(r["y"]), ref.cpu()), tol)
            else:
                want = {f"{k}/{dt}": layers for k in engine.LINEAR_KINDS}
            for rank, r in enumerate(res):
                calls = {f"{k}/{dt}": n for k, n in r["calls"].items()}
                if r["launches"] != want or calls != want:
                    raise AssertionError(
                        f"dp{mesh[0]}xtp{mesh[1]} {name} rank {rank}: "
                        f"launches {r['launches']} calls {r['calls']} != "
                        f"{want}")
            log(f"  dp{mesh[0]}xtp{mesh[1]} {name}: launches a rank "
                f"{res[0]['launches']}; collectives a rank "
                f"{res[0]['collectives']}")
            launches[(mesh, name)] = collections.Counter()
            for r in res:
                launches[(mesh, name)].update(r["launches"])
            if case["kind"] == "grads":
                c32 = case["cfg"]
                params = fno_mod.init_fno(torch.Generator().manual_seed(0),
                                          c32, DEVICE)
                b = {k: torch.from_numpy(v).to(DEVICE)
                     for k, v in batch.items()}
                loss, g = ts.value_and_grad(
                    ts.make_loss_fn(c32, fno_path="fused"), params, b)
                gn = float(optim.global_norm(g))
                refs["train"] = (float(loss), gn)
                for rank, r in enumerate(res):
                    check(f"{name} rank {rank} loss vs the one-rank fused "
                          f"step", abs(r["loss"] - float(loss))
                          / abs(float(loss)), F32_TOL)
                    for p, a, ref in zip(tree.paths(g),
                                         tree.leaves(r["grads"]),
                                         tree.leaves(g)):
                        check(f"{name} rank {rank} grad "
                              f"{'.'.join(str(k) for k in p)}",
                              leaf_err(torch.from_numpy(a), ref.cpu()),
                              F32_TOL)
                del params, g
            if case["kind"] == "train":
                loss, gn = refs["train"]
                for rank, r in enumerate(res):
                    check(f"{name} rank {rank} step-0 loss vs one rank",
                          abs(r["loss"] - loss) / abs(loss), F32_TOL)
                    check(f"{name} rank {rank} step-0 grad norm vs one "
                          f"rank", abs(r["grad_norm"] - gn) / gn, F32_TOL)
        del ranks
    log(f"  one-rank references graphed: {sorted(set(servers.values()))}")
    return launches, cards

TUNED_ARCHS = ("fno2d", LARGE, FNO3D)  # phase 34's cached entries
TUNED_SERVED = ("fno2d", FNO3D)          # served and trained both ways


def tuned_entries(configs, autotune, kinds, batches):
    """(workload, entry) of every fresh cached entry of phase 34's presets
    at these batches (f32 and bf16)."""
    from repro_torch.tuning import store
    out = []
    for w in autotune.workloads(TUNED_ARCHS, autotune.DTYPES, kinds,
                                batches):
        fields = store.lookup(w.key, w.hidden, w.hidden, w.spatial,
                              w.modes)
        if fields is None:
            raise AssertionError(f"{w.key}: no fresh cached entry for a "
                                 f"tuned preset")
        out.append((w, fields))
    return out


def serve_both_ways(torch, configs, fno_mod, sfs, engine, cfg, rule):
    """Phase 34's serving: one bucket at K=1 and K=4 through a server at
    the cached plans and one whose config pins the block forward's rule
    plan (`rule`): exact launches, equal outputs."""
    params = fno_mod.init_fno(torch.Generator().manual_seed(34), cfg, DEVICE)
    x = torch.randn((4, cfg.in_channels) + tuple(cfg.spatial),
                    generator=torch.Generator().manual_seed(3400)).to(DEVICE)
    pinned = configs.with_block_plan(cfg, **rule)
    ys = {}
    for name, c in (("cache", cfg), ("rule", pinned)):
        srv = sfs.FNOServer(c, params, device=DEVICE, max_batch=4)
        for k in (1, 4):
            srv(x, rollout_steps=k)  # build and capture outside the count
            torch.cuda.synchronize()
            engine.LAUNCHES.clear()
            ys[(name, k)] = srv(x, rollout_steps=k)
            torch.cuda.synchronize()
            want = {key: v * k for key, v in
                    per_step_launches(c, "full", engine).items()}
            if dict(engine.LAUNCHES) != want:
                raise AssertionError(f"{cfg.name} {name} K={k}: ran "
                                     f"{dict(engine.LAUNCHES)}, want {want}")
    tol = F32_TOL if cfg.precision.compute_dtype == "float32" else BF16_TOL
    for k in (1, 4):
        check(f"{cfg.name} {cfg.precision.compute_dtype} served K={k}, "
              f"cached plans vs rule plan", rel_err(ys[("cache", k)],
                                                    ys[("rule", k)]), tol)


def train_both_ways(torch, fno_mod, batch_fn, tree, ts, engine, store, cfg):
    """Phase 34's training: the loss and every grad of one batch-8 step at
    the cached plans and at the rule plans (the cache switched off):
    exactly num_layers launches of each whole-block kind, equal grads."""
    params = fno_mod.init_fno(torch.Generator().manual_seed(34), cfg, DEVICE)
    batch = batch_fn(cfg, 8, DEVICE)(0)
    loss_fn = ts.make_loss_fn(cfg, fno_path="fused")
    got = {}
    for name in ("cache", "rule"):
        with store.disabled() if name == "rule" else contextlib.nullcontext():
            ts.value_and_grad(loss_fn, params, batch)  # warm
            torch.cuda.synchronize()
            engine.LAUNCHES.clear()
            got[name] = ts.value_and_grad(loss_fn, params, batch)
            torch.cuda.synchronize()
        dt = cfg.precision.compute_dtype
        want = {(k, dt): cfg.num_layers for k in ("block_fwd",) + BACKWARD}
        if dict(engine.LAUNCHES) != want:
            raise AssertionError(f"{cfg.name} train at the {name} plans ran "
                                 f"{dict(engine.LAUNCHES)}, want {want}")
    (l1, g1), (l2, g2) = got["cache"], got["rule"]
    err = max([abs(float(l1) - float(l2)) / max(abs(float(l2)), 1e-30)]
              + [leaf_err(a, b) for a, b in zip(tree.leaves(g1),
                                                tree.leaves(g2))])
    check(f"{cfg.name} train step, cached plans vs rule plans (loss and "
          f"every grad)", err, F32_TOL)


def phase_tuned(torch, configs, fno_mod, sfs, engine, build, batch_fn, tree,
                ts, card):
    """Phase 34: the tuned plans. The cache is fresh; every cached entry
    of fno2d, fno2d-large and fno3d at B=8 and B=1 holds against its plain
    version; each entry of theirs (B=1, 2, 4, 8) whose plan differs from
    the rule plan on this card is timed against it in turns (tuned, rule,
    rule, tuned), queued; fno2d and fno3d served and trained at the cached
    plans against the rule plans; the launch lint at full width and the
    shared-memory check of every preset with the card's libraries."""
    from repro_torch.analysis import errors, format_findings, smem
    from repro_torch.launch import lint
    from repro_torch.tuning import autotune, store
    log("== phase 34: tuned plans")
    libs = {"block": build.load_fused_block(),
            "wgrad": build.load_fused_wgrad(),
            "core": build.load_fused_core()}
    stale = errors(store.check_tuning_cache(core_lib=libs["core"]))
    if stale:
        raise AssertionError("the tuned plan cache is stale:\n"
                             + format_findings(stale))
    log(f"  check_tuning_cache: clean ({len(store.load_cache()['entries'])} "
        f"entries)")
    kinds = ("block_fwd", "core", "gz_recompute", "dx_adjoint", "wgrad")
    t0 = time.perf_counter()
    for w, fields in tuned_entries(configs, autotune, kinds, (8, 1)):
        probe = autotune.Probe(w, DEVICE, seed=34)
        outs = probe.run(tuple(sorted(fields.items())))
        torch.cuda.synchronize()
        err = max(rel_err(a, r) for a, r in zip(outs, probe.refs))
        check(f"{w.key} at its cached plan {fields}", err, probe.tol)
        del probe, outs
    log(f"  every entry at B=8 and B=1 against its plain version: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows = {}
    for w, fields in tuned_entries(configs, autotune, kinds, (1, 2, 4, 8)):
        rule = autotune.fields_of(w.kind, autotune._plan(
            w, None, libs[engine.kernel_of(w.kind)]))
        if rule == fields:
            continue
        probe = autotune.Probe(w, DEVICE, seed=34)
        run = lambda f: (lambda: probe.run(tuple(sorted(f.items()))))
        t = [time_ms(run(f), 10, queued=True)
             for f in (fields, rule, rule, fields)]
        faster = t[0] < t[1] and t[3] < t[2]
        rows[w.key] = {"tuned": fields, "rule": rule,
                       "tuned_ms": [t[0], t[3]], "rule_ms": [t[1], t[2]],
                       "faster_both_turns": faster}
        log(f"  {w.key}: tuned {fields} {t[0]:.4f}, {t[3]:.4f} ms; rule "
            f"{rule} {t[1]:.4f}, {t[2]:.4f} ms (turns tuned, rule, rule, "
            f"tuned; queued; {card}); tuned faster in both: {faster}")
    log(f"  {len(rows)} entries differ from the rule plan on this card "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    for arch in TUNED_SERVED:
        base = dataclasses.replace(configs.with_fuse_block(
            configs.get_config(arch)), path="fused")
        for dt in ("f32", "bf16"):
            cfg = configs.with_precision(base, dt)
            rule = autotune.fields_of("block_fwd", engine.plan_launch(
                "block_fwd", getattr(torch, cfg.precision.compute_dtype), 4,
                cfg.hidden, cfg.hidden, cfg.spatial, cfg.modes,
                lib=libs["block"]))
            serve_both_ways(torch, configs, fno_mod, sfs, engine, cfg, rule)
        train_both_ways(torch, fno_mod, batch_fn, tree, ts, engine, store,
                        base)
    log(f"  served and trained both ways: {time.perf_counter() - t0:.1f} s")
    findings = lint.run_checks(("launches", "casts"), "cuda", log=log)
    findings += smem.check_smem(libs=libs)
    if errors(findings):
        raise AssertionError("launch lint at full width:\n"
                             + format_findings(errors(findings)))
    log(f"  launch lint (fno2d at full width) and check_smem (every preset, "
        f"the card's libraries): clean ({len(findings)} warnings)")
    return rows



# ---------------------------------------------------------------------------
# Shapes beyond one cluster: the block and wgrad kernels' tiled plans
# ---------------------------------------------------------------------------
TILED_BATCH = 2   # the models' batch (phase 28's)
TILED_TIME_BATCH = 8  # the kernels' timed batch
TILED_STEPS = 5   # AdamW steps on one batch: the loss must fall
TILED_DESIGNS = {"whole-block": True, "spectral-only": False}


def tiled_plans(engine, build, cfg, b):
    """The block forward's and the wgrad's plans of `cfg` at batch b on
    this card, each checked tiled (s4's wgrad fits one cluster)."""
    per_mode = cfg.weight_mode == "per_mode"
    args = (b, cfg.hidden, cfg.hidden, cfg.spatial, cfg.modes, per_mode)
    block = engine.pick_plan(build.load_fused_block(), 0, *args,
                             kind="block_fwd")
    wgrad = engine.pick_wgrad_plan(build.load_fused_wgrad(), 0, *args,
                                   kind="wgrad")
    if not (block["hc"] < block["hs"] or block["ot"] > 1):
        raise AssertionError(f"{cfg.spatial} hidden {cfg.hidden}: the block "
                             f"plan {block} is not tiled")
    return block, wgrad


def tiled_kernel_cases(torch, engine, spectral, cfg, b, dt, seed):
    """name -> (kernel call, plain version on the same inputs in f32) of
    the block (gelu, gelu_vjp, the adjoint dx, the bare forward) and the
    wgrad (with and without the bypass) at `cfg`'s shape and batch b."""
    h, spatial, modes = cfg.hidden, tuple(cfg.spatial), tuple(cfg.modes)
    per_mode = cfg.weight_mode == "per_mode"
    gen = torch.Generator().manual_seed(seed)
    rn = lambda *s, sc=1.0: (sc * torch.randn(s, generator=gen)).to(DEVICE)
    wshape = (h, h) + (modes if per_mode else ())
    x, gy = rn(b, h, *spatial), rn(b, h, *spatial)
    wr, wi = rn(*wshape, sc=1.0 / h), rn(*wshape, sc=1.0 / h)
    wb, bias = rn(h, h, sc=1.0 / h), rn(h, 1, sc=0.3)
    tdt = getattr(torch, dt)
    t = lambda a: a.to(tdt).contiguous()
    sw = lambda a: t(a).transpose(0, 1)
    m = backward_mats(spectral, spatial, modes, dt)
    m32 = backward_mats(spectral, spatial, modes, "float32")
    wrt = wr.transpose(0, 1).contiguous()
    wit = wi.transpose(0, 1).contiguous()
    return {
        "block_fwd": (lambda: engine.fused_block(
            t(x), t(wr), t(wi), t(wb), t(bias), m["forward"]),
            lambda: engine.fused_block_plain(x, wr, wi, wb, bias,
                                             m32["forward"])),
        "gz_recompute": (lambda: engine.fused_block(
            t(x), t(wr), t(wi), t(wb), t(bias), m["forward"],
            act="gelu_vjp", gy=t(gy)),
            lambda: engine.fused_block_plain(x, wr, wi, wb, bias,
                                             m32["forward"],
                                             act="gelu_vjp", gy=gy)),
        "dx_adjoint": (lambda: engine.fused_block(
            t(gy), sw(wr), sw(wi), t(wb.t()), None, m["adjoint"],
            act="linear", out_dtype=torch.float32, adjoint=True),
            lambda: engine.fused_block_plain(gy, wrt, wit,
                                             wb.t().contiguous(), None,
                                             m32["adjoint"], act="linear")),
        "spectral_fwd": (lambda: engine.fused_block(
            t(x), t(wr), t(wi), None, None, m["forward"], act="linear"),
            lambda: engine.fused_block_plain(x, wr, wi, None, None,
                                             m32["forward"], act="linear")),
        "wgrad": (lambda: engine.fused_wgrad(
            t(x), t(gy), m["wgrad"], per_mode=per_mode),
            lambda: engine.fused_wgrad_plain(x, gy, m32["wgrad"],
                                             per_mode=per_mode)),
        "spectral_wgrad": (lambda: engine.fused_wgrad(
            t(x), t(gy), m["wgrad"], per_mode=per_mode, with_bypass=False),
            lambda: engine.fused_wgrad_plain(x, gy, m32["wgrad"],
                                             per_mode=per_mode,
                                             with_bypass=False)),
    }, (x, wr, wi, wb, bias, gy)


def tiled_model(torch, np, configs, fno_mod, sfs, ts, optim, tree, engine,
                batch_fn, cfg, fuse):
    """One design of `cfg` (whole-block or spectral-only), f32 and bf16:
    FNOServer (graphed; K=1 and K=4) against the staged path and exactly
    num_layers launches a step; step-0 loss and every grad against the
    staged path with exactly one launch of each kind a layer; TILED_STEPS
    AdamW steps whose loss falls. Returns the launches by (run, dtype)."""
    b, L = TILED_BATCH, cfg.num_layers
    cfg = configs.with_fuse_block(cfg, fuse)
    fwd_kind = "block_fwd" if fuse else "spectral_fwd"
    kinds = engine.KINDS if fuse else engine.SPECTRAL_KINDS
    params = fno_mod.init_fno(torch.Generator().manual_seed(0), cfg, DEVICE)
    fused = dataclasses.replace(cfg, path="fused")
    staged = dataclasses.replace(cfg, path="staged", fuse_block=False)
    shape = (cfg.in_channels,) + tuple(cfg.spatial)
    gen = torch.Generator().manual_seed(3501)
    reqs = [(torch.randn((n,) + shape, generator=gen).to(DEVICE), k)
            for n, k in ((1, 1), (2, 1), (2, 4), (1, 4))]
    batch = batch_fn(cfg, b, DEVICE)(0)
    loss_ref, g_ref = ts.value_and_grad(
        ts.make_loss_fn(staged, fno_path="staged"), params, batch)
    ref = sfs.FNOServer(staged, params, device=DEVICE, max_batch=b)
    refs = [ref(x, rollout_steps=k) for x, k in reqs]
    del ref
    counts = {}
    for preset in ("f32", "bf16"):
        c = configs.with_precision(fused, preset)
        dt = c.precision.compute_dtype
        srv = sfs.FNOServer(c, params, device=DEVICE, max_batch=b)
        srv.warm((1, 4))  # build, plan and capture outside the count
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        outs = [srv(x, rollout_steps=k) for x, k in reqs]
        torch.cuda.synchronize()
        counts[("serve", dt)] = dict(engine.LAUNCHES)
        want = {(fwd_kind, dt): L * sum(k for _, k in reqs)}
        if counts[("serve", dt)] != want:
            raise AssertionError(f"launches {counts[('serve', dt)]} != "
                                 f"{want}")
        tol = F32_TOL if preset == "f32" else BF16_TOL
        for (x, k), y, r in zip(reqs, outs, refs):
            if not bool(torch.isfinite(y).all()):
                raise AssertionError(f"non-finite output, K={k}")
            check(f"serve {preset} n={x.shape[0]} K={k} vs staged f32",
                  rel_err(y, r), tol)
        del srv
        torch.cuda.synchronize()
        engine.LAUNCHES.clear()
        loss, g = ts.value_and_grad(ts.make_loss_fn(c, fno_path="fused"),
                                    params, batch)
        torch.cuda.synchronize()
        counts[("train", dt)] = dict(engine.LAUNCHES)
        want = {(k, dt): L for k in kinds}
        if counts[("train", dt)] != want:
            raise AssertionError(f"launches {counts[('train', dt)]} != "
                                 f"{want}")
        gtol = F32_TOL if preset == "f32" else BF16_GRAD_TOL
        check(f"train {preset} step-0 loss vs staged f32",
              abs(float(loss) - float(loss_ref)) / abs(float(loss_ref)),
              gtol)
        for p, a, r in zip(tree.paths(g), tree.leaves(g),
                           tree.leaves(g_ref)):
            check(f"train {preset} grad {'.'.join(map(str, p))}",
                  leaf_err(a, r), gtol)
        opt = optim.AdamW(lr=optim.cosine_warmup(1e-3, 1, 10))
        step = ts.make_train_step(c, opt, fno_path="fused")
        p, st, losses = params, opt.init(params), []
        for _ in range(TILED_STEPS):
            p, st, m = step(p, st, batch)
            losses.append(float(m["loss"]))
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"{preset}: loss did not fall: {losses}")
        log(f"    {preset}: served {len(reqs)} requests (K=1, 4); step-0 "
            f"loss {float(loss):.6f} (staged {float(loss_ref):.6f}); "
            f"{TILED_STEPS} steps {losses[0]:.6f} -> {losses[-1]:.6f}; "
            f"launches {counts[('serve', dt)]} {counts[('train', dt)]}")
        del p, st, step, opt, g
    return counts


def phase_tiled(torch, np, engine, spectral, ops, configs, fno_mod, sfs,
                ts, optim, tree, build, batch_fn):
    """Phase 35: the shapes the block and wgrad kernels take only tiled
    (``configs.TILED``)."""
    log("== phase 35: tiled shapes (a hidden k-loop, out tiles)")
    rows = []
    for name in configs.TILED:
        cfg = configs.tiled_config(name)
        per_mode = cfg.weight_mode == "per_mode"
        h, spatial, modes = cfg.hidden, tuple(cfg.spatial), tuple(cfg.modes)
        what = (f"{name}: {len(spatial)}D {'x'.join(map(str, spatial))} "
                f"modes {'x'.join(map(str, modes))} hidden {h}"
                f"{' per-mode' if per_mode else ''}")
        block, wgrad = tiled_plans(engine, build, cfg, TILED_BATCH)
        log(f"  {what}: B={TILED_BATCH} block plan {block}; wgrad plan "
            f"{wgrad}")
        # Every mode of both kernels against its plain version, B=2.
        errs = {}
        for dt in DTYPES:
            tol = F32_TOL if dt == "float32" else BF16_TOL
            cases, _ = tiled_kernel_cases(torch, engine, spectral, cfg,
                                          TILED_BATCH, dt, 3502)
            for kind, (run, plain) in cases.items():
                out = run()
                torch.cuda.synchronize()
                errs[(kind, dt)] = errors(
                    out if isinstance(out, tuple) else (out,),
                    (lambda r: r if isinstance(r, tuple) else (r,))(plain()))
                check(f"{name} {kind} {dt} kernel vs plain",
                      errs[(kind, dt)][1], tol)
            del cases
        # The model in both designs, served and trained.
        counts = {}
        for design, fuse in TILED_DESIGNS.items():
            log(f"  {name}, {design}:")
            counts.update({(design,) + k: v for k, v in tiled_model(
                torch, np, configs, fno_mod, sfs, ts, optim, tree, engine,
                batch_fn, cfg, fuse).items()})
        gc.collect()
        torch.cuda.empty_cache()
        # The block forward and the wgrad timed at B=8, queued.
        b = TILED_TIME_BATCH
        tb, tw = tiled_plans(engine, build, cfg, b)
        log(f"  {what}: B={b} block plan {tb}; wgrad plan {tw}")
        for dt, peak, eb in (("float32", PEAK_F32_FLOPS, 4),
                             ("bfloat16", PEAK_BF16_FLOPS, 2)):
            tag = "f32" if dt == "float32" else "bf16"
            cases, (x, wr, wi, wb, bias, gy) = tiled_kernel_cases(
                torch, engine, spectral, cfg, b, dt, 3503)
            for kind in ("block_fwd", "wgrad"):
                run, plain = cases[kind]
                kms = time_ms(run, 5, warmup=2, queued=True)
                pms = time_ms(plain, 2, warmup=1, queued=True)
                if kind == "block_fwd":
                    t = lambda a: a.to(getattr(torch, dt))
                    lib_ms = time_ms(lambda: ops.fno_block_nd(
                        t(x), t(wr), t(wi), t(wb), t(bias).reshape(-1),
                        modes, path="ref"), 3, warmup=1, queued=True)
                else:
                    lib_ms = staged_wgrad_ms(torch, x, gy, modes, per_mode)
                bms, by = bound_ms(kind, b, h, h, spatial, modes, eb, peak,
                                   per_mode)
                where = ("serve" if kind == "block_fwd" else "train")
                launches = counts[("whole-block", where, dt)].get(
                    (kind, dt), 0)
                plan = tb if kind == "block_fwd" else tw
                e = errs[(kind, dt)]
                log(f"  {tag} {kind} B={b}: kernel_ms={kms:.4f} plain_ms="
                    f"{pms:.4f} staged_ms={lib_ms:.4f} bound_us="
                    f"{1e3 * bms:.2f} ({by}); launches {launches} ({where}, "
                    f"whole-block, B={TILED_BATCH})")
                rows.append({
                    "name": f"{kind}_tiled_{name}_{tag}", "route": "cuda",
                    "source": WGRAD_SOURCE if kind == "wgrad"
                    else BLOCK_SOURCE,
                    "replaces": WGRAD_REPLACES if kind == "wgrad"
                    else BLOCK_REPLACES,
                    "shape": f"{what} B={b}",
                    "plan": {k: plan[k] for k in ("cluster", "hs", "os",
                                                  "hc", "ot", "chain")},
                    "launches": launches, "max_abs_err": e[0],
                    "scaled_err": e[1],
                    "tol": F32_TOL if dt == "float32" else BF16_TOL,
                    "ms": kms, "plain_ms": pms, "bound_ms": bms,
                    "bound_by": by, "library_ms": None,
                    "library_note": "no single PyTorch call computes it",
                    ("torch_fft_ms" if kind == "block_fwd"
                     else "staged_ms"): lib_ms})
            del cases, x, wr, wi, wb, bias, gy
            gc.collect()
            torch.cuda.empty_cache()
    return rows


def phase_lm_serving(torch, card):
    """The LM zoo's serving path at full width and every preset reduced
    (``repro_torch.launch.lm_smoke``); raises on a failed check."""
    log("== phase 36: LM serving — qwen2-1.5b and hymba-1.5b at full "
        "width, f32 and bf16; the ten presets reduced")
    from repro_torch.launch import lm_smoke
    try:
        return lm_smoke.run(torch.device(DEVICE), log=log, card=card)
    finally:  # its ~30 GB of blocks back to the card for the FNO phases
        gc.collect()
        torch.cuda.empty_cache()


def phase_lm_training(torch, card):
    """The LM zoo's training path at full width and every preset reduced
    (``repro_torch.launch.lm_train_smoke``); raises on a failed check."""
    log("== phase 37: LM training — qwen2-1.5b and hymba-1.5b at full "
        "width, seq 4096, batch 4 in 2 microbatches, remat, f32 and bf16, "
        "the float64 oracle; the ten presets reduced")
    from repro_torch.launch import lm_train_smoke
    try:
        return lm_train_smoke.run(torch.device(DEVICE), log=log, card=card)
    finally:  # its ~50 GB of blocks back to the card for the FNO phases
        gc.collect()
        torch.cuda.empty_cache()


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
    from repro_torch.kernels import build, dft, engine, ops
    from repro_torch.launch.train_fno import batch_fn
    from repro_torch.kernels import cgemm as cgemm_k
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

    card, builds = timed("1", phase_environment, torch, build)
    lm = timed("36", phase_lm_serving, torch, card)  # beside the builds
    lm_train = timed("37", phase_lm_training, torch, card)  # beside them too
    timed("1 builds", finish_builds, build, builds)
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
                                      fno_mod, batch_fn, tree, ts, optim,
                                      engine)
    train_stats, bwd_rows = timed(
        "7", phase_train_times, torch, np, engine, spectral, ops, configs,
        batch, runs, train_counts, bwd_errs)
    for row in rows:  # the forward kernel's launches on the training path
        dt = "float32" if row["name"].endswith("f32") else "bfloat16"
        row["launches_train"] = train_counts[dt].get(("block_fwd", dt), 0)
    rows += bwd_rows
    part_errs = timed("8", phase_partial_vs_plain, torch, engine, spectral,
                      dft, configs)
    part_counts = timed("9", phase_serve_partial, torch, np, sfs, engine,
                        servers)
    _, part_runs, part_train_counts = timed(
        "10", phase_train, torch, configs, fno_mod, batch_fn, tree, ts, optim,
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
    # fno2d-large: per-mode weights at hidden 128, both variants.
    pm_errs = timed("12", phase_per_mode_vs_plain, torch, engine, spectral,
                    configs)
    large_counts, large_servers = timed("13", phase_serve_large, torch, np,
                                        configs, fno_mod, sfs, engine)
    large_layers = large_servers["fused"].cfg.num_layers
    large_stats = {}
    for variant, names, kinds in (
            ("full", ("fused", "bf16"), ("block_fwd",)),
            ("partial", ("partial", "partial_bf16"), engine.PARTIAL_KINDS)):
        large_stats[variant] = timed(
            f"13 window {variant}", phase_serve_window, torch, np,
            large_servers, engine, large_layers, names=names, kinds=kinds,
            phase="13", requests=LARGE_WINDOW)
    del large_servers
    large_train, large_train_counts = {}, {}
    for variant in ("full", "partial"):
        large_batch, large_runs, large_train_counts[variant] = timed(
            f"14 {variant}", phase_train, torch, configs, fno_mod, batch_fn,
            tree, ts, optim, engine, variant=variant, phase="14",
            arch=LARGE)
        log(f"== phase 14: train window, {LARGE}, variant {variant}")
        large_train[variant] = timed(f"14 train {variant}", train_window,
                                     torch, np, large_batch, large_runs)
        del large_runs
    large_rows, large_extra = timed(
        "15", phase_large_times, torch, engine, spectral, dft, ops, configs,
        sfs, fno_mod, pm_errs, large_counts, large_train_counts)
    rows += large_rows
    # The spectral-only path (fuse_block off) and the complex product.
    sp_errs, cgemm_counts = timed("16", phase_spectral_vs_plain, torch,
                                  engine, spectral, configs, ops, cgemm_k)
    sp_counts, sp_names = timed("17", phase_serve_spectral, torch, np,
                                configs, sfs, engine, servers)
    sp_stats = {}
    for variant, kinds in (("full", ("spectral_fwd",)),
                           ("partial", engine.PARTIAL_KINDS)):
        sp_stats[variant] = timed(
            f"17 window {variant}", phase_serve_window, torch, np, servers,
            engine, layers, names=sp_names[variant], kinds=kinds,
            phase="17", requests=SPECTRAL_WINDOW)
    sp_train, sp_train_counts = {}, {}
    for arch, presets in (("fno2d", ("f32", "bf16")), (LARGE, ("f32",))):
        for variant in ("full", "partial"):
            sp_batch, sp_runs, sp_train_counts[(arch, variant)] = timed(
                f"18 {arch} {variant}", phase_train, torch, configs,
                fno_mod, batch_fn, tree, ts, optim, engine, variant=variant,
                phase="18", arch=arch, fuse_block=False, presets=presets)
            log(f"== phase 18: train window, {arch}, variant {variant}, "
                f"spectral-only")
            sp_train[f"{arch} {variant}"] = timed(
                f"18 train {arch} {variant}", train_window, torch, np,
                sp_batch, sp_runs)
            del sp_runs
    rows += timed("19", phase_spectral_times, torch, engine, spectral, ops,
                  configs, cgemm_k, sp_errs, sp_counts, sp_train_counts,
                  cgemm_counts)
    # fno3d at full width on every fused path, and the linear block.
    f3_errs, f3_waves, linear_counts = timed(
        "20", phase_fno3d_vs_plain, torch, engine, spectral, dft, ops,
        configs, build)
    f3_serve_counts, f3_servers = timed("21", phase_serve_fno3d, torch, np,
                                        configs, fno_mod, sfs, engine)
    f3_layers = configs.get_config(FNO3D).num_layers
    f3_stats = {}
    for design, kinds in (("block full", ("block_fwd",)),
                          ("spectral full", ("spectral_fwd",)),
                          ("block partial", engine.PARTIAL_KINDS),
                          ("spectral partial", engine.PARTIAL_KINDS)):
        f3_stats[design] = timed(
            f"21 window {design}", phase_serve_window, torch, np,
            f3_servers, engine, f3_layers,
            names=(f"{design} f32", f"{design} bf16"), kinds=kinds,
            phase="21", requests=FNO3D_WINDOW)
    del f3_servers
    f3_train, f3_train_counts = {}, {}
    for design, (fuse, variant) in FNO3D_DESIGNS.items():
        f3_batch, f3_runs, f3_train_counts[design] = timed(
            f"22 {design}", phase_train, torch, configs, fno_mod, batch_fn,
            tree, ts, optim, engine, variant=variant, phase="22", arch=FNO3D,
            fuse_block=fuse)
        log(f"== phase 22: train window, {FNO3D}, {design}")
        f3_train[design] = timed(f"22 train {design}", train_window, torch,
                                 np, f3_batch, f3_runs)
        del f3_runs
    rows += timed("23", phase_fno3d_times, torch, engine, spectral, dft,
                  ops,
                  configs, f3_errs, f3_serve_counts, f3_train_counts,
                  linear_counts)
    # The fused model ends (cfg.fuse_ends) at fno2d and fno3d.
    t_ends = time.perf_counter()
    ends_errs = timed("24", phase_ends_vs_plain, torch, engine, spectral,
                      configs)
    ends_serve_counts, ends_stats = timed(
        "25", phase_serve_ends, torch, np, configs, fno_mod, sfs, engine)
    ends_train, ends_train_counts = {}, {}
    for arch in ENDS_SERVED:
        e_batch, e_runs, ends_train_counts[arch] = timed(
            f"26 {arch}", phase_train, torch, configs, fno_mod, batch_fn,
            tree, ts, optim, engine, phase="26", arch=arch, fuse_ends=True)
        log(f"== phase 26: train window, {arch}, fused ends")
        ends_train[arch] = timed(f"26 train {arch}", train_window, torch,
                                 np, e_batch, e_runs)
        del e_runs
    rows += timed("27", phase_ends_times, torch, engine, spectral, ops,
                  configs, ends_errs, ends_serve_counts, ends_train_counts)
    log(f"phases 24-27 (fused ends): {time.perf_counter() - t_ends:.1f} s")
    rows += timed("28", phase_refused_shape, torch, engine, spectral,
                  configs, fno_mod, sfs, ts, optim, tree, build)
    # The runtime around the kernels.
    graphs = timed("29", phase_graphs, torch, np, configs, fno_mod, sfs,
                   engine, card)
    resilient = timed("30", phase_resilient, torch, configs, fno_mod,
                      engine)
    queue = timed("31", phase_queue, torch, np, configs, fno_mod, sfs)
    trainer = timed("32", phase_trainer, torch, configs, fno_mod, batch_fn,
                    ts, optim)
    # The DP×TP mesh.
    shard_rows = timed("33 shards", phase_shards_vs_plain, torch, engine,
                       spectral, configs)
    mesh_launches, cards = timed("33 mesh", phase_mesh, torch, np, configs,
                                 fno_mod, sfs, ts, optim, tree, engine,
                                 batch_fn)
    tuned = timed("34", phase_tuned, torch, configs, fno_mod, sfs, engine,
                  build, batch_fn, tree, ts, card)
    rows += timed("35", phase_tiled, torch, np, engine, spectral, ops,
                  configs, fno_mod, sfs, ts, optim, tree, build, batch_fn)
    for row in shard_rows:  # the launches at each shard shape, every rank
        mesh, names = SHARD_RUNS[row.pop("shard")]
        dt = row.pop("dtype")
        row["launches"] = sum(mesh_launches[(mesh, n)].get(
            f"block_linear/{dt}", 0) for n in names)
        row["launches_note"] = (
            f"block_linear launches of every rank of dp{mesh[0]}xtp"
            f"{mesh[1]} in phase 33" if mesh else
            "the one-rank linear block, timed beside the shards")
    rows += shard_rows
    window = lambda st: {dt: {"p50": v["latency_ms"]["p50"],
                              "p99": v["latency_ms"]["p99"],
                              "sample_steps_per_s": v["sample_steps_per_s"]}
                         for dt, v in st.items()}
    serve_vs = {"whole_block": window(stats),
                "spectral_only": {v: window(st) for v, st in
                                  sp_stats.items()}}
    log(f"fno2d serve, whole-block (phase 4) vs spectral-only (phase 17): "
        f"{json.dumps(serve_vs)}")
    median = lambda st: {dt: v["step_ms_median"] for dt, v in st.items()}
    train_vs = {"fno2d whole_block full": median(train_stats),
                "fno2d whole_block partial": median(part_train)}
    train_vs.update({f"{LARGE} whole_block {v}": median(st)
                     for v, st in large_train.items()})
    train_vs.update({f"{k} spectral_only": median(st)
                     for k, st in sp_train.items()})
    log(f"train step ms median, whole-block vs spectral-only: "
        f"{json.dumps(train_vs)}")
    log(f"serve window: {json.dumps(stats)}")
    log(f"train window: {json.dumps(train_stats)}")
    log(f"serve window, partial: {json.dumps(part_stats)}")
    log(f"train window, partial: {json.dumps(part_train)}")
    log(f"block forward, partial vs full: {json.dumps(part_block)}")
    log(f"{LARGE} serve windows: {json.dumps(large_stats)}")
    log(f"{LARGE} train windows: {json.dumps(large_train)}")
    log(f"{LARGE} row kernels and served block: {json.dumps(large_extra)}")
    log(f"serve windows, spectral-only: {json.dumps(sp_stats)}")
    log(f"train windows, spectral-only: {json.dumps(sp_train)}")
    log(f"{FNO3D} cluster occupancy: {json.dumps(f3_waves)}")
    log(f"{FNO3D} serve windows: {json.dumps(f3_stats)}")
    log(f"{FNO3D} train windows: {json.dumps(f3_train)}")
    log(f"{FNO3D} train step ms median: "
        f"{json.dumps({k: median(st) for k, st in f3_train.items()})}")
    log(f"serve windows, fused ends: {json.dumps(ends_stats)}")
    log(f"train windows, fused ends: {json.dumps(ends_train)}")
    ends_vs = {arch: {"ends": median(ends_train[arch]),
                      "whole_block": median(train_stats if arch == "fno2d"
                                            else f3_train["block full"]),
                      "ends_peak_bytes": {dt: v["peak_memory_bytes"] for
                                          dt, v in ends_train[arch].items()}}
               for arch in ENDS_SERVED}
    log(f"train step ms median, fused ends vs whole-block: "
        f"{json.dumps(ends_vs)}")
    log(f"graphed vs eager serving, fno2d f32 ({card}): "
        f"{json.dumps(graphs['times'])}")
    log(f"resilient serving: "
        f"{json.dumps({k: v['stats'] for k, v in resilient.items()})}")
    log(f"continuous batching: {json.dumps(queue)}")
    log(f"trainer: {json.dumps(trainer)}")
    log(f"mesh: {cards} card(s), backend {MESH_BACKEND}; launches by "
        f"(mesh, case), every rank: " + json.dumps(
            {f"dp{m[0]}xtp{m[1]} {n}": dict(v)
             for (m, n), v in mesh_launches.items()}))
    log(f"tuned plans against the rule plan at B=8 ({card}): "
        f"{json.dumps(tuned)}")
    log(f"LM serving, full width ({card}): " + json.dumps(
        {f"{arch} {dt}": {k: v for k, v in r.items() if k != "tokens_row0"}
         for arch, res in lm["full_width"].items()
         for dt, r in res.items()}))
    log(f"LM attention at the prefill shape ({card}): "
        f"{json.dumps(lm['attention'])}")
    log(f"LM training, full width ({card}): " + json.dumps(
        {f"{arch} {dt}": {k: v for k, v in res[dt].items()
                          if k != "step_ms"}
         for arch, res in lm_train["full_width"].items()
         for dt in ("f32", "bf16")}))
    log(f"LM training, float64 oracle ({card}): " + json.dumps(
        {arch: res["oracle"] for arch, res in
         lm_train["full_width"].items()}))
    log(f"phase seconds: {json.dumps(seconds)}")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
