"""Training loop with checkpoint/restart, failure injection, and straggler
monitoring (counterpart of ``repro/train/trainer.py``).

The loop is restart-idempotent: its state is (params, opt_state), both in
the checkpoint; the data pipeline is stateless (batch = f(seed, step)), so
a restart at step k replays nothing and skips nothing. It absorbs faults:
a fired watchdog raises ``WatchdogTimeout`` into the restart path, a
non-finite loss or grad norm discards the poisoned update under a bounded
skip budget, checkpoint saves retry with exponential backoff, and restore
goes through ``Checkpointer.latest_valid_step`` so a corrupt checkpoint is
skipped instead of fatal. Deterministic faults are injected through the
explicit ``distributed.faults.FaultPlan`` hooks (scope="train").

The checkpoint holds ``{"params": ..., "opt": ...}``; the port's AdamW
state ``{"m", "v", "step"}`` has the reference's tree, so both halves
restore across the two packages.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.distributed import faults as flt
from repro_torch.distributed.fault_tolerance import StragglerMonitor, Watchdog


class WatchdogTimeout(RuntimeError):
    """A training step exceeded ``step_timeout_s`` — raised into the loop
    so ``run_with_restarts`` restores from the last valid checkpoint."""


class NaNBudgetExceeded(RuntimeError):
    """More than ``nan_skip_budget`` non-finite steps — the poisoning is
    persistent, so restarting would replay it; surface instead."""


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    ckpt_async: bool = True
    log_every: int = 10
    step_timeout_s: float = 0.0  # 0 = watchdog off
    prefetch_depth: int = 2
    data_timeout_s: Optional[float] = None
    nan_skip_budget: int = 3     # non-finite steps absorbed before raising
    ckpt_retries: int = 2        # extra save attempts after a failure
    ckpt_backoff_s: float = 0.05  # first retry delay (doubles per attempt)


class Trainer:
    """Runs ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", ...})`` (``train/train_step.make_train_step``)
    over ``batch_fn(step)`` for ``cfg.total_steps`` steps."""

    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 batch_fn: Callable[[int], Dict], params: Any,
                 opt_state: Any,
                 fail_at: Optional[Dict[int, Exception]] = None,
                 fault_plan: Optional[flt.FaultPlan] = None):
        self.cfg = cfg
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.params = params
        self.opt_state = opt_state
        self.ckpt = Checkpointer(cfg.ckpt_dir)
        self.monitor = StragglerMonitor()
        self.metrics_log: List[Dict] = []
        self.restarts = 0
        self.nan_skipped = 0
        self.ckpt_save_retries = 0
        self._fail_at = fail_at or {}  # step -> exception (failure injection)
        self._plan = fault_plan
        self._watchdog_stall = 0.0  # set by the watchdog thread

    # ------------------------------------------------------------------
    def _restore_if_any(self) -> int:
        step = self.ckpt.latest_valid_step()
        if step is None:
            return 0
        state = self.ckpt.restore(
            step, {"params": self.params, "opt": self.opt_state})
        self.params, self.opt_state = state["params"], state["opt"]
        return step

    def _on_watchdog(self) -> None:
        # Runs on the watchdog thread: record the stall; the loop raises
        # WatchdogTimeout from its own thread at the next boundary.
        self._watchdog_stall = time.monotonic()

    def _check_watchdog(self) -> None:
        if self._watchdog_stall:
            self._watchdog_stall = 0.0
            raise WatchdogTimeout(
                f"training step exceeded {self.cfg.step_timeout_s}s — "
                f"restarting from the last valid checkpoint")

    def _save_ckpt(self, step: int) -> None:
        """Checkpoint save with bounded retry + exponential backoff: a
        transient I/O failure (injected through a FaultPlan kind="ckpt_io",
        or a flaky filesystem) costs a retry, not the run."""
        delay = self.cfg.ckpt_backoff_s
        for attempt in range(self.cfg.ckpt_retries + 1):
            try:
                if self._plan and self._plan.take("train", step,
                                                  kind="ckpt_io"):
                    raise IOError(
                        f"injected checkpoint I/O fault at step {step}")
                self.ckpt.save(
                    step, {"params": self.params, "opt": self.opt_state},
                    blocking=not self.cfg.ckpt_async)
                return
            except Exception:  # noqa: BLE001 — retried, then re-raised
                if attempt == self.cfg.ckpt_retries:
                    raise
                self.ckpt_save_retries += 1
                time.sleep(delay)
                delay *= 2

    def run(self) -> Dict[str, Any]:
        self._watchdog_stall = 0.0  # a stale stall must not fail a restart
        start = self._restore_if_any()
        pipe = PrefetchPipeline(self.batch_fn, start_index=start,
                                depth=self.cfg.prefetch_depth)
        wd = None
        if self.cfg.step_timeout_s > 0:
            wd = Watchdog(self.cfg.step_timeout_s, self._on_watchdog)
        step = start
        try:
            while step < self.cfg.total_steps:
                t0 = time.monotonic()
                _, batch = pipe.get(timeout=self.cfg.data_timeout_s)
                self._check_watchdog()
                if self._plan:
                    for f in self._plan.take("train", step, kind="delay"):
                        time.sleep(f.delay_s)
                    if self._plan.take("train", step, kind="nan"):
                        batch = flt.poison_batch(batch)
                if step in self._fail_at:  # injected failure
                    raise self._fail_at.pop(step)
                new_params, new_opt, m = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(m["loss"])  # waits for the step
                grad_norm = float(m["grad_norm"])
                self._check_watchdog()
                if not (math.isfinite(loss) and math.isfinite(grad_norm)):
                    # Non-finite guard: discard the poisoned update (the
                    # params and opt_state are untouched) under a bounded
                    # budget.
                    self.nan_skipped += 1
                    if self.nan_skipped > self.cfg.nan_skip_budget:
                        raise NaNBudgetExceeded(
                            f"{self.nan_skipped} non-finite steps exceed "
                            f"the skip budget ({self.cfg.nan_skip_budget})"
                            f" — loss/grad poisoning is persistent, not "
                            f"transient")
                    if wd:
                        wd.beat()
                    step += 1
                    continue
                self.params, self.opt_state = new_params, new_opt
                dt = time.monotonic() - t0
                self.monitor.record(step, dt)
                if wd:
                    wd.beat()
                if step % self.cfg.log_every == 0:
                    self.metrics_log.append(
                        {"step": step, "loss": loss,
                         "grad_norm": grad_norm, "dt": dt})
                step += 1
                if (step % self.cfg.ckpt_every == 0
                        or step == self.cfg.total_steps):
                    self._save_ckpt(step)
        finally:
            pipe.stop()
            if wd:
                wd.stop()
            self.ckpt.wait()
        return {"final_step": step, "metrics": self.metrics_log,
                "stragglers": self.monitor.flagged,
                "skipped_batches": pipe.skipped,
                "nan_skipped": self.nan_skipped,
                "ckpt_save_retries": self.ckpt_save_retries}

    # ------------------------------------------------------------------
    def run_with_restarts(self, max_restarts: int = 3) -> Dict[str, Any]:
        """Run to completion, restarting from the last valid checkpoint on
        any failure. ``NaNBudgetExceeded`` is NOT restartable: the data is
        deterministic in (seed, step), so a replay would re-poison."""
        while True:
            try:
                return self.run()
            except NaNBudgetExceeded:
                raise
            except Exception:  # noqa: BLE001 — the restart boundary
                self.restarts += 1
                if self.restarts > max_restarts:
                    raise
                self.monitor.reset()  # post-restart EMA must start fresh
                self._restore_if_any()
