"""Port parity: the training runtime (``repro_torch.train.trainer``,
``data.pipeline``, ``distributed.fault_tolerance``) against the JAX
reference's — the same data and fault plan give the same loss a step
(within 2e-4) and equal NaN-skip, restart and save-retry counts; a
restart restores params and AdamW state from a checkpoint either package
wrote; the prefetch pipeline's timeout and terminal producer death; the
watchdog's one-shot firing; the straggler monitor's reset.
"""
import tempfile
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import fno as jfno
from repro.data import pde as jpde
from repro.distributed import faults as jflt
from repro.optim import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.train.train_step import make_train_step as jmake_train_step
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.distributed import faults as flt
from repro_torch.distributed.fault_tolerance import StragglerMonitor, Watchdog
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train import trainer as trn
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import (NaNBudgetExceeded, Trainer,
                                       TrainerConfig, WatchdogTimeout)

STEPS = 8


@pytest.fixture(scope="module")
def task():
    """Reduced fno1d, its reference params and 8 Burgers batches made by
    the reference (as numpy, so both trainers read the same numbers)."""
    cfg = jget_config("fno1d", reduced=True)
    params = jfno.init_fno(jax.random.PRNGKey(0), cfg)
    batches = [jax.tree_util.tree_map(
        np.asarray, jpde.burgers_batch(0, i, 4, cfg.spatial[0]))
        for i in range(STEPS)]
    return cfg, params, batches


def _ref_trainer(task, d, plan=None, fail_at=None, **kw):
    cfg, params, batches = task
    opt = JAdamW(lr=jconstant(1e-3))
    step = jax.jit(jmake_train_step(cfg, opt, fno_path="xla"))
    tc = JTrainerConfig(total_steps=STEPS, ckpt_every=4, ckpt_dir=d,
                        log_every=1, ckpt_async=False, **kw)
    return JTrainer(tc, step, lambda i: batches[i], params,
                    opt_state=opt.init(params), fail_at=fail_at,
                    fault_plan=plan)


def _port_trainer(task, d, plan=None, fail_at=None, **kw):
    _, params, batches = task
    cfg = tconfigs.get_config("fno1d", reduced=True)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    opt = AdamW(lr=constant(1e-3))
    step = make_train_step(cfg, opt, fno_path="staged")
    data = lambda i: {k: torch.tensor(v) for k, v in batches[i].items()}
    tc = TrainerConfig(total_steps=STEPS, ckpt_every=4, ckpt_dir=d,
                       log_every=1, ckpt_async=False, **kw)
    return Trainer(tc, step, data, tparams, opt_state=opt.init(tparams),
                   fail_at=fail_at, fault_plan=plan)


def _plan(mod):
    return mod.FaultPlan([mod.Fault("nan", at=2, scope="train"),
                          mod.Fault("ckpt_io", at=4, scope="train")])


def test_trainer_matches_reference_under_the_same_plan(task):
    """A NaN step, a failed save and a node failure at step 6: the same
    losses a step (the steps 4–5 replayed after the restart included),
    one NaN skip, one save retry and one restart in both packages."""
    with tempfile.TemporaryDirectory() as dj, \
            tempfile.TemporaryDirectory() as dt:
        ref = _ref_trainer(task, dj, _plan(jflt),
                           fail_at={6: RuntimeError("node died")},
                           ckpt_backoff_s=0.001)
        ours = _port_trainer(task, dt, _plan(flt),
                             fail_at={6: RuntimeError("node died")},
                             ckpt_backoff_s=0.001)
        jout = ref.run_with_restarts()
        tout = ours.run_with_restarts()
        assert ours.restarts == ref.restarts == 1
        for k in ("final_step", "nan_skipped", "ckpt_save_retries"):
            assert tout[k] == jout[k], k
        assert tout["nan_skipped"] == 1 and tout["ckpt_save_retries"] == 1
        assert ([m["step"] for m in tout["metrics"]]
                == [m["step"] for m in jout["metrics"]])
        for tm, jm in zip(tout["metrics"], jout["metrics"]):
            assert abs(tm["loss"] - jm["loss"]) <= 2e-4 * max(
                abs(jm["loss"]), 1.0), (tm, jm)
        # both checkpoints hold the same final state: the port restores
        # the reference's, the reference the port's
        assert ours.ckpt.latest_valid_step() == STEPS
        got = ours.ckpt.restore(STEPS, {"params": ours.params,
                                        "opt": ours.opt_state})
        theirs = Checkpointer(dj).restore(
            STEPS, {"params": ours.params, "opt": ours.opt_state})
        for a, b in zip(tree.leaves(got), tree.leaves(theirs)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-6)


def test_restart_resumes_from_a_reference_checkpoint(task):
    """The reference trains 4 steps and saves; the port resumes its run
    from that checkpoint (params and AdamW state) and continues as the
    reference's uninterrupted run does."""
    with tempfile.TemporaryDirectory() as dj, \
            tempfile.TemporaryDirectory() as dj2:
        ref = _ref_trainer(task, dj)
        ref.cfg.total_steps = 4
        ref.run()
        ours = _port_trainer(task, dj)  # the reference's directory
        tout = ours.run()
        assert [m["step"] for m in tout["metrics"]] == [4, 5, 6, 7]
        full = _ref_trainer(task, dj2).run()
        for tm, jm in zip(tout["metrics"], full["metrics"][4:]):
            assert abs(tm["loss"] - jm["loss"]) <= 2e-4 * max(
                abs(jm["loss"]), 1.0)


def test_nan_budget_exceeded_raises_not_restarts(task):
    plan = flt.FaultPlan([flt.Fault("nan", at=s, scope="train")
                          for s in (1, 2, 3)])
    with tempfile.TemporaryDirectory() as d:
        tr = _port_trainer(task, d, plan, nan_skip_budget=2)
        with pytest.raises(NaNBudgetExceeded):
            tr.run_with_restarts()
        assert tr.restarts == 0 and tr.nan_skipped == 3


def test_save_failure_past_the_retries_raises(task):
    plan = flt.FaultPlan([flt.Fault("ckpt_io", at=4, scope="train")])
    with tempfile.TemporaryDirectory() as d:
        tr = _port_trainer(task, d, plan, ckpt_retries=0)
        with pytest.raises(IOError, match="injected"):
            tr.run()


class _StallWatchdog:
    """The trainer's watchdog without its thread or a clock: a planned
    stall longer than the timeout fires it, as the real one would."""

    live = []

    def __init__(self, timeout_s, on_timeout):
        self.timeout_s, self.on_timeout, self.fired = timeout_s, on_timeout, 0
        _StallWatchdog.live.append(self)

    def beat(self):
        pass

    def stop(self):
        pass


def test_watchdog_timeout_triggers_restart(task, monkeypatch):
    """A stall at step 5 fires the watchdog: the step raises
    ``WatchdogTimeout`` into the restart path, which restores step 4 and
    finishes. The stall is a planned delay whose sleep fires the stand-in
    watchdog, so no real step can cross a timing threshold."""
    def stall(seconds):
        wd = _StallWatchdog.live[-1]
        if seconds > wd.timeout_s:
            wd.fired += 1
            wd.on_timeout()

    monkeypatch.setattr(trn, "Watchdog", _StallWatchdog)
    monkeypatch.setattr(trn, "time", types.SimpleNamespace(
        monotonic=time.monotonic, sleep=stall))
    _StallWatchdog.live.clear()
    plan = flt.FaultPlan([flt.Fault("delay", at=5, scope="train",
                                    delay_s=3.0)])
    with tempfile.TemporaryDirectory() as d:
        tr = _port_trainer(task, d, plan, step_timeout_s=1.5)
        out = tr.run_with_restarts()
        assert tr.restarts == 1 and out["final_step"] == STEPS
        assert [w.fired for w in _StallWatchdog.live] == [1, 0]
        assert tr.ckpt.latest_valid_step() == STEPS
    with pytest.raises(WatchdogTimeout):
        tr._watchdog_stall = 1.0
        tr._check_watchdog()


def test_restore_skips_a_corrupt_checkpoint(task):
    with tempfile.TemporaryDirectory() as d:
        tr = _port_trainer(task, d,
                           fail_at={6: RuntimeError("node died")})
        save = tr._save_ckpt

        def save_and_corrupt(step):
            save(step)
            if step == 4:
                flt.corrupt_checkpoint(d, 4)

        tr._save_ckpt = save_and_corrupt
        out = tr.run_with_restarts()
        assert tr.restarts == 1 and out["final_step"] == STEPS


# ---------------------------------------------------------------------------
# the prefetch pipeline, the watchdog, the straggler monitor
# ---------------------------------------------------------------------------
def test_pipeline_zero_timeout_polls():
    def slow(i):
        time.sleep(0.05)
        return {"x": i}

    pipe = PrefetchPipeline(slow, depth=1)
    try:
        idx, batch = pipe.get(timeout=0)
        assert batch == {"x": idx} and pipe.skipped >= 1
    finally:
        pipe.stop()
    assert not pipe._thread.is_alive()


def test_pipeline_dead_producer_is_terminal():
    def dies(i):
        if i >= 2:
            raise ValueError("disk ate the shard")
        return {"x": i}

    pipe = PrefetchPipeline(dies, depth=1)
    try:
        assert pipe.get(timeout=1.0)[0] == 0
        assert pipe.get(timeout=1.0)[0] == 1
        with pytest.raises(RuntimeError, match="failed at index 2"):
            pipe.get(timeout=1.0)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="failed at index 2"):
            pipe.get(timeout=None)
        assert time.monotonic() - t0 < 0.5
    finally:
        pipe.stop()


def test_pipeline_starts_at_its_index_and_stops_a_blocked_producer():
    pipe = PrefetchPipeline(lambda i: {"x": i}, start_index=5, depth=1)
    assert pipe.get(timeout=1.0) == (5, {"x": 5})
    time.sleep(0.05)  # the producer fills the queue and blocks on put
    pipe.stop()
    assert not pipe._thread.is_alive()


def test_watchdog_fires_once_per_stall():
    fired = []
    wd = Watchdog(0.1, lambda: fired.append(1))
    try:
        time.sleep(0.6)
        assert len(fired) == 1 and wd.fired == 1
        wd.beat()
        time.sleep(0.4)
        assert len(fired) == 2
    finally:
        wd.stop()


def test_watchdog_beat_prevents_fire():
    fired = []
    wd = Watchdog(0.3, lambda: fired.append(1))
    try:
        for _ in range(6):
            time.sleep(0.05)
            wd.beat()
        assert fired == []
    finally:
        wd.stop()


def test_watchdog_callback_runs_outside_lock():
    done = threading.Event()
    holder = {}

    def cb():
        holder["wd"].beat()  # would deadlock inside the checker's lock
        done.set()

    holder["wd"] = Watchdog(0.1, cb)
    try:
        assert done.wait(2.0)
    finally:
        holder["wd"].stop()


def test_straggler_monitor_flags_and_resets():
    m = StragglerMonitor(ratio=2.0, decay=0.5)
    for s in range(5):
        m.record(s, 0.1)
    assert m.record(5, 0.5) is True and m.flagged == [5]
    assert m.record(6, 0.1) is False
    m.reset()
    assert m.ema is None and m.flagged == []
    assert m.record(7, 0.5) is False
