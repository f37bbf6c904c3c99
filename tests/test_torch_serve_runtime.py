"""Port parity: the resilient serving runtime
(``repro_torch.train.serve_runtime``) and the fault harness
(``repro_torch.distributed.faults``) against the JAX reference's — the
same canned chaos plans give the same ``STAT_KEYS`` and pool states and
outputs within 2e-4 (f32); a reload from a checkpoint the reference wrote;
rollback on corruption; shedding and deadlines; the plan's fire-once
semantics and the poison helpers on tensors.
"""
import dataclasses
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.core import fno as jfno
from repro.distributed import faults as jflt
from repro.train import serve_runtime as jsrt
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import params_from_jax
from repro_torch.distributed import faults as flt
from repro_torch.train import serve_runtime as srt

PARITY_TOL = 2e-4


def _scaled_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def setup():
    """Reduced fno2d: the reference's production path (fused-block pallas)
    and the port's fused path on the CPU, with the same params and one
    request batch."""
    jcfg = dataclasses.replace(jget_config("fno2d", reduced=True),
                               path="pallas", fuse_block=True)
    tcfg = dataclasses.replace(
        tconfigs.with_fuse_block(tconfigs.get_config("fno2d", reduced=True)),
        path="fused")
    jparams = jfno.init_fno(jax.random.PRNGKey(0), jcfg)
    jparams2 = jfno.init_fno(jax.random.PRNGKey(7), jcfg)
    x = np.random.default_rng(1).normal(
        size=(2, jcfg.in_channels) + tuple(jcfg.spatial)).astype(np.float32)
    return jcfg, tcfg, jparams, jparams2, x


def _pair(setup, plan_name=None, **kw):
    jcfg, tcfg, jparams, _, _ = setup
    kw.setdefault("replicas", 2)
    kw.setdefault("max_batch", 2)
    kw.setdefault("backoff_base_s", 1e-3)
    jplan = tplan = None
    if plan_name is not None:
        jplan = jflt.canned_chaos_plans()[plan_name]
        tplan = flt.canned_chaos_plans()[plan_name]
    ref = jsrt.ResilientServer(jcfg, jparams, fault_plan=jplan, **kw)
    ours = srt.ResilientServer(
        tcfg, params_from_jax(_np_tree(jparams)), device="cpu",
        fault_plan=tplan, **kw)
    return ref, ours


def test_stat_keys_are_the_references():
    assert srt.ResilientServer.STAT_KEYS == jsrt.ResilientServer.STAT_KEYS
    assert len(srt.ResilientServer.STAT_KEYS) == 12


def test_canned_plans_are_the_references():
    ours, theirs = flt.canned_chaos_plans(), jflt.canned_chaos_plans()
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        assert ([dataclasses.astuple(f) for f in ours[name].faults]
                == [dataclasses.astuple(f) for f in theirs[name].faults])


@pytest.mark.parametrize("name", sorted(flt.canned_chaos_plans()))
def test_every_canned_plan_matches_reference(setup, name):
    """Five requests through both runtimes under the same plan: equal
    stats and pool states, every answer within 2e-4 of the reference's."""
    x = setup[4]
    ref, ours = _pair(setup, name)
    for _ in range(5):
        ref.submit(x)
        ours.submit(torch.from_numpy(x))
    jys, tys = ref.drain(), ours.drain()
    assert ours.stats == ref.stats, (name, ours.stats, ref.stats)
    assert ours.pool.states() == ref.pool.states()
    assert ours.pool_report() == ref.pool_report()
    assert len(tys) == len(jys) == 5
    for jy, ty in zip(jys, tys):
        assert isinstance(ty, torch.Tensor) and ty.device.type == "cpu"
        assert bool(torch.isfinite(ty).all())
        assert _scaled_err(ty.numpy(), jy) <= PARITY_TOL
    s = ours.stats
    plan = flt.canned_chaos_plans()[name]
    assert s["degraded"] == plan.count(kinds=("kernel", "nan"))
    assert s["killed"] == s["failovers"] == plan.count(kinds=("kill",))
    assert s["served"] + s["deadline_exceeded"] == s["accepted"] == 5
    assert s["quarantined"] == s["reinstated"]


def test_degraded_answer_is_the_staged_path(setup):
    """A kernel fault re-serves the request on the staged path: the answer
    equals the fallback server's own, and the degradation is counted."""
    x = torch.from_numpy(setup[4])
    _, ours = _pair(setup, "standard")
    y = ours(x)  # request 0: the kernel fault
    assert ours.stats["degraded"] == 1 and ours.stats["quarantined"] == 1
    torch.testing.assert_close(y, ours.fallback(x), rtol=0, atol=0)


def test_reload_from_a_reference_checkpoint(setup):
    """The reference writes the new params; the port's runtime reloads
    them through its own checkpointer and serves them."""
    jcfg, _, _, jparams2, x = setup
    with tempfile.TemporaryDirectory() as d:
        JCheckpointer(d).save(3, jparams2)
        _, ours = _pair(setup, checkpointer=Checkpointer(d))
        assert ours.reload() is True
        assert ours.stats["reloads"] == 1 and ours.stats["rollbacks"] == 0
        want = np.asarray(jfno.apply_fno(jparams2, jcfg, x, path="xla"))
        assert _scaled_err(ours(torch.from_numpy(x)).numpy(),
                           want) <= PARITY_TOL


def test_reload_rolls_back_on_corruption_like_reference(setup):
    _, _, _, jparams2, x = setup
    with tempfile.TemporaryDirectory() as dj, \
            tempfile.TemporaryDirectory() as dt:
        ref, ours = _pair(setup)
        ref.ckpt, ours.ckpt = JCheckpointer(dj), Checkpointer(dt)
        ref(x)
        before = ours(torch.from_numpy(x))
        ref.ckpt.save(1, jparams2)
        ours.ckpt.save(1, params_from_jax(_np_tree(jparams2)))
        assert jflt.corrupt_checkpoint(dj, 1) == flt.corrupt_checkpoint(dt, 1)
        assert ref.reload() is False and ours.reload() is False
        assert ours.stats == ref.stats
        assert ours.stats["rollbacks"] == 1 and ours.stats["reloads"] == 0
        after = ours(torch.from_numpy(x))  # the old params, bit for bit
        torch.testing.assert_close(after, before, rtol=0, atol=0)
        # a missing step rolls back too
        assert ours.reload(step=99) is False
        assert ours.stats["rollbacks"] == 2


def test_reload_without_checkpointer_raises(setup):
    _, ours = _pair(setup)
    with pytest.raises(RuntimeError, match="checkpointer"):
        ours.reload()


def test_admission_overflow_sheds_like_reference(setup):
    x = setup[4]
    ref, ours = _pair(setup, queue_limit=3)
    for i in range(5):
        if i < 3:
            ref.submit(x)
            ours.submit(torch.from_numpy(x))
        else:
            with pytest.raises(jsrt.RequestRejected):
                ref.submit(x)
            with pytest.raises(srt.RequestRejected):
                ours.submit(torch.from_numpy(x))
    assert len(ours.drain()) == len(ref.drain()) == 3
    assert ours.stats == ref.stats
    assert ours.stats["shed"] == 2 and ours.stats["served"] == 3


def test_deadline_exceeded_on_injected_delay(setup):
    x = torch.from_numpy(setup[4])
    _, ours = _pair(setup, deadline_s=0.05)
    ours.plan = flt.FaultPlan([flt.Fault("delay", at=0, delay_s=0.3)])
    with pytest.raises(srt.DeadlineExceeded):
        ours(x)
    assert ours.stats["deadline_exceeded"] == 1 and ours.stats["served"] == 0


def test_all_replicas_dead_raises_no_healthy(setup):
    x = torch.from_numpy(setup[4])
    _, ours = _pair(setup)
    ours.plan = flt.FaultPlan([flt.Fault("kill", at=0, replica=0),
                               flt.Fault("kill", at=0, replica=1)])
    with pytest.raises(srt.NoHealthyReplica):
        ours(x)
    assert ours.pool.states()["dead"] == 2 and ours.stats["killed"] == 2


def _failing_step(params, batch):
    raise RuntimeError("fused block kernel launch failed: injected")


def test_a_real_kernel_failure_is_raised_not_degraded(setup, monkeypatch):
    """The ladder takes only an injected ``KernelFault`` and a non-finite
    answer: any other error of the fused path (a kernel that fails to
    build or launch) leaves the server, degrades nothing and leaves the
    request pending; the canary raises it too."""
    x = torch.from_numpy(setup[4])
    _, ours = _pair(setup)
    monkeypatch.setattr(ours.primary, "step_fn", _failing_step)
    with pytest.raises(RuntimeError, match="launch failed"):
        ours(x)
    assert ours.stats["degraded"] == 0 and ours.stats["quarantined"] == 0
    assert ours.stats["served"] == 0 and len(ours._pending) == 1
    assert ours.pool.states()["healthy"] == 2
    with pytest.raises(RuntimeError, match="launch failed"):
        ours._canary_ok()


def test_backoff_delays_match_reference(setup, monkeypatch):
    """Seeded exponential backoff with jitter: the same delays, attempt
    by attempt, as the reference's for the same seed."""
    ref, ours = _pair(setup, seed=5, backoff_base_s=0.01)
    slept = []  # both modules sleep through the one `time` module
    monkeypatch.setattr(srt.time, "sleep", slept.append)
    attempts = (1, 2, 3, 1)
    for attempt in attempts:
        ref._backoff(attempt)
    for attempt in attempts:
        ours._backoff(attempt)
    n = len(attempts)
    assert slept[n:] == slept[:n] and len(set(slept)) == n


def test_replica_pool_state_machine():
    pool = srt.ReplicaPool(3)
    picked = [pool.pick().id for _ in range(4)]
    assert picked == [0, 1, 2, 0]  # round robin over the healthy set
    r0, r1 = pool.replicas[:2]
    pool.quarantine(r0)
    pool.mark_dead(r1)
    pool.quarantine(r1)  # a dead replica is not quarantined
    assert pool.states() == {"healthy": 1, "quarantined": 1, "dead": 1}
    pool.reinstate(r0)
    pool.reinstate(r1)  # dead is terminal
    assert pool.states() == {"healthy": 2, "quarantined": 0, "dead": 1}
    with pytest.raises(ValueError):
        srt.ReplicaPool(0)


# ---------------------------------------------------------------------------
# the fault harness
# ---------------------------------------------------------------------------
def test_fault_plan_take_fires_each_fault_once():
    plan = flt.FaultPlan([flt.Fault("kernel", at=3),
                          flt.Fault("nan", at=3)])
    assert [f.kind for f in plan.take("serve", 3, kind="kernel")] == \
        ["kernel"]
    assert plan.take("serve", 3, kind="kernel") == []  # fired = gone
    assert [f.kind for f in plan.pending()] == ["nan"]
    assert plan.take("train", 3, kind="nan") == []  # scope filter
    assert [f.kind for f in plan.take("serve", 3, kind="nan")] == ["nan"]
    assert plan.pending() == []


def test_fault_plan_replica_narrowing_and_count():
    plan = flt.FaultPlan([flt.Fault("kill", at=0, replica=1),
                          flt.Fault("kernel", at=0)])
    assert plan.take("serve", 0, kind="kill", replica=0) == []
    assert len(plan.take("serve", 0, kind="kernel", replica=0)) == 1
    assert len(plan.take("serve", 0, kind="kill", replica=1)) == 1
    assert plan.count(kinds=("kill",)) == 1  # planned, not remaining
    assert plan.count() == 2 and plan.count(scope="train") == 0


def test_fault_rejects_unknown_kind_and_scope():
    with pytest.raises(ValueError):
        flt.Fault("meteor", at=0)
    with pytest.raises(ValueError):
        flt.Fault("nan", at=0, scope="orbit")


def test_poison_helpers_copy_tensors():
    y = torch.ones((2, 3))
    p = flt.poison_output(y)
    assert torch.isnan(p.view(-1)[0]) and bool(torch.isfinite(y).all())
    assert bool(torch.isfinite(p.view(-1)[1:]).all())
    batch = {"x": torch.ones((2, 2)), "y": torch.zeros((2, 1))}
    q = flt.poison_batch(batch)
    assert torch.isnan(q["x"].view(-1)[0]) and q["y"] is batch["y"]
    assert bool(torch.isfinite(batch["x"]).all())


def test_corrupt_checkpoint_defeats_verify_in_both_packages():
    with tempfile.TemporaryDirectory() as d:
        Checkpointer(d).save(1, {"w": torch.arange(6.0)})
        assert JCheckpointer(d).verify(1) and Checkpointer(d).verify(1)
        assert flt.corrupt_checkpoint(d, 1) == "w"
        assert not JCheckpointer(d).verify(1)
        assert not Checkpointer(d).verify(1)
        with pytest.raises(IOError):
            Checkpointer(d).restore(1, {"w": torch.zeros(6)})
