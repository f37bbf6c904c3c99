"""Port parity: the continuous-batching tier
(``repro_torch.train.serve_queue``) against the JAX reference's — the same
``poisson_schedule`` arrivals for a seed, and a replay of one schedule
through both tiers with equal ``QUEUE_STATS``, latency and depth summaries
and batch membership; the reference's properties (conservation, deadline
contract, FIFO within a bucket, routing) on the port; the replay gate on
the CPU; and the tier over the port's real server.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.train import serve_queue as jsq
from repro_torch import configs as tconfigs
from repro_torch.core import fno as tfno
from repro_torch.launch import serve_replay_smoke as smoke
from repro_torch.train import serve_fno_step as tsfs
from repro_torch.train import serve_queue as sq
from repro_torch.train.serve_runtime import RequestRejected

try:
    import hypothesis
    import hypothesis.strategies as st
    from hypothesis import given

    hypothesis.settings.register_profile(
        "torch_queue", deadline=None, max_examples=20,
        suppress_health_check=list(hypothesis.HealthCheck))
    _SETTINGS = hypothesis.settings.get_profile("torch_queue")
except ImportError:  # pragma: no cover - hypothesis-less images
    hypothesis = None


class FakeEngine:
    """Identity executor that records every dispatched batch."""

    def __init__(self, buckets=(2, 4, 8), fail=False):
        self.buckets = buckets
        self.calls = []
        self.fail = fail

    def __call__(self, x, rollout_steps=1):
        self.calls.append((int(x.shape[0]), int(rollout_steps)))
        if self.fail:
            raise RuntimeError("injected engine failure")
        return x


def _payload(a, i):
    return np.full((a.n, 1), float(i), np.float32)


def _model(bucket, steps):
    return 1e-3 * steps + 2e-4 * bucket


def test_queue_stats_are_the_references():
    assert sq.QUEUE_STATS == jsq.QUEUE_STATS and len(sq.QUEUE_STATS) == 8


@pytest.mark.parametrize("seed,choices", [(0, None), (3, None),
                                          (11, (1, 2, 4))])
def test_poisson_schedule_matches_reference(seed, choices):
    kw = dict(rate_hz=300.0, max_n=6, deadline_s=0.02,
              rollout_choices=choices)
    ours = sq.poisson_schedule(seed, 40, **kw)
    theirs = jsq.poisson_schedule(seed, 40, **kw)
    assert ([dataclasses.astuple(a) for a in ours]
            == [dataclasses.astuple(a) for a in theirs])


def _both(sched_kw, queue_limit, coalesce_s, buckets=(2, 4, 8)):
    out = []
    for mod in (sq, jsq):
        sched = mod.poisson_schedule(**sched_kw)
        eng = FakeEngine(buckets)
        cbs = mod.ContinuousBatchingServer(
            eng, buckets=buckets, queue_limit=queue_limit,
            coalesce_s=coalesce_s, clock=mod.VirtualClock(),
            service_model=_model)
        out.append((cbs, eng, cbs.replay(sched, _payload)))
    return out


@pytest.mark.parametrize("seed,rate,limit,coalesce,choices", [
    (0, 600.0, 6, 0.004, None),
    (1, 2000.0, 4, 0.002, (1, 2)),
    (2, 150.0, 16, 0.0, (1, 3)),
    (5, 900.0, 8, 0.01, None),
])
def test_replay_matches_reference(seed, rate, limit, coalesce, choices):
    """One schedule through both tiers: equal stats, latency and depth
    summaries, makespan, engine calls and batch membership."""
    kw = dict(seed=seed, requests=40, rate_hz=rate, max_n=5,
              rollout_steps=2, deadline_s=0.015, rollout_choices=choices)
    (ours, oeng, orep), (theirs, jeng, jrep) = _both(kw, limit, coalesce)
    assert orep == jrep
    assert oeng.calls == jeng.calls
    members = lambda cbs: sorted(
        (r.idx, r.status, r.t_dispatch, r.t_complete)
        for r in cbs.requests.values())
    assert members(ours) == members(theirs)
    assert ours.depth_trace == theirs.depth_trace
    for r in ours.requests.values():
        if r.status == "done":
            assert isinstance(r.y, torch.Tensor)
            np.testing.assert_array_equal(r.y.numpy(),
                                          theirs.requests[r.idx].y)


@pytest.fixture
def one_thread():
    """One intra-op thread for the model's small CPU products: with the
    suite's workers sharing the cores, a thread pool per worker makes
    these calls many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_replay_gate_counts_on_cpu(capsys, one_thread):
    """``launch/serve_replay_smoke.py`` on the reduced fno2d, plain
    versions: the reference gate's exact counts."""
    assert smoke.main(["--reduced", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "serve_replay_smoke: all gates passed" in out
    assert str(smoke.EXPECTED["coalesced"]) in out


def test_submit_sheds_at_queue_limit_without_enqueue():
    eng = FakeEngine()
    cbs = sq.ContinuousBatchingServer(eng, buckets=eng.buckets,
                                      queue_limit=2, clock=sq.VirtualClock())
    x = torch.zeros((1, 1))
    assert cbs.submit(x) == 0 and cbs.submit(x) == 1
    with pytest.raises(RequestRejected):
        cbs.submit(x)
    assert cbs.stats["shed"] == 1 and cbs.stats["offered"] == 3
    assert cbs.queue_depth() == 2
    assert len(cbs.drain()) == 2 and cbs.stats["completed"] == 2


def test_mixed_rollout_depths_never_share_a_batch():
    eng = FakeEngine()
    cbs = sq.ContinuousBatchingServer(eng, buckets=eng.buckets,
                                      queue_limit=8, clock=sq.VirtualClock())
    x = torch.zeros((1, 1))
    for steps in (1, 1, 2, 2, 1):
        cbs.submit(x, rollout_steps=steps)
    cbs.drain()
    assert eng.calls == [(2, 1), (2, 2), (1, 1)]
    assert cbs.stats["batches"] == 3 and cbs.stats["coalesced"] == 2


def test_engine_failure_marks_batch_failed_not_lost():
    eng = FakeEngine(fail=True)
    cbs = sq.ContinuousBatchingServer(eng, buckets=eng.buckets,
                                      queue_limit=4, clock=sq.VirtualClock())
    i0 = cbs.submit(torch.zeros((1, 1)))
    cbs.submit(torch.zeros((1, 1)))
    assert {r.status for r in cbs.drain()} == {"failed"}
    assert cbs.stats["failed"] == 2 and cbs.stats["completed"] == 0
    assert "injected engine failure" in cbs.result(i0).error
    s = cbs.stats
    assert s["accepted"] == s["completed"] + s["deadline_exceeded"] + \
        s["failed"]


def test_replay_requires_virtual_clock_and_model():
    eng = FakeEngine()
    with pytest.raises(ValueError, match="VirtualClock"):
        sq.ContinuousBatchingServer(eng, buckets=eng.buckets).replay(
            [sq.Arrival(0.0, 1)], _payload)
    with pytest.raises(ValueError, match="service_model"):
        sq.ContinuousBatchingServer(
            eng, buckets=eng.buckets, clock=sq.VirtualClock()).replay(
            [sq.Arrival(0.0, 1)], _payload)
    with pytest.raises(ValueError, match="buckets"):
        sq.ContinuousBatchingServer(object())


def test_summaries_of_an_empty_tier():
    cbs = sq.ContinuousBatchingServer(FakeEngine(), buckets=(1,))
    assert cbs.latency_summary()["count"] == 0
    assert cbs.depth_summary()["samples"] == 0
    assert cbs.report()["served_samples"] == 0


def _check_properties(raw):
    t, sched = 0.0, []
    for gap, n, steps, dl in raw:
        t += gap
        sched.append(sq.Arrival(t, n, steps, dl))
    eng = FakeEngine()
    cbs = sq.ContinuousBatchingServer(
        eng, buckets=eng.buckets, queue_limit=4, coalesce_s=0.004,
        clock=sq.VirtualClock(), service_model=_model)
    s = cbs.replay(sched, _payload)["stats"]
    # conservation
    assert s["offered"] == len(raw) == s["accepted"] + s["shed"]
    assert s["accepted"] == (s["completed"] + s["deadline_exceeded"]
                             + s["failed"])
    assert cbs.queue_depth() == 0
    batches = {}
    for r in cbs.requests.values():
        if r.status == "done":
            # the deadline contract: served means on time
            assert r.t_complete >= r.t_dispatch >= r.t_enqueue
            if r.deadline_t is not None:
                assert r.t_complete <= r.deadline_t + 1e-12
            # routing: each request got back exactly its own samples
            assert r.y.shape[0] == r.n
            assert bool((r.y == r.y.view(-1)[0]).all())
            batches.setdefault(r.t_dispatch, []).append(r)
        elif r.status == "deadline":
            assert r.y is None and "deadline" in r.error
    for members in batches.values():
        assert len({m.rollout_steps for m in members}) == 1
        assert sum(m.n for m in members) <= 8 or len(members) == 1
        assert [m.idx for m in members] == sorted(m.idx for m in members)


if hypothesis is not None:
    @_SETTINGS
    @given(raw=st.lists(
        st.tuples(st.floats(1e-4, 0.02), st.integers(1, 5),
                  st.sampled_from([1, 2]),
                  st.sampled_from([None, 0.01, 0.05])),
        min_size=1, max_size=30))
    def test_queue_properties(raw):
        _check_properties(raw)
else:  # pragma: no cover
    @pytest.mark.parametrize("seed", range(10))
    def test_queue_properties(seed):
        rng = np.random.default_rng(seed)
        _check_properties([(float(rng.uniform(1e-4, 0.02)),
                            int(rng.integers(1, 6)),
                            int(rng.choice([1, 2])),
                            [None, 0.01, 0.05][int(rng.integers(3))])
                           for _ in range(int(rng.integers(1, 31)))])


def test_tier_over_the_port_server_matches_direct_calls(one_thread):
    cfg = dataclasses.replace(
        tconfigs.with_fuse_block(tconfigs.get_config("fno2d", reduced=True)),
        path="fused")
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg)
    server = tsfs.FNOServer(cfg, params, device="cpu", max_batch=2)
    cbs = sq.ContinuousBatchingServer(server, queue_limit=4)
    assert cbs.buckets == server.buckets
    gen = torch.Generator().manual_seed(1)
    xs = [torch.randn((1 + i % 2, cfg.in_channels) + tuple(cfg.spatial),
                      generator=gen) for i in range(3)]
    idxs = [cbs.submit(x, rollout_steps=2) for x in xs]
    cbs.drain()
    for x, i in zip(xs, idxs):
        got = cbs.result(i).y
        torch.testing.assert_close(got, server(x, rollout_steps=2),
                                   rtol=0, atol=1e-6)
        assert bool(torch.isfinite(got).all())
