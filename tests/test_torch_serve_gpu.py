"""The served forward and the K-step rollout as CUDA graphs on the card
(``repro_torch.train.serve_fno_step.FNOServer``): graphed against eager,
bit for bit; the launches a replay runs; returned outputs that the next
replay does not overwrite; params reloaded in place or recaptured; and
the server raising when the kernel fails to launch — the only fallback is
``ResilientServer``'s counted degradation. Every test needs an NVIDIA GPU
(marker ``gpu``) and skips without one; on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_gpu.py
"""
import dataclasses

import pytest
import torch

from repro_torch import configs, tree
from repro_torch.core import fno as tfno
from repro_torch.distributed import faults as flt
from repro_torch.kernels import engine
from repro_torch.train import serve_fno_step as sfs
from repro_torch.train import serve_runtime as srt

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, with TF32 off; skips without one (decided here, never at
    import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; run this file on the "
                    "card with `python -m pytest -m gpu`")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _cfg(arch="fno2d", preset="f32", ends=False):
    c = dataclasses.replace(configs.with_fuse_block(
        configs.get_config(arch, reduced=True)), path="fused")
    return configs.with_fuse_ends(configs.with_precision(c, preset), ends)


def _server(cuda, cfg, seed=0, variant="full", max_batch=4):
    params = tfno.init_fno(torch.Generator().manual_seed(seed), cfg, cuda)
    return sfs.FNOServer(cfg, params, device=cuda, variant=variant,
                         max_batch=max_batch)


def _x(cfg, n, seed, cuda):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n, cfg.in_channels) + tuple(cfg.spatial),
                       generator=gen).to(cuda)


@pytest.mark.parametrize("arch,preset,variant,ends", [
    ("fno1d", "f32", "full", False), ("fno2d", "f32", "full", False),
    ("fno2d", "bf16", "full", False), ("fno3d", "f32", "full", False),
    ("fno2d", "f32", "partial", False), ("fno2d", "f32", "full", True)])
@pytest.mark.parametrize("k", [1, 3])
def test_graph_matches_eager_bitwise(cuda, arch, preset, variant, ends, k):
    cfg = _cfg(arch, preset, ends)
    srv = _server(cuda, cfg, variant=variant)
    assert srv.graphed
    x = _x(cfg, 3, 1, cuda)  # bucket 4: one padded row
    y = srv(x, rollout_steps=k)
    assert torch.equal(y, srv.step_with(srv.params, x, k))
    assert torch.equal(srv(x, rollout_steps=k), y)  # a replay, not a capture
    assert len(srv._graphs) == 1


@pytest.mark.parametrize("k", [1, 4, 8])
def test_rollout_is_one_replay_of_layers_times_k_launches(cuda, k):
    cfg = _cfg()
    srv = _server(cuda, cfg)
    x = _x(cfg, 2, 2, cuda)
    srv(x, rollout_steps=k)  # warm-up and capture
    torch.cuda.synchronize()
    engine.LAUNCHES.clear()
    srv(x, rollout_steps=k)
    torch.cuda.synchronize()
    assert dict(engine.LAUNCHES) == {("block_fwd", "float32"):
                                     cfg.num_layers * k}


def test_first_request_counts_the_warm_up_not_the_capture(cuda):
    cfg = _cfg()
    srv = _server(cuda, cfg)
    engine.LAUNCHES.clear()
    srv(_x(cfg, 1, 3, cuda))  # eager warm-up + capture + one replay
    torch.cuda.synchronize()
    assert dict(engine.LAUNCHES) == {("block_fwd", "float32"):
                                     2 * cfg.num_layers}


def test_outputs_do_not_alias_the_graph(cuda):
    cfg = _cfg()
    srv = _server(cuda, cfg)
    x1, x2 = _x(cfg, 2, 4, cuda), _x(cfg, 2, 5, cuda)
    y1 = srv(x1)
    keep = y1.clone()
    y2 = srv(x2)
    torch.cuda.synchronize()
    assert torch.equal(y1, keep) and not torch.equal(y1, y2)
    # oversize requests: chunks of the top bucket through one graph
    big = torch.cat([x1, x2, x1], 0)  # 6 > top bucket 4: chunks 4 + 2
    torch.testing.assert_close(srv(big)[4:], srv(x1), rtol=0, atol=0)


def test_reload_in_place_keeps_the_graphs(cuda):
    cfg = _cfg()
    srv = _server(cuda, cfg)
    x = _x(cfg, 2, 6, cuda)
    y_old = srv(x)
    graphs = dict(srv._graphs)
    new = tfno.init_fno(torch.Generator().manual_seed(9), cfg, cuda)
    srv.params = new
    assert srv._graphs == graphs  # copied into the captured tensors
    y_new = srv(x)
    assert torch.equal(y_new, srv.step_with(new, x))
    assert not torch.equal(y_new, y_old)
    # the caller's tensors are copies, not the served ones
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(tree.leaves(srv.params), tree.leaves(new)))


def test_reload_of_another_layout_recaptures(cuda):
    cfg = _cfg()
    srv = _server(cuda, cfg)
    x = _x(cfg, 2, 7, cuda)
    srv(x)
    new = tfno.init_fno(torch.Generator().manual_seed(10), cfg, cuda)
    new["unused"] = torch.zeros(3, device=cuda)  # another tree
    srv.params = new
    assert srv._graphs == {}
    assert torch.equal(srv(x), srv.step_with(new, x))
    assert len(srv._graphs) == 1


def test_quantum_scales_the_buckets_on_the_card(cuda):
    cfg = _cfg()
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    srv = sfs.FNOServer(cfg, params, device=cuda, max_batch=8, quantum=4)
    assert srv.buckets == (4, 8)
    x = _x(cfg, 5, 8, cuda)
    assert torch.equal(srv(x), srv.step_with(srv.params, x, 1))


def test_staged_server_runs_eagerly(cuda):
    cfg = _cfg()
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    srv = sfs.FNOServer(cfg, params, device=cuda, path="staged")
    assert not srv.graphed
    srv(_x(cfg, 2, 9, cuda))
    assert srv._graphs == {}


def _failing_launch(*args, **kwargs):
    raise RuntimeError("fused block kernel launch failed: injected")


def test_server_raises_when_the_kernel_fails(cuda, monkeypatch):
    cfg = _cfg()
    srv = _server(cuda, cfg)
    monkeypatch.setattr(engine, "_launch", _failing_launch)
    with pytest.raises(RuntimeError, match="launch failed"):
        srv(_x(cfg, 2, 10, cuda))
    with pytest.raises(RuntimeError, match="launch failed"):
        srv.step_with(srv.params, _x(cfg, 2, 10, cuda))


def test_resilient_server_raises_a_real_kernel_failure(cuda, monkeypatch):
    """The degradation ladder takes only its own triggers (an injected
    ``KernelFault``, a non-finite answer): a kernel that fails to launch
    leaves ``ResilientServer`` as it leaves ``FNOServer``, with nothing
    degraded and the request still pending."""
    cfg = _cfg()
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    rs = srt.ResilientServer(cfg, params, device=cuda, replicas=2,
                             max_batch=4, fault_plan=flt.FaultPlan([]))
    x = _x(cfg, 2, 11, cuda)
    monkeypatch.setattr(engine, "_launch", _failing_launch)
    with pytest.raises(RuntimeError, match="launch failed"):
        rs(x)
    assert rs.stats["degraded"] == 0 and rs.stats["quarantined"] == 0
    assert rs.stats["served"] == 0 and len(rs._pending) == 1
    assert rs.pool.states()["healthy"] == 2


def test_only_the_resilient_server_degrades_and_counts_it(cuda):
    cfg = _cfg()
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    rs = srt.ResilientServer(
        cfg, params, device=cuda, replicas=2, max_batch=4,
        fault_plan=flt.FaultPlan([flt.Fault("kernel", at=0)]))
    x = _x(cfg, 2, 11, cuda)
    want = rs.fallback(x).cpu()
    y = rs(x)
    assert rs.stats["degraded"] == 1 and rs.stats["quarantined"] == 1
    assert torch.equal(y, want)
    assert rs.stats["reinstated"] == 1  # the canary passes: not a real fault


def test_two_resolutions_through_one_server(cuda):
    """A request at another resolution gets graphs of its own, each equal
    to the eager path at its resolution."""
    cfg = _cfg()
    srv = _server(cuda, cfg)
    side = cfg.spatial[0]
    gen = torch.Generator().manual_seed(12)
    xs = [torch.randn((3, cfg.in_channels, s, s), generator=gen).to(cuda)
          for s in (side, 2 * side)]
    for k in (1, 3):
        for x in xs:
            y = srv(x, rollout_steps=k)
            assert y.shape[2:] == x.shape[2:]
            assert torch.equal(y, srv.step_with(srv.params, x, k))
    assert len(srv._graphs) == 4
    # the first resolution's graph still answers as before
    assert torch.equal(srv(xs[0]), srv.step_with(srv.params, xs[0], 1))
