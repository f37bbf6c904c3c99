"""Port parity: serving (``repro_torch.train.serve_fno_step``) against the
JAX reference's ``FNOServer``, the bucket ladder and padding, the serving
quantum, ``step_with``, the params setter, the CLI on the CPU (its
``--replay`` and ``--chaos`` modes and its fusion-contract check), the
no-card contract of the entry points, and the package's isolation from
JAX and from the reference package.
"""
import collections
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import fno as jfno
from repro.train import serve_fno_step as jsfs
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import engine
from repro_torch.launch import serve_fno as tcli
from repro_torch.train import serve_fno_step as tsfs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _allclose_rel(a, b, tol):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


@pytest.fixture(scope="module")
def servers():
    """The reference's production server (fused-block pallas) and the
    port's fused server on the CPU, with the same params."""
    jcfg = dataclasses.replace(jget_config("fno2d", reduced=True),
                               path="pallas", fuse_block=True)
    jparams = jfno.init_fno(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    tcfg = dataclasses.replace(
        tconfigs.with_fuse_block(tconfigs.get_config("fno2d", reduced=True)),
        path="fused")
    jsrv = jsfs.FNOServer(jcfg, jparams, max_batch=4)
    tsrv = tsfs.FNOServer(tcfg, tparams, device="cpu", max_batch=4)
    return jsrv, tsrv


def _request(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 3, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 3])
def test_server_matches_reference(servers, n):
    jsrv, tsrv = servers
    x = _request(n, n)
    theirs = jsrv(jnp.asarray(x))
    ours = tsrv(torch.from_numpy(x))
    assert tuple(ours.shape) == tuple(theirs.shape) == (n, 1, 32, 32)
    _allclose_rel(_np(ours), theirs, 2e-4)


def test_rollout_k3_matches_reference(servers):
    jsrv, tsrv = servers
    x = _request(2, 7)
    theirs = jsrv(jnp.asarray(x), rollout_steps=3)
    ours = tsrv(torch.from_numpy(x), rollout_steps=3)
    _allclose_rel(_np(ours), theirs, 2e-4)
    # depth changes the answer (the feedback really happens)
    one = tsrv(torch.from_numpy(x))
    assert float((ours - one).abs().max()) > 1e-6


def test_oversize_chunks_and_stats(servers):
    _, tsrv = servers
    before = dict(tsrv.stats)
    x = torch.from_numpy(_request(6, 11))  # top bucket 4 -> chunks 4 + 2
    y = tsrv(x)
    assert tuple(y.shape) == (6, 1, 32, 32)
    torch.testing.assert_close(y[4:], tsrv(x[4:]), rtol=0, atol=0)
    assert tsrv.stats["requests"] - before["requests"] == 2
    assert tsrv.stats["samples"] - before["samples"] == 8
    assert tsrv.stats["padded"] == before["padded"]  # 4 and 2 are buckets
    empty = tsrv(torch.zeros((0, 3, 32, 32)))
    assert tuple(empty.shape) == (0, 1, 32, 32)
    with pytest.raises(ValueError):
        tsrv(x, rollout_steps=0)


@pytest.mark.parametrize("max_batch,quantum", [(8, 1), (64, 1), (5, 2),
                                               (1, 1), (12, 4)])
def test_bucket_ladder_matches_reference(max_batch, quantum):
    ours = tsfs.bucket_sizes(max_batch, quantum=quantum)
    assert ours == jsfs.bucket_sizes(max_batch, quantum=quantum)
    for n in range(1, 2 * max_batch + 2):
        assert tsfs.pick_bucket(n, ours) == jsfs.pick_bucket(n, ours)


def test_pad_to_bucket_matches_reference():
    x = _request(3, 5)
    ours, m = tsfs.pad_to_bucket(torch.from_numpy(x), 8)
    theirs, jm = jsfs.pad_to_bucket(jnp.asarray(x), 8)
    assert m == jm == 3
    np.testing.assert_array_equal(_np(ours), np.asarray(theirs))
    same, m = tsfs.pad_to_bucket(torch.from_numpy(x), 3)
    assert m == 3 and same.shape[0] == 3


def test_server_quantum_is_the_kernel_batch_block():
    cfg = tconfigs.get_config("fno1d", reduced=True)
    params = {"blocks": []}
    srv = tsfs.FNOServer(cfg, params, device="cpu", max_batch=8)
    assert srv.buckets == (1, 2, 4, 8) and engine.BATCH_BLOCK == 1


@pytest.mark.parametrize("quantum", [None, 1, 2, 8])
def test_quantum_is_validated_against_the_batch_block(quantum):
    cfg = tconfigs.get_config("fno1d", reduced=True)
    srv = tsfs.FNOServer(cfg, {"blocks": []}, device="cpu", max_batch=8,
                         quantum=quantum)
    q = quantum or engine.BATCH_BLOCK
    assert tsfs.serve_quantum(quantum) == q
    assert srv.buckets == tsfs.bucket_sizes(8, quantum=q)
    assert all(b % engine.BATCH_BLOCK == 0 for b in srv.buckets)


@pytest.mark.parametrize("bad", [0, -1, 2.5, True, "4"])
def test_quantum_rejects_what_is_not_a_multiple(bad):
    cfg = tconfigs.get_config("fno1d", reduced=True)
    with pytest.raises(ValueError, match="batch block"):
        tsfs.FNOServer(cfg, {"blocks": []}, device="cpu", quantum=bad)


def test_step_with_matches_reference(servers):
    """The canary hook: one bucketed step with explicit params, against
    the reference's ``step_with`` on other params than the served ones."""
    jsrv, tsrv = servers
    jparams2 = jfno.init_fno(jax.random.PRNGKey(5), jsrv.cfg)
    tparams2 = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams2))
    x = _request(3, 4)
    ours = tsrv.step_with(tparams2, torch.from_numpy(x))
    theirs = jsrv.step_with(jparams2, jnp.asarray(x))
    _allclose_rel(_np(ours), theirs, 2e-4)
    # the served params are untouched by the probe
    _allclose_rel(_np(tsrv(torch.from_numpy(x))), jsrv(jnp.asarray(x)), 2e-4)


def test_step_with_rollout_matches_the_server_and_reference(servers):
    """``step_with``'s K-step case: the eager rollout the server pads and
    runs, against the server's own rollout and the reference's."""
    jsrv, tsrv = servers
    x = _request(3, 9)
    ours = tsrv.step_with(tsrv.params, torch.from_numpy(x), 3)
    torch.testing.assert_close(ours, tsrv(torch.from_numpy(x),
                                          rollout_steps=3), rtol=0, atol=0)
    _allclose_rel(_np(ours), jsrv(jnp.asarray(x), rollout_steps=3), 2e-4)


@pytest.mark.parametrize("side", [24, 48])
def test_server_at_another_resolution_matches_reference(servers, side):
    """A request at another resolution than the config's: the reference
    retraces for it, the port serves it as it serves the config's."""
    jsrv, tsrv = servers
    rng = np.random.default_rng(side)
    x = rng.normal(size=(3, 3, side, side)).astype(np.float32)
    ours = tsrv(torch.from_numpy(x))
    theirs = jsrv(jnp.asarray(x))
    assert tuple(ours.shape) == tuple(theirs.shape) == (3, 1, side, side)
    _allclose_rel(_np(ours), theirs, 2e-4)


def test_params_setter_serves_new_params_and_copies():
    cfg = dataclasses.replace(
        tconfigs.with_fuse_block(tconfigs.get_config("fno2d", reduced=True)),
        path="fused")
    from repro_torch.core import fno as tfno
    p1 = tfno.init_fno(torch.Generator().manual_seed(0), cfg)
    p2 = tfno.init_fno(torch.Generator().manual_seed(1), cfg)
    srv = tsfs.FNOServer(cfg, p1, device="cpu", max_batch=2)
    x = torch.from_numpy(_request(2, 3))
    y1 = srv(x)
    srv.params = p2
    torch.testing.assert_close(srv(x), srv.step_with(p2, x), rtol=0, atol=0)
    assert float((srv(x) - y1).abs().max()) > 1e-6
    srv.params = p1
    torch.testing.assert_close(srv(x), y1, rtol=0, atol=0)


class _CountingServer:
    """A stand-in for a graphed server whose replays count `per_step`
    block_fwd launches a layer and step."""

    graphed = True

    def __init__(self, cfg, per_step):
        self.cfg, self.per_step = cfg, per_step
        self.buckets, self.device = (1, 2), torch.device("cpu")

    def __call__(self, x, rollout_steps=1):
        engine.LAUNCHES[("block_fwd", "float32")] += (
            self.per_step * self.cfg.num_layers * rollout_steps)
        return torch.zeros((x.shape[0], self.cfg.out_channels)
                           + tuple(self.cfg.spatial))


@pytest.mark.parametrize("k", [1, 4])
def test_fusion_contract_holds_launches_a_layer_and_step(k):
    cfg = dataclasses.replace(
        tconfigs.with_fuse_block(tconfigs.get_config("fno2d", reduced=True)),
        path="fused")
    saved = collections.Counter(engine.LAUNCHES)
    try:
        got = tcli.fusion_contract(_CountingServer(cfg, 1), "full", k)
        assert got == {b: {"block_fwd": 1} for b in (1, 2)}
        with pytest.raises(AssertionError, match="fusion contract"):
            tcli.fusion_contract(_CountingServer(cfg, 2), "full", k)
        # the partial variant reports its launches, it is not held
        got = tcli.fusion_contract(_CountingServer(cfg, 2), "partial", k)
        assert got[1] == {"block_fwd": 2}
    finally:
        engine.LAUNCHES.clear()
        engine.LAUNCHES.update(saved)


def test_cli_replay_and_chaos_on_cpu(capsys):
    base = ["--reduced", "--device", "cpu", "--max-batch", "4"]
    rep = tcli.run(tcli.build_parser().parse_args(
        base + ["--replay", "--requests", "10", "--rate", "500"]))
    s = rep["stats"]
    assert s["offered"] == 10 and s["accepted"] + s["shed"] == 10
    assert s["accepted"] == (s["completed"] + s["deadline_exceeded"]
                             + s["failed"])
    assert rep["device"] == "cpu" and set(rep["service_model_s"]) == {1, 2, 4}
    chaos = tcli.run(tcli.build_parser().parse_args(
        base + ["--chaos", "--requests", "5"]))
    assert chaos["degraded"] == 2 and chaos["killed"] == 1
    assert chaos["rollbacks"] == 1 and chaos["reloads"] == 1
    assert chaos["served"] == chaos["accepted"] == 5 + 3
    out = capsys.readouterr().out
    assert "latency: p50=" in out and "corrupt reload rolled back" in out
    assert f"completed={s['completed']} degraded=0" in out


def test_default_device_raises_without_a_card():
    """Entry points serve on the GPU unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = tconfigs.get_config("fno2d", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsfs.FNOServer(cfg, {"blocks": []})
    for mode in ([], ["--replay"], ["--chaos"]):
        args = tcli.build_parser().parse_args(
            ["--reduced", "--requests", "1"] + mode)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.run(args)
    from repro_torch.launch import chaos_smoke, serve_replay_smoke
    from repro_torch.train import serve_runtime
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_runtime.ResilientServer(cfg, {"blocks": []})
    with pytest.raises(RuntimeError, match="--device cpu"):
        chaos_smoke.main(["--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_replay_smoke.main(["--reduced"])


def test_cli_serves_on_cpu(capsys):
    args = tcli.build_parser().parse_args(
        ["--arch", "fno1d", "--reduced", "--device", "cpu", "--requests",
         "3", "--max-batch", "4", "--rollout-steps", "2"])
    out = tcli.run(args)
    assert out["device"] == "cpu" and out["requests"] == 3
    assert out["buckets"] == [1, 2, 4] and out["samples_per_s"] > 0
    assert "all outputs finite" in capsys.readouterr().out


def test_package_imports_neither_jax_nor_reference():
    """Every repro_torch module imports without jax and without repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "new = {'repro_torch.checkpoint', 'repro_torch.checkpoint."
        "checkpointer', 'repro_torch.data.pipeline', "
        "'repro_torch.distributed.faults', "
        "'repro_torch.distributed.fault_tolerance', "
        "'repro_torch.train.serve_runtime', 'repro_torch.train.serve_queue',"
        " 'repro_torch.train.trainer', 'repro_torch.launch.chaos_smoke', "
        "'repro_torch.launch.serve_replay_smoke'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "assert len(names) >= 22, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 22
