"""Port parity: serving (``repro_torch.train.serve_fno_step``) against the
JAX reference's ``FNOServer``, the bucket ladder and padding, the CLI on
the CPU, the no-card contract of the entry points, and the package's
isolation from JAX and from the reference package.
"""
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


def test_default_device_raises_without_a_card():
    """Entry points serve on the GPU unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = tconfigs.get_config("fno2d", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsfs.FNOServer(cfg, {"blocks": []})
    args = tcli.build_parser().parse_args(["--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.run(args)


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
        "assert len(names) >= 12, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 12
