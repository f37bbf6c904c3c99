"""Port parity: the FNO model of ``repro_torch`` against the JAX reference.

Params are made by the reference's ``init_fno`` and carried into the port
with ``params_from_jax``, so both compute the same function; ``apply_fno``
on the fused-block path (the port's plain kernel version on the CPU) must
match the reference's fused-block pallas path (interpret mode) to the
relative 2e-4 f32 contract on reduced fno1d/2d/3d.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import PrecisionPolicy as JPolicy
from repro.configs.fno import with_precision as jwith_precision
from repro.core import fno as jfno
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.core import fno as tfno
from repro_torch.kernels import engine

ARCHS = ["fno1d", "fno2d", "fno3d"]


def _allclose_rel(a, b, tol):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _setup(arch, seed=0, batch=2):
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               fuse_block=True)
    jparams = jfno.init_fno(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, jcfg.in_channels)
                   + tuple(jcfg.spatial)).astype(np.float32)
    tcfg = tconfigs.with_fuse_block(tconfigs.get_config(arch, reduced=True))
    return jcfg, jparams, tcfg, tparams, x


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, reduced):
    ours = tconfigs.get_config(arch, reduced=reduced)
    theirs = jget_config(arch, reduced=reduced)
    for f in ("name", "ndim", "hidden", "num_layers", "in_channels",
              "out_channels", "spatial", "modes", "weight_mode",
              "lifting_dim", "fuse_block", "fuse_ends"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ours.param_count() == theirs.param_count()
    for preset in ("f32", "bf16"):
        a = tconfigs.with_precision(ours, preset).precision
        b = jwith_precision(theirs, preset).precision
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_fno_fused_block_matches_reference(arch):
    jcfg, jparams, tcfg, tparams, x = _setup(arch)
    theirs = jfno.apply_fno(jparams, jcfg, jnp.asarray(x), path="pallas")
    ours = tfno.apply_fno(tparams, dataclasses.replace(tcfg, path="fused"),
                          torch.from_numpy(x))
    assert tuple(ours.shape) == tuple(theirs.shape)
    _allclose_rel(_np(ours), theirs, 2e-4)


@pytest.mark.parametrize("path", ["ref", "staged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_fno_oracle_paths_match_reference(arch, path):
    jcfg, jparams, tcfg, tparams, x = _setup(arch, seed=1)
    theirs = jfno.apply_fno(jparams, jcfg, jnp.asarray(x), path="xla")
    ours = tfno.apply_fno(tparams, tcfg, torch.from_numpy(x), path=path)
    _allclose_rel(_np(ours), theirs, 2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_fno_bf16_each_side_within_tolerance(arch):
    jcfg, jparams, tcfg, tparams, x = _setup(arch, seed=2)
    ref32 = jfno.apply_fno(jparams, jcfg, jnp.asarray(x), path="xla")
    jb = jwith_precision(jcfg, "bf16")
    tb = dataclasses.replace(tconfigs.with_precision(tcfg, "bf16"),
                             path="fused")
    ours = tfno.apply_fno(tparams, tb, torch.from_numpy(x))
    theirs = jfno.apply_fno(jparams, jb, jnp.asarray(x), path="pallas")
    assert ours.dtype == torch.bfloat16
    assert jb.precision == JPolicy.from_name("bf16")
    _allclose_rel(_np(ours), ref32, 2e-2)
    _allclose_rel(np.asarray(theirs, np.float32), ref32, 2e-2)


def test_init_fno_layout_matches_reference():
    """The port's own init has the reference's tree layout, shapes and
    dtypes (values differ: torch and JAX draw different numbers)."""
    cfg = tconfigs.get_config("fno2d", reduced=True)
    ours = tfno.init_fno(torch.Generator().manual_seed(0), cfg)
    theirs = jfno.init_fno(jax.random.PRNGKey(0),
                           jget_config("fno2d", reduced=True))
    flat_o = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), ours))[0]
    flat_t = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_o, flat_t):
        assert a.shape == b.shape and a.dtype == np.float32
    again = tfno.init_fno(torch.Generator().manual_seed(0), cfg)
    torch.testing.assert_close(again["blocks"][1]["spectral"]["wr"],
                               ours["blocks"][1]["spectral"]["wr"])


def test_params_from_jax_widens_bf16_leaves():
    tree = {"a": [jnp.ones((2, 3), jnp.bfloat16) * 1.5],
            "b": jnp.arange(4, dtype=jnp.float32)}
    out = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    assert out["a"][0].dtype == torch.float32
    assert float(out["a"][0][1, 2]) == 1.5
    torch.testing.assert_close(out["b"], torch.arange(4.0))


def test_fused_path_needs_fuse_block(monkeypatch):
    """The fused path runs the whole-block kernel only with
    ``cfg.fuse_block``; without it each layer's spectral conv is the bare
    spectral-layer kernel and the bypass, bias and GELU are PyTorch ops.
    Both compute the same function."""
    cfg = dataclasses.replace(tconfigs.get_config("fno1d", reduced=True),
                              path="fused")
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 1, 64), generator=torch.Generator().manual_seed(1))
    calls = []
    block = engine.fused_block

    def spy(*a, **kw):
        calls.append("spectral" if a[3] is None else "block")
        return block(*a, **kw)
    monkeypatch.setattr(engine, "fused_block", spy)
    y = tfno.apply_fno(params, cfg, x)
    assert calls == ["spectral"] * cfg.num_layers
    calls.clear()
    y_block = tfno.apply_fno(params, tconfigs.with_fuse_block(cfg), x)
    assert calls == ["block"] * cfg.num_layers
    _allclose_rel(_np(y), _np(y_block), 2e-4)


def test_relative_l2_matches_reference():
    rng = np.random.default_rng(3)
    p = rng.normal(size=(3, 1, 8, 8)).astype(np.float32)
    t = rng.normal(size=(3, 1, 8, 8)).astype(np.float32)
    ours = tfno.relative_l2(torch.from_numpy(p).to(torch.bfloat16),
                            torch.from_numpy(t))
    theirs = jfno.relative_l2(jnp.asarray(p, jnp.bfloat16), jnp.asarray(t))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-5)
