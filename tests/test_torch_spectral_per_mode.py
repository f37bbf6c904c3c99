"""Port parity: the spectral-only models (``fuse_block`` off: the paper's
design, each spectral conv one fused launch) with per-mode weights
[O,H,k_1..k_R], against the JAX reference.

Reduced fno1d, fno2d and fno3d with ``weight_mode="per_mode"``, batch 2,
in both variants (rank 1 has only the full one): ``fno_loss`` at step 0
and every leaf's grad of the port's fused path against
``jax.value_and_grad`` of the reference's pallas loss (its kernels in
interpret mode) at the same precision preset: f32 within 2e-4, bf16 within
5e-2, each leaf of its own magnitude (DESIGN.md §4). Against the f32
reference the bf16 grads of fno3d's last bias (``proj2.b``, a sum over
every point that nearly cancels) miss 5e-2 at this seed (the port 6.0e-2
full, 6.4e-2 partial; the reference's own bf16 3.5e-2, 3.6e-2), so bf16 is
held against the reference's bf16. On the CPU the port's wrappers run
their kernels' plain versions.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.fno import with_precision as jwith_precision
from repro.core import fno as jfno
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.train.train_step import make_loss_fn, value_and_grad

F32_TOL, BF16_TOL = 2e-4, 5e-2
_MODELS = [("fno1d", "full"), ("fno2d", "full"), ("fno2d", "partial"),
           ("fno3d", "full"), ("fno3d", "partial")]


@functools.lru_cache(maxsize=None)
def _reference(arch, variant, dtype):
    """(params as numpy, batch, loss, grad leaves) of the reference's
    reduced per-mode spectral-only model at a precision preset."""
    jcfg = jwith_precision(dataclasses.replace(
        jget_config(arch, reduced=True), fuse_block=False,
        weight_mode="per_mode"), dtype)
    jparams = jfno.init_fno(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(5)
    sp = tuple(jcfg.spatial)
    b = {"x": rng.normal(size=(2, jcfg.in_channels) + sp).astype(np.float32),
         "y": rng.normal(size=(2, jcfg.out_channels) + sp).astype(np.float32)}
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    jl, jg = jax.value_and_grad(lambda p: jfno.fno_loss(
        p, jcfg, jb, path="pallas", variant=variant))(jparams)
    return (jax.tree_util.tree_map(np.asarray, jparams), b, float(jl),
            [np.asarray(g, np.float32)
             for g in jax.tree_util.tree_leaves(jg)])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,variant", _MODELS,
                         ids=[f"{a}-{v}" for a, v in _MODELS])
def test_per_mode_spectral_only_loss_and_grads_match_reference(
        arch, variant, dtype):
    jparams, b, jl, jg = _reference(arch, variant, dtype)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, reduced=True),
                               path="fused", fuse_block=False,
                               weight_mode="per_mode")
    tcfg = tconfigs.with_precision(tcfg, dtype)
    tparams = params_from_jax(jparams)
    tl, tg = value_and_grad(
        make_loss_fn(tcfg, fno_path="fused", fno_variant=variant), tparams,
        tree.map(torch.from_numpy, b))
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    assert abs(float(tl) - jl) <= tol * abs(jl)
    ours = tree.leaves(tg)
    assert len(ours) == len(jg)
    for a, r in zip(ours, jg):
        a = a.detach().float().numpy()
        assert a.shape == r.shape
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(a - r).max()) <= tol * scale
