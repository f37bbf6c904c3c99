"""Port parity, per-mode spectral weights: ``repro_torch`` with weights
[O,H,k_1..k_R] (the classic FNO layout, and fno2d-large's) against the JAX
reference's per-mode path (``path="pallas"``, its Pallas kernels in
interpret mode, as its own tests run them):

* the fused block forward, full and partial variant, ranks 1–3 at the odd
  extents, f32 and bf16;
* every grad (dx, dwr, dwi, dwb, dbias) against ``jax.grad``, each leaf
  against its own magnitude, full variant at ranks 1–3 in f32 and bf16 and
  the partial variant at ranks 2–3;
* the plain versions of the three per-mode kernel modes against the
  reference's engine calls with per-mode weights: the block kernel's
  forward, gz-recompute and dx-adjoint modes, the wgrad kernel (dW in the
  parameter layout) and the partial-fusion core;
* a reduced per-mode model (``reduced_2d`` with ``weight_mode="per_mode"``):
  ``apply_fno``, the step-0 loss and every leaf's grad, one AdamW step, and
  ``FNOServer`` requests with a rollout, both variants;
* the fno2d-large config, its launch plans at full width, the parameter
  conversion, and the chip smoke's bounds for per-mode weights.

Tolerances (DESIGN.md §4): f32 within 2e-4 of the reference, bf16 forward
within 2e-2 and bf16 grads within 5e-2 of the f32 reference. On the CPU the
wrappers run their kernels' plain versions; the CUDA kernels are held
against those on the card (tests/test_torch_kernel_gpu.py,
chip_smoke.py) and under emulation (tests/test_torch_kernel_emulated.py).
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import PrecisionPolicy as JPolicy
from repro.core import fno as jfno
from repro.core import spectral as jspec
from repro.kernels import engine as jengine
from repro.kernels import ops as jops
from repro.optim import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.train import serve_fno_step as jsfs
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.configs import fno as tfno_configs
from repro_torch.configs.base import PrecisionPolicy
from repro_torch.convert import params_from_jax
from repro_torch.core import fno as tfno
from repro_torch.core import spectral as tspec
from repro_torch.kernels import engine
from repro_torch.kernels import ops as tops
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train import serve_fno_step as tsfs
from repro_torch.train.train_step import (make_loss_fn, make_train_step,
                                          value_and_grad)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CASES = {
    1: ((64,), (17,)),
    2: ((16, 32), (5, 9)),
    3: ((8, 8, 16), (3, 3, 5)),
}
_NAMES = ("dx", "dwr", "dwi", "dwb", "dbias")
F32_TOL, BF16_TOL, BF16_GRAD_TOL = 2e-4, 2e-2, 5e-2
SMEM_LIMIT = 232448


def _allclose_rel(a, b, tol, name=""):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol,
                               err_msg=name)


def _leaf_close(a, b, tol, name=""):
    """Max |a - b| within tol of the leaf's own magnitude."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=tol,
                               err_msg=name)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _pm_args(rank, seed, b=2, h=8, o=6):
    """x, per-mode wr/wi [O,H,k_1..k_R], wb, bias (numpy f32)."""
    spatial, modes = _CASES[rank]
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: (sc * rng.normal(size=s)).astype(np.float32)
    args = (mk(b, h, *spatial), mk(o, h, *modes, sc=1.0 / h),
            mk(o, h, *modes, sc=1.0 / h), mk(o, h, sc=1.0 / h),
            mk(o, sc=0.3))
    return args, modes


@pytest.mark.parametrize("variant", ["full", "partial"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_per_mode_block_matches_reference(rank, variant):
    args, modes = _pm_args(rank, 10 + rank)
    theirs = jops.fno_block_nd(*(jnp.asarray(a) for a in args), modes,
                               path="pallas", variant=variant)
    ours = tops.fno_block_nd(*(torch.from_numpy(a) for a in args), modes,
                             path="fused", variant=variant)
    assert ours.dtype == torch.float32
    assert tuple(ours.shape) == tuple(theirs.shape)
    _allclose_rel(_np(ours), theirs, F32_TOL)
    ours16 = tops.fno_block_nd(*(torch.from_numpy(a) for a in args), modes,
                               path="fused", variant=variant,
                               policy=PrecisionPolicy.from_name("bf16"))
    assert ours16.dtype == torch.bfloat16
    _allclose_rel(_np(ours16), theirs, BF16_TOL)


def _jax_grads(args, modes, policy=None, variant="full"):
    fn = lambda *a: jnp.sum(jnp.sin(jops.fno_block_nd(
        *a, modes, path="pallas", variant=variant,
        policy=policy).astype(jnp.float32)))
    return jax.grad(fn, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))


def _torch_grads(args, modes, policy=None, variant="full"):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = tops.fno_block_nd(*leaves, modes, path="fused", variant=variant,
                          policy=policy)
    return torch.autograd.grad(torch.sin(y.float()).sum(), leaves)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_per_mode_grads_match_reference(rank):
    """f32: every grad within 2e-4 of the leaf's own magnitude; bf16 (f32
    master weights, bf16 compute copy): every grad comes back in f32 within
    5e-2 of the f32 reference, the per-mode dW included, whose reduction
    over the batch runs in f32."""
    args, modes = _pm_args(rank, 20 + rank)
    theirs = _jax_grads(args, modes)
    ours = _torch_grads(args, modes)
    for name, a, b in zip(_NAMES, ours, theirs):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        _leaf_close(_np(a), b, F32_TOL, name)
    ours16 = _torch_grads(args, modes, PrecisionPolicy.from_name("bf16"))
    for name, a, b in zip(_NAMES, ours16, theirs):
        assert a.dtype == torch.float32, name
        _leaf_close(_np(a), b, BF16_GRAD_TOL, name)


@pytest.mark.parametrize("rank", [2, 3])
def test_per_mode_partial_grads_match_reference(rank):
    args, modes = _pm_args(rank, 30 + rank)
    theirs = _jax_grads(args, modes, variant="partial")
    ours = _torch_grads(args, modes, variant="partial")
    for name, a, b in zip(_NAMES, ours, theirs):
        _leaf_close(_np(a), b, F32_TOL, name)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_per_mode_plain_versions_match_reference_engine(rank):
    """The block kernel's forward, gz-recompute and dx-adjoint modes (the
    swapped weights as the transposed view the backward passes) and the
    per-mode wgrad, plain versions against the reference's kernel launches
    with per-mode weights (interpret mode)."""
    (x, wr, wi, wb, bias), modes = _pm_args(rank, 40 + rank)
    spatial = x.shape[2:]
    gy = np.random.default_rng(rank).normal(
        size=(2, 6) + spatial).astype(np.float32)
    pol = JPolicy()
    j = lambda a: jnp.asarray(a)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    sw = lambda a: t(a).transpose(0, 1)
    mats = {k: tspec.operand_tensors(spatial, modes, "float32", "cpu", k)
            for k in ("forward", "adjoint", "wgrad")}
    fwd = (t(x), t(wr), t(wi), t(wb), t(bias).reshape(-1, 1),
           mats["forward"])

    y = engine.fused_block(*fwd)
    jy = jops._fnond_fused(j(x), j(wr), j(wi), modes, 2, 8, 8, True, pol,
                           wb=j(wb), bias=j(bias), act="gelu")
    _allclose_rel(_np(y), jy, F32_TOL, "y")

    gz = engine.fused_block(*fwd, act="gelu_vjp", gy=t(gy))
    jgz = jops._fnond_fused(j(x), j(wr), j(wi), modes, 2, 8, 8, True, pol,
                            wb=j(wb), bias=j(bias), gy=j(gy),
                            act="gelu_vjp")
    _allclose_rel(_np(gz), jgz, F32_TOL, "gz")

    dx = engine.fused_block(gz, sw(wr), sw(wi), t(wb.T), None,
                            mats["adjoint"], act="linear")
    jdx = jops._fnond_fused(jgz, jnp.swapaxes(j(wr), 0, 1),
                            jnp.swapaxes(j(wi), 0, 1), modes, 2, 8, 8, True,
                            pol, adjoint=True, wb=j(wb.T))
    _allclose_rel(_np(dx), jdx, F32_TOL, "dx")

    ours = engine.fused_wgrad(t(x), gz, mats["wgrad"], per_mode=True)
    theirs = jops._fnond_wgrad(j(x), jgz, modes, 2, 8, 8, True, True, pol,
                               with_bypass=True)
    assert tuple(ours[0].shape) == (6, 8) + modes
    for name, a, b in zip(_NAMES[1:], ours, theirs):
        _leaf_close(_np(a).reshape(np.shape(b)), b, F32_TOL, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [2, 3])
def test_per_mode_core_plain_matches_reference_core_call(rank, dtype):
    """The core with per-mode weights against the reference's
    ``fused_fnond_core_call``, whose per-mode output [K_R..K_2,B,O,s_1] is
    moved to the port's [B,K_R..K_2,O,s_1]."""
    spatial, modes = _CASES[rank]
    b, h, o = 2, 8, 6
    spec = tuple(modes[rank - 1:0:-1])
    rng = np.random.default_rng(50 + rank)
    mk = lambda *s, sc=1.0: (sc * rng.normal(size=s)).astype(np.float32)
    zr, zi = mk(b, h, spatial[0], *spec), mk(b, h, spatial[0], *spec)
    wr, wi = mk(o, h, *modes, sc=1.0 / h), mk(o, h, *modes, sc=1.0 / h)
    ops = jspec.fused_operand_mats(spatial, modes)[2 * rank - 2:2 * rank + 2]
    s = rank - 1  # [K_R..K_2,B,O,s_1] -> [B,K_R..K_2,O,s_1]
    to_port = lambda a: np.moveaxis(np.asarray(a, np.float32), s, 0)
    ref32 = [to_port(a) for a in jengine.fused_fnond_core_call(
        *(jnp.asarray(a) for a in (zr, zi, wr, wi, *ops)), bb=1, bo=o, bh=h,
        interpret=True)]
    tdt = getattr(torch, dtype)
    tmats = tspec.operand_tensors(spatial, modes, dtype, "cpu")
    ours = engine.fused_core(
        *(torch.from_numpy(a).to(tdt) for a in (zr, zi, wr, wi)),
        *tmats[2 * rank - 2:2 * rank + 2])
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for a, r in zip(ours, ref32):
        assert a.dtype == tdt and tuple(a.shape) == r.shape
        _allclose_rel(_np(a), r, tol)


def _setup(seed=0, batch=2):
    """The reduced per-mode model on both sides, the same params."""
    jcfg = dataclasses.replace(jget_config("fno2d-large", reduced=True),
                               weight_mode="per_mode", fuse_block=True)
    jparams = jfno.init_fno(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    tcfg = dataclasses.replace(
        tconfigs.with_fuse_block(tfno_configs.reduced_2d()),
        weight_mode="per_mode", path="fused")
    rng = np.random.default_rng(seed)
    b = {"x": rng.normal(size=(batch, 3, 32, 32)).astype(np.float32),
         "y": rng.normal(size=(batch, 1, 32, 32)).astype(np.float32)}
    return jcfg, jparams, tcfg, tparams, b


@pytest.mark.parametrize("variant", ["full", "partial"])
def test_apply_fno_per_mode_matches_reference(variant):
    jcfg, jparams, tcfg, tparams, b = _setup(seed=1)
    assert tuple(tparams["blocks"][0]["spectral"]["wr"].shape) == \
        (16, 16, 8, 8)
    theirs = jfno.apply_fno(jparams, jcfg, jnp.asarray(b["x"]),
                            path="pallas", variant=variant)
    ours = tfno.apply_fno(tparams, tcfg, torch.from_numpy(b["x"]),
                          variant=variant)
    _allclose_rel(_np(ours), theirs, F32_TOL)
    ref32 = jfno.apply_fno(jparams, jcfg, jnp.asarray(b["x"]), path="xla")
    ours16 = tfno.apply_fno(tparams, tconfigs.with_precision(tcfg, "bf16"),
                            torch.from_numpy(b["x"]), variant=variant)
    assert ours16.dtype == torch.bfloat16
    _allclose_rel(_np(ours16), ref32, BF16_TOL)


@pytest.mark.parametrize("variant", ["full", "partial"])
def test_per_mode_step0_loss_and_grads_match_reference(variant):
    """``fno_loss`` and every leaf's grad of the per-mode model against
    jax.value_and_grad of the reference's pallas loss, each leaf within
    2e-4 of its own magnitude."""
    jcfg, jparams, tcfg, tparams, b = _setup(seed=2)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    jl, jg = jax.value_and_grad(lambda p: jfno.fno_loss(
        p, jcfg, jb, path="pallas", variant=variant))(jparams)
    tb = tree.map(torch.from_numpy, b)
    tl, tg = value_and_grad(
        make_loss_fn(tcfg, fno_path="fused", fno_variant=variant), tparams,
        tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_TOL)
    np.testing.assert_allclose(
        float(tfno.fno_loss(tparams, tcfg, tb, variant=variant)), float(jl),
        rtol=F32_TOL)
    ours, theirs = tree.leaves(tg), jax.tree_util.tree_leaves(jg)
    assert len(ours) == len(theirs)
    for a, r in zip(ours, theirs):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape
        _leaf_close(_np(a), r, F32_TOL)


def test_per_mode_train_step_matches_reference():
    """One AdamW step of the per-mode model, fused path against the
    reference's pallas path: loss, grad norm, updated params, moments."""
    jcfg, jparams, tcfg, tparams, b = _setup(seed=3)
    jopt, topt = JAdamW(lr=jconstant(1e-3)), AdamW(lr=constant(1e-3))
    jp, js, jm = jmake_train_step(jcfg, jopt, fno_path="pallas")(
        jparams, jopt.init(jparams), jax.tree_util.tree_map(jnp.asarray, b))
    tp, ts, tm = make_train_step(tcfg, topt, fno_path="fused")(
        tparams, topt.init(tparams), tree.map(torch.from_numpy, b))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=F32_TOL, err_msg=k)
    for a, r in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
        _allclose_rel(_np(a), r, F32_TOL)
    for a, r in zip(tree.leaves(ts["m"]),
                    jax.tree_util.tree_leaves(js["m"])):
        _leaf_close(_np(a), r, F32_TOL)


@pytest.mark.parametrize("variant", ["full", "partial"])
def test_per_mode_server_matches_reference(variant):
    """A CPU ``FNOServer`` of the per-mode model (a chunked request and a
    K=2 rollout) against the reference's server."""
    jcfg, jparams, tcfg, tparams, _ = _setup(seed=4)
    jsrv = jsfs.FNOServer(dataclasses.replace(jcfg, path="pallas"), jparams,
                          variant=variant, max_batch=4)
    tsrv = tsfs.FNOServer(tcfg, tparams, device="cpu", variant=variant,
                          max_batch=4)
    for n, k in ((5, 1), (3, 2)):
        x = np.random.default_rng(n).normal(
            size=(n, 3, 32, 32)).astype(np.float32)
        ours = tsrv(torch.from_numpy(x), rollout_steps=k)
        theirs = jsrv(jnp.asarray(x), rollout_steps=k)
        assert tuple(ours.shape) == tuple(theirs.shape) == (n, 1, 32, 32)
        _allclose_rel(_np(ours), theirs, F32_TOL)


def test_fno2d_large_config_matches_reference():
    ours = tconfigs.get_config("fno2d-large")
    theirs = jget_config("fno2d-large")
    for f in ("name", "ndim", "hidden", "num_layers", "in_channels",
              "out_channels", "spatial", "modes", "weight_mode",
              "lifting_dim", "fuse_block"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ours.param_count() == theirs.param_count()
    assert "fno2d-large" in tconfigs.FNO_IDS
    red = tconfigs.get_config("fno2d-large", reduced=True)
    assert red == tfno_configs.reduced_2d()  # shared, as the reference's
    assert red.weight_mode == jget_config("fno2d-large",
                                          reduced=True).weight_mode
    # The leaves, biases included: 134,350,977 at full width.
    lift, h, k = 2 * 128, 128, 32 * 32
    leaves = (3 * lift + lift + lift * h + h + h * lift + lift + lift + 1
              + 4 * (2 * h * h * k + h * h + h))
    assert leaves == 134_350_977


@pytest.mark.parametrize("per_mode", [False, True])
def test_plans_hold_fno2d_large(per_mode):
    """Hidden 128 needs clusters of 16 (8 out channels per block): every
    launch plans there within the card's shared memory, shared or
    per-mode weights."""
    args = (128, 128, (128, 128), (32, 32))
    block = engine.launch_plan(*args, per_mode=per_mode)
    wgrad = engine.wgrad_plan(*args, per_mode=per_mode)
    core = engine.core_plan(128, 128, 128, 32, per_mode)
    for plan in (block, wgrad):
        assert plan["cluster"] == 16 and plan["hs"] == plan["os"] == 8
    assert block["smem"] == (226432 if per_mode else 232320)
    assert wgrad["smem"] == 231808
    assert core["smem"] == (65536 if per_mode else 196608)
    for plan in (block, wgrad, core):
        assert plan["smem"] <= SMEM_LIMIT
    if per_mode:  # the batch reduction stages B=8's Ĝ over 452 modes
        assert engine.wgrad_mode_chunk(wgrad, 8, (32, 32)) == 452
    assert engine.launch_plan(128, 128, (128, 128), (32, 32))["cluster"] \
        == 16


def test_params_from_jax_carries_per_mode_leaves_unchanged():
    jcfg, jparams, _, tparams, _ = _setup(seed=5)
    jleaves = jax.tree_util.tree_leaves(jparams)
    tleaves = tree.leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tuple(tparams["blocks"][1]["spectral"]["wi"].shape) == \
        (16, 16, 8, 8)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("rank", [2, 3])
def test_chip_smoke_wgrad_yardstick_forms_the_gradients(rank, per_mode):
    """chip_smoke's staged wgrad yardstick (rfftn, truncation, einsum,
    matmul, sum; timed beside the kernel, never called by the port) forms
    dW_b and dbias as the plain version does and dW at the kernel's shape
    (torch.fft's transform is not the kernel's scaled adjoint chain, so
    dW's values are not held)."""
    cs = _chip_smoke()
    spatial, modes = (((16, 12), (5, 4)) if rank == 2
                      else ((8, 6, 10), (3, 2, 4)))
    rng = np.random.default_rng(rank)
    x = torch.tensor(rng.normal(size=(2, 4) + spatial), dtype=torch.float32)
    gz = torch.tensor(rng.normal(size=(2, 3) + spatial),
                      dtype=torch.float32)
    dw, dwb, dbias = cs.wgrad_staged(torch, x, gz, modes, per_mode)()
    ref = engine.fused_wgrad_plain(
        x, gz, tspec.operand_tensors(spatial, modes, "float32", "cpu",
                                     "wgrad"), per_mode=per_mode)
    assert dw.is_complex() and tuple(dw.shape) == tuple(ref[0].shape)
    torch.testing.assert_close(dwb, ref[2], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dbias, ref[3].reshape(-1), rtol=1e-5,
                               atol=1e-4)
    bare = cs.wgrad_staged(torch, x, gz, modes, per_mode, bypass=False)()
    assert len(bare) == 1 and bare[0].shape == dw.shape


def test_chip_smoke_bounds_count_per_mode_weights():
    """fno2d-large block forward, f32, B=8: the least operations (FFTs,
    CGEMM, bypass: 6.54 GFLOP) take 0.0397 ms at the f32 rate of three
    TF32 passes (165 TFLOP/s; 0.0977 ms on the CUDA cores' 67); x, y and W
    (counted once at 2·O·H·ΠK) take 0.0801 ms at 3.35 TB/s, and wb, bias
    and the DFT operands add 0.1 % to that, so the bytes bound it. The
    shared-weight count would leave 134 MB of W out."""
    cs = _chip_smoke()
    shape = (8, 128, 128, (128, 128), (32, 32), 4, cs.PEAK_F32_FLOPS)
    t_bytes, t_ops = cs.bound_parts("block_fwd", *shape, per_mode=True)
    assert round(t_ops, 4) == 0.0397
    _, t_ffma = cs.bound_parts("block_fwd", *shape[:6], cs.PEAK_FFMA_FLOPS,
                               per_mode=True)
    assert round(t_ffma, 4) == 0.0977
    act, w = 2 * 8 * 128 * 128 * 128, 2 * 128 * 128 * 1024
    assert round(4e3 * (act + w) / cs.PEAK_BYTES, 4) == 0.0801
    extra = 128 * 128 + 128 + 4 * 2 * 128 * 32  # wb, bias, 4 operands
    assert t_bytes == pytest.approx(4e3 * (act + w + extra) / cs.PEAK_BYTES)
    assert cs.bound_ms("block_fwd", *shape, per_mode=True) == (t_bytes,
                                                               "bytes")
    shared_bytes, _ = cs.bound_parts("block_fwd", *shape)
    assert t_bytes - shared_bytes == pytest.approx(
        4e3 * 2 * 128 * 128 * 1023 / cs.PEAK_BYTES)
    # wgrad reads x and gz and writes the per-mode dW in f32 (134 MB).
    w_bytes, _ = cs.bound_parts("wgrad", *shape, per_mode=True)
    assert w_bytes == pytest.approx(t_bytes)
    # The core reads per-mode W once: 134 MB more than shared W.
    c_pm, _ = cs.bound_parts("core", *shape, per_mode=True)
    c_sh, _ = cs.bound_parts("core", *shape)
    assert c_pm - c_sh == pytest.approx(4e3 * 2 * 128 * 128 * 1023 /
                                        cs.PEAK_BYTES)
