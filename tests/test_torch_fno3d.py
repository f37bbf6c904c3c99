"""fno3d: the rank-3 preset (hidden 32, 4 layers, 64³, modes 16³, shared
W) on every fused path of ``repro_torch``.

* Launch plans: at full width the block kernel and the wgrad kernel plan
  clusters of 16 with fewer s_1 rows per forward-chain chunk than they
  take at most (8), within a block's shared memory; the plans of fno1d,
  fno2d and fno2d-large are pinned field by field; a shape that does not
  fit even at one row per chunk is refused.
* Reduced fno3d models against the JAX reference (``path="pallas"``, its
  Pallas kernels in interpret mode, as its own tests run them): whole-block
  (``fuse_block`` on) and spectral-only (off), full and partial variant,
  shared and per-mode W: ``apply_fno``, the step-0 loss and every leaf's
  grad, in f32 and bf16.

Tolerances (DESIGN.md §4): f32 within 2e-4 of the reference, bf16 forward
within 2e-2 and bf16 grads within 5e-2 of the f32 reference. On the CPU the
wrappers run their kernels' plain versions; the CUDA kernels at fno3d's
chunking are held against those under emulation
(tests/test_torch_kernel_emulated_fno3d.py) and on the card
(tests/test_torch_kernel_gpu.py, chip_smoke.py).
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
from repro.core import fno as jfno
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.core import fno as tfno
from repro_torch.kernels import engine
from repro_torch.train.train_step import make_loss_fn, value_and_grad

F32_TOL, BF16_TOL, BF16_GRAD_TOL = 2e-4, 2e-2, 5e-2
SMEM_LIMIT = 232448
FNO3D = (32, 32, (64, 64, 64), (16, 16, 16))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ---------------------------------------------------------------------------
# Launch plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("kind", ["block", "wgrad"])
def test_plans_hold_fno3d_full_width(kind, per_mode):
    """Clusters of 8 cannot hold fno3d (its spectra alone are 262,144 B a
    block), so both kernels plan clusters of 16 (2 hidden and 2 out
    channels a block, 131,072 B of spectra) and step the forward chain's
    chunk down from 8 s_1 rows to fit: the block kernel's to 3 (a ragged
    last chunk of 64 = 21·3 + 1), the wgrad kernel's tensor-core chain
    (two input buffers of 64·68 floats a row, its factors resident) to 1,
    with 256-point chunks of the dW_b product. The plan is sized for f32:
    bf16 operands take no more."""
    plan_fn = engine.launch_plan if kind == "block" else engine.wgrad_plan
    plan = plan_fn(*FNO3D, per_mode=per_mode)
    assert plan["cluster"] == 16 and plan["hs"] == plan["os"] == 2
    assert engine._chain_rows(FNO3D[2], FNO3D[3]) == 8
    assert plan["smem"] <= SMEM_LIMIT
    assert plan_fn(*FNO3D, 16, per_mode) == plan
    if kind == "block":
        assert plan["rows_f"] == 3 and plan["rows_i"] == 1
        assert plan["smem"] == (211232 if per_mode else 211744)
        # One more row per chunk would not fit.
        four = engine._chain_work(FNO3D[2], FNO3D[3], 4)
        three = engine._chain_work(FNO3D[2], FNO3D[3], 3)
        assert plan["smem"] + 4 * (four - three) > SMEM_LIMIT
    else:
        assert plan["rows_f"] == 1 and plan["cols"] == 256
        assert plan["smem"] == 221568
        assert plan["work"] == (221568 - 128) // 4
        # One more row per chunk would not fit.
        two = engine._wgrad_bytes(4, *FNO3D[:4], 2, 2, 2, 256)
        assert two[0] > SMEM_LIMIT


# The plans of fno1d, fno2d and fno2d-large (the block kernel's as they
# were before the forward chain's chunk could step down; the wgrad
# kernel's of its tensor-core design): (hidden, spatial, modes, per_mode,
# max_cluster) -> (block plan, wgrad plan).
_UNCHANGED = {
    "fno1d-8": ((64, (256,), (64,), False, 8), (
        {"cluster": 8, "hs": 8, "os": 8, "rows_f": 256, "rows_i": 256,
         "smem": 22560},
        {"cluster": 8, "hs": 8, "os": 8, "rows_f": 64, "cols": 32,
         "work": 21664, "smem": 86784})),
    "fno1d-16": ((64, (256,), (64,), False, 16), (
        {"cluster": 16, "hs": 4, "os": 4, "rows_f": 256, "rows_i": 256,
         "smem": 11296},
        {"cluster": 16, "hs": 4, "os": 4, "rows_f": 64, "cols": 16,
         "work": 20640, "smem": 82688})),
    "fno2d-8": ((64, (128, 128), (32, 32), False, 8), (
        {"cluster": 8, "hs": 8, "os": 8, "rows_f": 64, "rows_i": 8,
         "smem": 186400},
        {"cluster": 8, "hs": 8, "os": 8, "rows_f": 16, "cols": 128,
         "work": 57920, "smem": 231808})),
    "fno2d-16": ((64, (128, 128), (32, 32), False, 16), (
        {"cluster": 16, "hs": 4, "os": 4, "rows_f": 64, "rows_i": 8,
         "smem": 117792},
        {"cluster": 16, "hs": 4, "os": 4, "rows_f": 64, "cols": 128,
         "work": 56640, "smem": 226688})),
    "fno2d-large": ((128, (128, 128), (32, 32), True, 8), (
        {"cluster": 16, "hs": 8, "os": 8, "rows_f": 64, "rows_i": 8,
         "smem": 184352},
        {"cluster": 16, "hs": 8, "os": 8, "rows_f": 16, "cols": 64,
         "work": 57920, "smem": 231808})),
    "fno2d-large-shared": ((128, (128, 128), (32, 32), False, 8), (
        {"cluster": 16, "hs": 8, "os": 8, "rows_f": 64, "rows_i": 8,
         "smem": 192544},
        {"cluster": 16, "hs": 8, "os": 8, "rows_f": 16, "cols": 64,
         "work": 57920, "smem": 231808})),
}


@pytest.mark.parametrize("name", list(_UNCHANGED))
def test_plans_of_the_other_presets_are_unchanged(name):
    """fno1d, fno2d and fno2d-large: the block kernel fits at the
    register-filling chunk, so its plans (both cluster sizes the picker
    weighs) are what they were, field by field, and its times cannot move;
    the wgrad kernel's are pinned as its tensor-core design plans them."""
    (h, spatial, modes, per_mode, cl), (block, wgrad) = _UNCHANGED[name]
    assert engine.launch_plan(h, h, spatial, modes, cl, per_mode) == block
    assert engine.wgrad_plan(h, h, spatial, modes, cl, per_mode) == wgrad


def test_plans_refuse_what_one_row_cannot_hold():
    """64³ with modes 32³: the spectra alone exceed a block's shared memory
    at clusters of 16, so no chunk fits and both plans raise."""
    for plan_fn in (engine.launch_plan, engine.wgrad_plan):
        with pytest.raises(ValueError, match="shared memory"):
            plan_fn(32, 32, (64, 64, 64), (32, 32, 32))


def test_fno3d_config_matches_reference():
    ours, theirs = tconfigs.get_config("fno3d"), jget_config("fno3d")
    for f in ("name", "ndim", "hidden", "num_layers", "in_channels",
              "out_channels", "spatial", "modes", "weight_mode"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert (ours.hidden, ours.hidden, ours.spatial, ours.modes) == FNO3D


# ---------------------------------------------------------------------------
# Reduced fno3d models on every fused path
# ---------------------------------------------------------------------------
# (fuse_block, variant, weight_mode)
_MODELS = [(fb, v, w) for fb in (True, False) for v in ("full", "partial")
           for w in ("shared", "per_mode")]
_IDS = [f"{'block' if fb else 'spectral'}-{v}-{w}" for fb, v, w in _MODELS]


def _setup(fuse_block, weight_mode, seed, batch=2):
    """Reduced fno3d on both sides with this fusion and weight layout, the
    same params, and a batch {"x", "y"} of numpy f32."""
    jcfg = dataclasses.replace(jget_config("fno3d", reduced=True),
                               fuse_block=fuse_block, weight_mode=weight_mode)
    jparams = jfno.init_fno(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    tcfg = dataclasses.replace(tconfigs.get_config("fno3d", reduced=True),
                               fuse_block=fuse_block,
                               weight_mode=weight_mode, path="fused")
    rng = np.random.default_rng(seed)
    sp = tuple(jcfg.spatial)
    b = {"x": rng.normal(size=(batch, jcfg.in_channels) + sp)
         .astype(np.float32),
         "y": rng.normal(size=(batch, jcfg.out_channels) + sp)
         .astype(np.float32)}
    return jcfg, jparams, tcfg, tparams, b


@pytest.mark.parametrize("fuse_block,variant,weight_mode", _MODELS, ids=_IDS)
def test_reduced_fno3d_forward_matches_reference(fuse_block, variant,
                                                 weight_mode):
    jcfg, jparams, tcfg, tparams, b = _setup(fuse_block, weight_mode, 1)
    if weight_mode == "per_mode":
        assert tuple(tparams["blocks"][0]["spectral"]["wr"].shape) == \
            (8, 8, 4, 4, 4)
    theirs = jfno.apply_fno(jparams, jcfg, jnp.asarray(b["x"]),
                            path="pallas", variant=variant)
    ours = tfno.apply_fno(tparams, tcfg, torch.from_numpy(b["x"]),
                          variant=variant)
    assert tuple(ours.shape) == tuple(theirs.shape)
    _allclose_rel(_np(ours), theirs, F32_TOL)
    ref32 = jfno.apply_fno(jparams, jcfg, jnp.asarray(b["x"]), path="xla")
    ours16 = tfno.apply_fno(tparams, tconfigs.with_precision(tcfg, "bf16"),
                            torch.from_numpy(b["x"]), variant=variant)
    assert ours16.dtype == torch.bfloat16
    _allclose_rel(_np(ours16), ref32, BF16_TOL)


@pytest.mark.parametrize("fuse_block,variant,weight_mode", _MODELS, ids=_IDS)
def test_reduced_fno3d_loss_and_grads_match_reference(fuse_block, variant,
                                                      weight_mode):
    """``fno_loss`` and every leaf's grad against jax.value_and_grad of the
    reference's pallas loss: f32 each leaf within 2e-4 of its own
    magnitude; bf16 (f32 master params) loss and leaves within 5e-2."""
    jcfg, jparams, tcfg, tparams, b = _setup(fuse_block, weight_mode, 2)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    jl, jg = jax.value_and_grad(lambda p: jfno.fno_loss(
        p, jcfg, jb, path="pallas", variant=variant))(jparams)
    theirs = jax.tree_util.tree_leaves(jg)
    tb = tree.map(torch.from_numpy, b)
    for preset, tol in (("f32", F32_TOL), ("bf16", BF16_GRAD_TOL)):
        cfg = tconfigs.with_precision(tcfg, preset)
        tl, tg = value_and_grad(
            make_loss_fn(cfg, fno_path="fused", fno_variant=variant),
            tparams, tb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=tol,
                                   err_msg=preset)
        ours = tree.leaves(tg)
        assert len(ours) == len(theirs)
        for i, (a, r) in enumerate(zip(ours, theirs)):
            assert a.dtype == torch.float32 and tuple(a.shape) == r.shape
            _leaf_close(_np(a), r, tol, f"{preset} leaf {i}")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["rdft", "irdft"])
@pytest.mark.parametrize("spatial,modes", [((8, 12), (3, 4)),
                                           ((6, 8, 10), (2, 3, 4))],
                         ids=["rank2", "rank3"])
def test_chip_smoke_row_yardstick_computes_the_row_launch(kind, spatial,
                                                          modes):
    """The torch.fft call chip_smoke.py times beside a row launch computes
    that launch's function: rfftn / irfftn over the outer axes s_2..s_R
    (one axis at rank 2, the Kronecker-combined operand at rank 3), with
    the kernels' spectrum columns in k_R..k_2 order."""
    from repro_torch.core import spectral
    from repro_torch.kernels import dft
    cs = _chip_smoke()
    r, n1 = len(spatial), spatial[0]
    osp, omd = spatial[1:], modes[1:]
    n_out, p = int(np.prod(osp)), int(np.prod(omd))
    gen = torch.Generator().manual_seed(r)
    op = (kind if r == 2 else {"rdft": "outer_fwd",
                               "irdft": "outer_inv"}[kind])
    mats = spectral.row_operand_tensors(op, osp, omd, "float32", "cpu")
    if kind == "rdft":
        x = torch.randn(2, 3, n1, n_out, generator=gen)
        yr, yi = dft.rdft_plain(x, *mats)
        lib = cs.library_call(torch, kind, [x], spatial, modes)()
        lib = lib.permute(0, 1, 2, *reversed(range(3, 2 + r)))
        got = (lib.real.reshape(yr.shape), lib.imag.reshape(yi.shape))
        want = (yr, yi)
    else:
        zr = torch.randn(2, 3, n1, p, generator=gen)
        zi = torch.randn(2, 3, n1, p, generator=gen)
        y = dft.irdft_plain(zr, zi, *mats)
        lib = cs.library_call(torch, kind, [zr, zi], spatial, modes)()
        got, want = (lib.reshape(y.shape),), (y,)
    for a, b in zip(got, want):
        _allclose_rel(a.numpy(), b.numpy(), F32_TOL, kind)
