"""Port parity, training: AdamW, the schedules, the PDE data, the loss and
the train step of ``repro_torch`` against the JAX reference, the training
CLI on the CPU, and the bias-grad reduction under bf16.

Inputs are made with numpy (or drawn by the reference and carried over as
numpy) so both packages see the same numbers.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import fno as jfno
from repro.data import pde as jpde
from repro.optim import AdamW as JAdamW
from repro.optim.adamw import global_norm as jglobal_norm
from repro.optim.schedule import constant as jconstant
from repro.optim.schedule import cosine_warmup as jcosine
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.core import fno as tfno
from repro_torch.data import pde as tpde
from repro_torch.launch import train_fno as tcli
from repro_torch.optim import AdamW, global_norm
from repro_torch.optim.schedule import constant, cosine_warmup
from repro_torch.train.train_step import (make_loss_fn, make_train_step,
                                          value_and_grad)


def _allclose_rel(a, b, tol, name=""):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol,
                               err_msg=name)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _tree_pair(rng):
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    t = {"a": {"w": mk(3, 4), "b": mk(4)}, "blocks": [{"v": mk(2, 2)},
                                                       {"v": mk(5)}]}
    return (tree.map(torch.from_numpy, t),
            jax.tree_util.tree_map(jnp.asarray, t))


@pytest.mark.parametrize("clip,grad_scale", [(1.0, 10.0), (1.0, 0.01),
                                             (0.0, 1.0)])
def test_adamw_matches_reference(clip, grad_scale):
    """Four steps under warmup-cosine, with the clip active, idle and off."""
    rng = np.random.default_rng(0)
    tp, jp = _tree_pair(rng)
    ours = AdamW(lr=cosine_warmup(1e-2, 2, 6), clip_norm=clip)
    theirs = JAdamW(lr=jcosine(1e-2, 2, 6), clip_norm=clip)
    ts, js = ours.init(tp), theirs.init(jp)
    for _ in range(4):
        g = {"a": {"w": rng.normal(size=(3, 4)), "b": rng.normal(size=4)},
             "blocks": [{"v": rng.normal(size=(2, 2))},
                        {"v": rng.normal(size=5)}]}
        g = jax.tree_util.tree_map(
            lambda a: (grad_scale * a).astype(np.float32), g)
        tp, ts = ours.update(tree.map(torch.from_numpy, g), ts, tp)
        jp, js = theirs.update(jax.tree_util.tree_map(jnp.asarray, g), js,
                               jp)
    assert int(ts["step"]) == int(js["step"]) == 4
    for name, a, b in (("p", tp, jp), ("m", ts["m"], js["m"]),
                       ("v", ts["v"], js["v"])):
        for x, y in zip(tree.leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_allclose(_np(x), np.asarray(y), rtol=1e-5,
                                       atol=1e-7, err_msg=name)


def test_adamw_state_dtype_and_global_norm():
    rng = np.random.default_rng(1)
    tp, jp = _tree_pair(rng)
    np.testing.assert_allclose(float(global_norm(tp)),
                               float(jglobal_norm(jp)), rtol=1e-6)
    st = AdamW(lr=constant(1e-3), state_dtype="bfloat16").init(tp)
    assert all(m.dtype == torch.bfloat16 for m in tree.leaves(st["m"]))
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


def test_schedules_match_reference():
    ours, theirs = cosine_warmup(3e-3, 4, 20), jcosine(3e-3, 4, 20)
    for step in range(0, 24):
        np.testing.assert_allclose(float(ours(torch.tensor(step))),
                                   float(theirs(step)), rtol=1e-6)
    assert float(constant(0.5)(torch.tensor(3))) == float(jconstant(0.5)(3))


def _reference_draws(key, shape):
    kr, ki = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.normal(kr, shape))),
            torch.from_numpy(np.array(jax.random.normal(ki, shape))))


@pytest.mark.parametrize("dim,n", [(1, 64), (2, 16), (3, 8)])
def test_grf_fed_reference_draws(dim, n):
    """Fed the reference's own normal draws, each GRF equals the
    reference's field to f32 FFT rounding (relative 1e-5)."""
    key = jax.random.PRNGKey(dim)
    shape = {1: (3, n // 2 + 1), 2: (3, n, n // 2 + 1),
             3: (2, n, n, n // 2 + 1)}[dim]
    re, im = _reference_draws(key, shape)
    ours = getattr(tpde, f"grf_{dim}d_from_normals")(re, im, n)
    theirs = getattr(jpde, f"grf_{dim}d")(key, shape[0], n)
    assert tuple(ours.shape) == tuple(theirs.shape)
    _allclose_rel(_np(ours) / np.abs(theirs).max(),
                  np.asarray(theirs) / np.abs(theirs).max(), 1e-5)


def test_darcy_solve_and_batch_fed_the_same_field():
    """The CG solver on the same coefficients (fixed 200 iterations)
    agrees to relative 1e-4: f32 sums in another order drift a little
    over the iterations. The whole batch from the same field agrees
    likewise."""
    key = jax.random.fold_in(jax.random.PRNGKey(77), 0)
    g = jpde.grf_2d(key, 2, 16)
    a = np.where(np.asarray(g) > 0, 12.0, 3.0).astype(np.float32)
    f = np.ones_like(a)
    ours = tpde.darcy_solve(torch.from_numpy(a), torch.from_numpy(f))
    theirs = jpde.darcy_solve(jnp.asarray(a), jnp.asarray(f))
    _allclose_rel(_np(ours) / float(np.abs(theirs).max()),
                  np.asarray(theirs) / float(np.abs(theirs).max()), 1e-4)
    ob = tpde.darcy_from_field(torch.from_numpy(np.array(g)))
    jb = jpde.darcy_batch(0, 0, 2, 16)
    for k in ("x", "y"):
        assert ob[k].dtype == torch.float32
        _allclose_rel(_np(ob[k]), jb[k], 1e-4, k)


def test_burgers_and_diffusion_solves_fed_the_same_inputs():
    """Spectral RK4 Burgers (64 points, 200 steps) and the exact 3D
    diffusion propagator on the same initial fields: relative 1e-4."""
    u0 = np.asarray(jpde.grf_1d(jax.random.PRNGKey(3), 2, 64))
    u0 = (u0 / u0.std(axis=-1, keepdims=True)).astype(np.float32)
    ours = tpde.burgers_solve(torch.from_numpy(u0), n=64)
    theirs = jpde.burgers_solve(jnp.asarray(u0), n=64)
    _allclose_rel(_np(ours), theirs, 1e-4, "burgers")
    v0 = np.array(jpde.grf_3d(jax.random.PRNGKey(4), 2, 8), np.float32)
    ours = tpde.diffusion3d_solve(torch.from_numpy(v0), n=8)
    theirs = jpde.diffusion3d_solve(jnp.asarray(v0), n=8)
    _allclose_rel(_np(ours), theirs, 1e-4, "diffusion")


@pytest.mark.parametrize("task,n,shape_x", [
    ("burgers", 32, (2, 1, 32)), ("darcy", 16, (2, 3, 16, 16)),
    ("diffusion3d", 8, (2, 1, 8, 8, 8))])
def test_batches_are_seeded_pure_functions(task, n, shape_x):
    make = getattr(tpde, f"{task}_batch")
    kw = {"iters": 20} if task == "darcy" else {}
    one = make(0, 1, 2, n, **kw)
    again = make(0, 1, 2, n, **kw)
    other = make(0, 2, 2, n, **kw)
    assert tuple(one["x"].shape) == shape_x
    assert one["y"].shape[1] == 1 and one["y"].shape[2:] == one["x"].shape[2:]
    for k in ("x", "y"):
        assert one[k].dtype == torch.float32
        assert bool(torch.isfinite(one[k]).all())
        torch.testing.assert_close(one[k], again[k], rtol=0, atol=0)
    assert not torch.equal(one["y"], other["y"])


def _train_setup(seed=0, batch=2):
    jcfg = dataclasses.replace(jget_config("fno2d", reduced=True),
                               fuse_block=True)
    jparams = jfno.init_fno(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    tcfg = tconfigs.with_fuse_block(tconfigs.get_config("fno2d",
                                                        reduced=True))
    rng = np.random.default_rng(seed)
    b = {"x": rng.normal(size=(batch, 3, 32, 32)).astype(np.float32),
         "y": rng.normal(size=(batch, 1, 32, 32)).astype(np.float32)}
    return jcfg, jparams, tcfg, tparams, b


def _check_step(ours, theirs, tol):
    tp, ts, tm = ours
    jp, js, jm = theirs
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                   err_msg=k)
    assert int(tm["step"]) == int(jm["step"]) == 1
    for a, b in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
        _allclose_rel(_np(a), b, tol)
    for a, b in zip(tree.leaves(ts["m"]), jax.tree_util.tree_leaves(js["m"])):
        _allclose_rel(_np(a), b, tol)


def test_train_step_fused_matches_reference_pallas():
    """One AdamW step of reduced fno2d with whole-block fusion: the port's
    fused path against the reference's pallas path (interpret mode), in
    loss, grad norm, updated params and first moments (2e-4)."""
    jcfg, jparams, tcfg, tparams, b = _train_setup()
    jopt, topt = JAdamW(lr=jconstant(1e-3)), AdamW(lr=constant(1e-3))
    theirs = jmake_train_step(jcfg, jopt, fno_path="pallas")(
        jparams, jopt.init(jparams), jax.tree_util.tree_map(jnp.asarray, b))
    ours = make_train_step(tcfg, topt, fno_path="fused")(
        tparams, topt.init(tparams), tree.map(torch.from_numpy, b))
    _check_step(ours, theirs, 2e-4)


def test_fused_grads_match_reference_pallas_per_leaf():
    """Every leaf's gradient of the fused loss against jax.grad of the
    reference's pallas loss (interpret mode), each within 2e-4 of that
    leaf's own magnitude: a first AdamW step moves a param by about
    lr·sign(g) whatever g's size, so the step check alone cannot see a
    leaf's gradient."""
    jcfg, jparams, tcfg, tparams, b = _train_setup(seed=3)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    theirs = jax.grad(lambda p: jfno.fno_loss(p, jcfg, jb, path="pallas"))(
        jparams)
    _, ours = value_and_grad(make_loss_fn(tcfg, fno_path="fused"), tparams,
                             tree.map(torch.from_numpy, b))
    ours, theirs = tree.leaves(ours), jax.tree_util.tree_leaves(theirs)
    assert len(ours) == len(theirs)
    for a, r in zip(ours, theirs):
        assert a.dtype == torch.float32
        r = np.asarray(r, np.float32)
        scale = max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(_np(a) / scale, r / scale, rtol=0,
                                   atol=2e-4)


def test_train_step_microbatches_match_reference():
    """Microbatch accumulation (2 microbatches, f32 accumulator) on the
    staged path against the reference's xla path."""
    jcfg, jparams, tcfg, tparams, b = _train_setup(seed=1, batch=4)
    jopt, topt = JAdamW(lr=jconstant(1e-3)), AdamW(lr=constant(1e-3))
    theirs = jmake_train_step(jcfg, jopt, microbatches=2, fno_path="xla")(
        jparams, jopt.init(jparams), jax.tree_util.tree_map(jnp.asarray, b))
    ours = make_train_step(tcfg, topt, microbatches=2, fno_path="staged")(
        tparams, topt.init(tparams), tree.map(torch.from_numpy, b))
    _check_step(ours, theirs, 2e-4)
    fused = make_train_step(tcfg, topt, microbatches=2, fno_path="fused")(
        tparams, topt.init(tparams), tree.map(torch.from_numpy, b))
    _check_step(fused, theirs, 2e-4)


def test_fno_loss_matches_reference():
    jcfg, jparams, tcfg, tparams, b = _train_setup(seed=2)
    theirs = jfno.fno_loss(jparams, jcfg, jax.tree_util.tree_map(
        jnp.asarray, b), path="xla")
    for path in ("staged", "fused"):
        ours = tfno.fno_loss(tparams, tcfg, tree.map(torch.from_numpy, b),
                             path=path)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(float(ours), float(theirs), rtol=2e-5)


def test_dense_bias_grad_under_bf16_is_the_f32_reduction():
    """The bias is broadcast before the bf16 cast, so its grad is the f32
    sum of the bf16 cotangent, as in the reference."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    x = rng.normal(size=(3, 4, 16, 16)).astype(np.float32)
    gy = (1.0 + 0.01 * rng.normal(size=(3, 6, 16, 16))).astype(np.float32)
    p = {"w": torch.from_numpy(w), "b": torch.from_numpy(bias)
         .requires_grad_(True)}
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tg = torch.from_numpy(gy).to(torch.bfloat16)
    y = tfno._dense(p, tx)
    assert y.dtype == torch.bfloat16
    (db,) = torch.autograd.grad(y, [p["b"]], tg)
    want = tg.float().sum(dim=(0, 2, 3))
    assert db.dtype == torch.float32
    torch.testing.assert_close(db, want, rtol=1e-6, atol=0)
    _, vjp = jax.vjp(lambda b_: jfno._dense({"w": jnp.asarray(w), "b": b_},
                                            jnp.asarray(x, jnp.bfloat16)),
                     jnp.asarray(bias))
    (jdb,) = vjp(jnp.asarray(gy, jnp.bfloat16))
    np.testing.assert_allclose(_np(db), np.asarray(jdb), rtol=1e-5)


def test_cli_trains_on_cpu(capsys):
    args = tcli.build_parser().parse_args(
        ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2"])
    out = tcli.run(args)
    assert out["device"] == "cpu" and out["path"] == "fused"
    assert [h["step"] for h in out["history"]] == [1, 2]
    assert all(math.isfinite(h["loss"]) and h["grad_norm"] > 0
               for h in out["history"])
    assert "step     2 loss" in capsys.readouterr().out


def test_cli_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    args = tcli.build_parser().parse_args(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.run(args)
