"""Port parity: the bare spectral layer on the fused path — the paper's
fused FFT→CGEMM→iFFT, which the model runs with ``fuse_block`` off — of
``repro_torch`` against the JAX reference (its Pallas kernels in interpret
mode, as its own tests run them):

* ``ops.spectral_layer_{1,2,3}d(path="fused")`` forward and grads (dx,
  dwr, dwi) against ``repro.kernels.ops.spectral_layer_{1,2,3}d(path=
  "pallas")`` and ``jax.vjp``, ranks 1–3, shared and per-mode weights,
  both variants, f32 and bf16, and the launch structure (one forward
  launch, or rdft → core → irdft; dx and the bypass-free wgrad backward);
* the plain versions of the backward's two launches against the
  reference's engine calls: the bare adjoint and
  ``fused_fnond_wgrad_call(with_bypass=False)``;
* reduced fno1d/fno2d with ``fuse_block=False``: ``apply_fno``, the step-0
  loss and every leaf's grad, one ``make_train_step`` step, and
  ``FNOServer``, against the reference's ``path="pallas"``;
* the ``fused_fno1d`` / ``fused_fno2d`` wrappers against the reference's.

Tolerances (DESIGN.md §4): f32 within 2e-4 of the reference, bf16 forward
within 2e-2 and bf16 grads within 5e-2 of the f32 reference. On the CPU the
wrappers run their kernels' plain versions; the CUDA kernels are held
against those on the card (tests/test_torch_kernel_gpu.py,
chip_smoke.py) and under emulation
(tests/test_torch_kernel_emulated_spectral.py).
"""
import dataclasses

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
from repro.kernels import fused_fno1d as jf1
from repro.kernels import fused_fno2d as jf2
from repro.kernels import ops as jops
from repro.optim import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.train import serve_fno_step as jsfs
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.configs.base import PrecisionPolicy
from repro_torch.convert import params_from_jax
from repro_torch.core import fno as tfno
from repro_torch.core import spectral as tspec
from repro_torch.kernels import dft, engine
from repro_torch.kernels import fused_fno1d as tf1
from repro_torch.kernels import fused_fno2d as tf2
from repro_torch.kernels import ops as tops
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train import serve_fno_step as tsfs
from repro_torch.train.train_step import (make_loss_fn, make_train_step,
                                          value_and_grad)

_CASES = {
    1: ((64,), (17,)),
    2: ((16, 32), (5, 9)),
    3: ((8, 8, 16), (3, 3, 5)),
}
_NAMES = ("dx", "dwr", "dwi")
F32_TOL, BF16_TOL, BF16_GRAD_TOL = 2e-4, 2e-2, 5e-2
_JLAYER = {1: jops.spectral_layer_1d, 2: jops.spectral_layer_2d,
           3: jops.spectral_layer_3d}
_TLAYER = {1: tops.spectral_layer_1d, 2: tops.spectral_layer_2d,
           3: tops.spectral_layer_3d}
# (rank, variant): rank 1 has no partial variant.
_LAYERS = [(1, "full"), (2, "full"), (2, "partial"), (3, "full"),
           (3, "partial")]


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


def _layer_args(rank, seed, per_mode, b=2, h=8, o=6):
    """x, wr, wi (shared [O,H] or per-mode [O,H,k…]) as numpy f32."""
    spatial, modes = _CASES[rank]
    rng = np.random.default_rng(seed)
    w = (o, h) + (modes if per_mode else ())
    mk = lambda *s, sc=1.0: (sc * rng.normal(size=s)).astype(np.float32)
    return (mk(b, h, *spatial), mk(*w, sc=1.0 / h), mk(*w, sc=1.0 / h)), \
        modes


def _kw(rank, variant):
    return {} if rank == 1 else {"variant": variant}


def _mode_arg(rank, modes):
    return modes[0] if rank == 1 else modes


def _torch_layer(args, rank, modes, variant, policy=None):
    """The port's fused layer and the grads of Σ sin(y)."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = _TLAYER[rank](*leaves, _mode_arg(rank, modes), path="fused",
                      policy=policy, **_kw(rank, variant))
    return y, torch.autograd.grad(torch.sin(y.float()).sum(), leaves)


@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("rank,variant", _LAYERS,
                         ids=[f"r{r}-{v}" for r, v in _LAYERS])
def test_spectral_layer_matches_reference(rank, variant, per_mode):
    """Forward and every grad of Σ sin(y): f32 within 2e-4 (forward of the
    output's magnitude, grads of each leaf's own); bf16 (f32 master
    weights, bf16 compute) forward within 2e-2 and grads, back at f32,
    within 5e-2 of the f32 reference."""
    args, modes = _layer_args(rank, 10 * rank + per_mode, per_mode)
    fn = lambda *a: _JLAYER[rank](*a, _mode_arg(rank, modes), path="pallas",
                                  **_kw(rank, variant))
    jy, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    jgrads = vjp(jnp.cos(jy))
    y, grads = _torch_layer(args, rank, modes, variant)
    assert y.dtype == torch.float32 and tuple(y.shape) == jy.shape
    _allclose_rel(_np(y), jy, F32_TOL, "y")
    for name, a, r in zip(_NAMES, grads, jgrads):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape, name
        _leaf_close(_np(a), r, F32_TOL, name)
    y16, grads16 = _torch_layer(args, rank, modes, variant,
                                PrecisionPolicy.from_name("bf16"))
    assert y16.dtype == torch.bfloat16
    _allclose_rel(_np(y16), jy, BF16_TOL, "y bf16")
    for name, a, r in zip(_NAMES, grads16, jgrads):
        assert a.dtype == torch.float32, name
        _leaf_close(_np(a), r, BF16_GRAD_TOL, name)


@pytest.mark.parametrize("rank,variant", _LAYERS,
                         ids=[f"r{r}-{v}" for r, v in _LAYERS])
def test_spectral_layer_launch_structure(monkeypatch, rank, variant):
    """Forward: one bare block-kernel call (full, and partial at rank 1)
    or rdft, core, irdft; backward: the bare call in adjoint mode and the
    wgrad without its bypass — never a whole-block mode."""
    calls = []

    def spy(mod, name, label):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls.append(label(a, kw))
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    spy(dft, "rdft", lambda a, kw: "rdft")
    spy(dft, "irdft", lambda a, kw: "irdft")
    spy(engine, "fused_core", lambda a, kw: "core")
    spy(engine, "fused_block", lambda a, kw: (
        "spectral_dx" if kw.get("adjoint") else "spectral_fwd")
        if a[3] is None else "block")
    spy(engine, "fused_wgrad", lambda a, kw: (
        "wgrad" if kw.get("with_bypass", True) else "spectral_wgrad"))
    args, modes = _layer_args(rank, 40 + rank, False)
    y, _ = _torch_layer(args, rank, modes, variant)
    fwd = (["spectral_fwd"] if variant == "full" or rank == 1
           else ["rdft", "core", "irdft"])
    assert calls == fwd + ["spectral_dx", "spectral_wgrad"]
    assert set(engine.SPECTRAL_KINDS) == {"spectral_fwd", "spectral_dx",
                                          "spectral_wgrad"}


@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_backward_plain_versions_match_reference_engine(rank, per_mode):
    """The bare layer's two backward launches as plain versions: dx (the
    block kernel's bare mode with the adjoint bundle and the weights'
    transposed view, adjoint=True) against the reference's adjoint
    ``_fnond_fused``, and ``fused_wgrad_plain(with_bypass=False)``
    against ``fused_fnond_wgrad_call(with_bypass=False)`` (per-mode dW in
    the parameter layout; the reference's kernel emits [K_R..K_1,O,H])."""
    (x, wr, wi), modes = _layer_args(rank, 50 + rank, per_mode)
    spatial = x.shape[2:]
    b, h, o = x.shape[0], x.shape[1], wr.shape[0]
    gy = np.random.default_rng(rank).normal(
        size=(b, o) + spatial).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    mats = {k: tspec.operand_tensors(spatial, modes, "float32", "cpu", k)
            for k in ("adjoint", "wgrad")}
    dx = engine.fused_block(t(gy), t(wr).transpose(0, 1),
                            t(wi).transpose(0, 1), None, None,
                            mats["adjoint"], act="linear", adjoint=True)
    jdx = jops._fnond_fused(jnp.asarray(gy), jnp.swapaxes(wr, 0, 1),
                            jnp.swapaxes(wi, 0, 1), modes, b, h, o, True,
                            JPolicy(), adjoint=True)
    assert tuple(dx.shape) == (b, h) + spatial
    _allclose_rel(_np(dx), jdx, F32_TOL, "dx")

    ours = engine.fused_wgrad_plain(t(x), t(gy), mats["wgrad"],
                                    per_mode=per_mode, with_bypass=False)
    jm = jspec.wgrad_operand_mats(spatial, modes, "float32")
    theirs = jengine.fused_fnond_wgrad_call(
        jnp.asarray(x), jnp.asarray(gy), *jm, bb=b, bo=o, bh=h,
        per_mode=per_mode, interpret=True, with_bypass=False)
    assert len(ours) == len(theirs) == 2
    r = rank
    perm = (r, r + 1) + tuple(range(r - 1, -1, -1))  # -> [O,H,K_1..K_R]
    for name, a, ref in zip(_NAMES[1:], ours, theirs):
        ref = np.transpose(np.asarray(ref), perm) if per_mode else ref
        assert tuple(a.shape) == np.shape(ref), name
        _leaf_close(_np(a), ref, F32_TOL, name)


def _setup(arch, seed=0, batch=2):
    """Reduced `arch` with fuse_block off on both sides, the same
    params, and a batch {"x", "y"} of numpy f32."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               fuse_block=False)
    jparams = jfno.init_fno(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    tcfg = dataclasses.replace(tconfigs.get_config(arch, reduced=True),
                               path="fused")
    assert not tcfg.fuse_block
    rng = np.random.default_rng(seed)
    sp = tuple(jcfg.spatial)
    b = {"x": rng.normal(size=(batch, jcfg.in_channels) + sp)
         .astype(np.float32),
         "y": rng.normal(size=(batch, jcfg.out_channels) + sp)
         .astype(np.float32)}
    return jcfg, jparams, tcfg, tparams, b


_MODELS = [("fno1d", "full"), ("fno2d", "full"), ("fno2d", "partial")]


@pytest.mark.parametrize("arch,variant", _MODELS,
                         ids=[f"{a}-{v}" for a, v in _MODELS])
def test_apply_fno_spectral_only_matches_reference(arch, variant):
    jcfg, jparams, tcfg, tparams, b = _setup(arch, seed=1)
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


@pytest.mark.parametrize("arch,variant", _MODELS,
                         ids=[f"{a}-{v}" for a, v in _MODELS])
def test_spectral_only_loss_and_grads_match_reference(arch, variant):
    """``fno_loss`` and every leaf's grad of the spectral-only model
    against jax.value_and_grad of the reference's pallas loss, each leaf
    within 2e-4 of its own magnitude."""
    jcfg, jparams, tcfg, tparams, b = _setup(arch, seed=2)
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


def test_spectral_only_train_step_matches_reference():
    """One AdamW step of spectral-only reduced fno2d: loss and grad norm of
    ``make_train_step`` against the reference's pallas step, and the
    updated params."""
    jcfg, jparams, tcfg, tparams, b = _setup("fno2d", seed=3)
    jopt, topt = JAdamW(lr=jconstant(1e-3)), AdamW(lr=constant(1e-3))
    jp, _, jm = jmake_train_step(jcfg, jopt, fno_path="pallas")(
        jparams, jopt.init(jparams), jax.tree_util.tree_map(jnp.asarray, b))
    tp, _, tm = make_train_step(tcfg, topt, fno_path="fused")(
        tparams, topt.init(tparams), tree.map(torch.from_numpy, b))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=F32_TOL, err_msg=k)
    for a, r in zip(tree.leaves(tp), jax.tree_util.tree_leaves(jp)):
        _allclose_rel(_np(a), r, F32_TOL)


@pytest.mark.parametrize("variant", ["full", "partial"])
def test_spectral_only_server_matches_reference(variant):
    """A CPU ``FNOServer`` of reduced fno2d with fuse_block off (a chunked
    request and a K=2 rollout) against the reference's server."""
    jcfg, jparams, tcfg, tparams, _ = _setup("fno2d", seed=4)
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


@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
def test_fused_fno_wrappers_match_reference(per_mode):
    """The rank-pinning wrappers, fed the reference's positional operands,
    against the reference's wrappers (interpret mode): fused_fno1d_call
    and its wgrad, fused_fno2d_call (the core), fused_fno2d_full_call and
    its wgrad."""
    j = jnp.asarray
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    rng = np.random.default_rng(60 + per_mode)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    for rank in (1, 2):
        (x, wr, wi), modes = _layer_args(rank, 70 + rank, per_mode)
        spatial = x.shape[2:]
        b, h, o = x.shape[0], x.shape[1], wr.shape[0]
        g = mk(b, o, *spatial)
        fm = [np.asarray(m) for m in jspec.fused_operand_mats(spatial,
                                                              modes)]
        wm = [np.asarray(m) for m in jspec.wgrad_operand_mats(spatial,
                                                              modes)]
        call = (jf1.fused_fno1d_call, tf1.fused_fno1d_call) if rank == 1 \
            else (jf2.fused_fno2d_full_call, tf2.fused_fno2d_full_call)
        wcall = (jf1.fused_fno1d_wgrad_call, tf1.fused_fno1d_wgrad_call) \
            if rank == 1 else (jf2.fused_fno2d_wgrad_call,
                               tf2.fused_fno2d_wgrad_call)
        jy = call[0](j(x), j(wr), j(wi), *map(j, fm), b, o, h,
                     interpret=True)
        _allclose_rel(_np(call[1](t(x), t(wr), t(wi), *map(t, fm), b, o,
                                  h)), jy, F32_TOL, f"y r{rank}")
        jw = wcall[0](j(x), j(g), *map(j, wm), b, o, h, per_mode,
                      interpret=True)
        ours = wcall[1](t(x), t(g), *map(t, wm), b, o, h, per_mode)
        perm = (rank, rank + 1) + tuple(range(rank - 1, -1, -1))
        for a, r in zip(ours, jw):
            r = np.transpose(np.asarray(r), perm) if per_mode else r
            _leaf_close(_np(a), r, F32_TOL, f"dw r{rank}")
    # The 2D core on the stage-1 spectrum [B,H,X,KY].
    spatial, modes = _CASES[2]
    zr, zi = mk(2, 8, spatial[0], modes[1]), mk(2, 8, spatial[0], modes[1])
    w = (6, 8) + (modes if per_mode else ())
    wr, wi = mk(*w) / 8, mk(*w) / 8
    fr, fi, gr, gi = [np.asarray(m) for m in
                      jspec.fused_operand_mats(spatial, modes)[2:6]]
    jy = jf2.fused_fno2d_call(*map(j, (zr, zi, wr, wi, fr, fi, gr, gi)), 2,
                              6, 8, interpret=True)
    ours = tf2.fused_fno2d_call(*map(t, (zr, zi, wr, wi, fr, fi, gr, gi)),
                                2, 6, 8)
    for a, r in zip(ours, jy):  # per-mode: [KY,B,O,X] -> [B,KY,O,X]
        r = np.moveaxis(np.asarray(r), 1, 0) if per_mode else r
        _allclose_rel(_np(a), r, F32_TOL, "core")


def test_spectral_layer_contract():
    (x, wr, wi), modes = _layer_args(2, 80, False)
    tx, twr, twi = map(torch.from_numpy, (x, wr, wi))
    with pytest.raises(ValueError, match="variant"):
        tops.spectral_layer_nd(tx, twr, twi, modes, path="fused",
                               variant="halfway")
    with pytest.raises(ValueError, match="spatial axes"):
        tops.spectral_layer_3d(tx, twr, twi, modes + (3,))
    with pytest.raises(ValueError, match="path"):
        tops.spectral_layer_nd(tx, twr, twi, modes, path="pallas")
    # adjoint=True names a backward's dx: the linear epilogue only.
    mats = tspec.operand_tensors(x.shape[2:], modes, "float32", "cpu")
    with pytest.raises(ValueError, match="adjoint=True"):
        engine.fused_block(tx, twr, twi, torch.zeros(6, 8), None, mats,
                           act="gelu", adjoint=True)


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bounds_of_the_spectral_launches():
    """The bare layer's bounds: spectral_fwd and spectral_dx move x, y, W
    and the operands and do the block's operations less the bypass
    (2·O·H·S per sample); spectral_wgrad reads x and gz and writes dW in
    f32 (per-mode: 2·O·H·ΠK of it), the same operations."""
    cs = _chip_smoke()
    shape = (8, 128, 128, (128, 128), (32, 32), 4, cs.PEAK_F32_FLOPS)
    bypass = 1e3 * 8 * 2 * 128 * 128 * 128 * 128 / cs.PEAK_F32_FLOPS
    _, block_ops = cs.bound_parts("block_fwd", *shape, per_mode=True)
    for kind in ("spectral_fwd", "spectral_dx", "spectral_wgrad"):
        _, ops = cs.bound_parts(kind, *shape, per_mode=True)
        assert ops == pytest.approx(block_ops - bypass)
    fwd, _ = cs.bound_parts("spectral_fwd", *shape, per_mode=True)
    dx, _ = cs.bound_parts("spectral_dx", *shape, per_mode=True)
    wg, _ = cs.bound_parts("spectral_wgrad", *shape, per_mode=True)
    assert dx == fwd  # H = O: the same bytes
    act, w = 2 * 8 * 128 * 128 * 128, 2 * 128 * 128 * 1024
    mats = 4 * 2 * 128 * 32
    assert fwd == pytest.approx(4e3 * (act + w + mats) / cs.PEAK_BYTES)
    assert wg == pytest.approx(fwd)  # f32: dW written as W is read
    wg16, _ = cs.bound_parts("spectral_wgrad", *shape[:5], 2,
                             cs.PEAK_BF16_FLOPS, per_mode=True)
    assert wg16 == pytest.approx(1e3 * (2 * (act + mats) + 4 * w)
                                 / cs.PEAK_BYTES)
