"""The fused model ends (``cfg.fuse_ends``) of the port against the JAX
reference, on the CPU.

The lifting MLP folds into the first fused block's launch and the
projection MLP into the last one's (``ops.fno_block_ends_nd``; the
reference's ``repro.kernels.ops.fno_block_ends_nd``). On CPU tensors the
block kernel runs its plain version, so these tests hold the port's
function, dispatch, autograd and model wiring to the reference's: the
block with either end or both at ranks 1–3, shared and per-mode weights,
f32 (2e-4) and bf16 (2e-2 against the reference's own bf16 ends); every
grad against ``jax.grad``; reduced ends-fused models (output and every
leaf's grad), the 1-layer model, the ValueErrors, ``fuse_block=False``
ignoring ``fuse_ends``, and one served request and one training step
against the model without the ends. Inputs come from a numpy seed and
the reference's ``init_fno``, carried over by ``params_from_jax``. The
kernel itself is checked by tests/test_torch_kernel_emulated_ends.py and
on the card by tests/test_torch_kernel_gpu.py and chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.fno import with_precision as jwith_precision
from repro.core import fno as jfno
from repro.kernels import ops as jops
from repro.kernels.ops import PrecisionPolicy as JPolicy
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.configs.base import PrecisionPolicy
from repro_torch.convert import params_from_jax
from repro_torch.core import fno as tfno
from repro_torch.core import spectral
from repro_torch.kernels import engine, ops
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train.serve_fno_step import FNOServer
from repro_torch.train.train_step import (make_loss_fn, make_train_step,
                                          value_and_grad)

F32_TOL, BF16_TOL = 2e-4, 2e-2
# rank -> (spatial, modes): the reference's test_fused_block.py extents.
CASES = {1: ((64,), (17,)), 2: ((16, 32), (5, 9)), 3: ((8, 8, 16), (3, 3, 5))}
B, H, CIN, LIFT, COUT = 2, 8, 3, 12, 1
ENDS = ["lift", "proj", "both"]


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


def _block_case(rank, weight_mode, which, seed):
    """numpy f32 operands of one ends block: x (raw input with the lift,
    else hidden), wr, wi, wb [O,H], bias [O], and the lift / proj tuples
    in the model's param layout (None where absent)."""
    spatial, modes = CASES[rank]
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: (sc * rng.normal(size=s)).astype(np.float32)
    wshape = (H, H) + (tuple(modes) if weight_mode == "per_mode" else ())
    lift = (mk(CIN, LIFT, sc=0.6), mk(LIFT, sc=0.3), mk(LIFT, H, sc=0.3),
            mk(H, sc=0.3))
    proj = (mk(H, LIFT, sc=0.4), mk(LIFT, sc=0.3), mk(LIFT, COUT, sc=0.3),
            mk(COUT, sc=0.3))
    x = mk(B, CIN if which != "proj" else H, *spatial)
    block = [x, mk(*wshape, sc=1.0 / H), mk(*wshape, sc=1.0 / H),
             mk(H, H, sc=1.0 / H), mk(H, sc=0.3)]
    return (block, lift if which != "proj" else None,
            proj if which != "lift" else None, modes)


def _theirs(block, lift, proj, modes, policy=None, path="pallas"):
    j = lambda t: None if t is None else tuple(jnp.asarray(a) for a in t)
    return jops.fno_block_ends_nd(*(jnp.asarray(a) for a in block),
                                  modes, lift=j(lift), proj=j(proj),
                                  path=path, policy=policy)


def _ours(block, lift, proj, modes, policy=None, path="fused",
          grad=False):
    t = lambda a: torch.tensor(a, requires_grad=grad)
    tt = lambda e: None if e is None else tuple(t(a) for a in e)
    args = [t(a) for a in block]
    lift_t, proj_t = tt(lift), tt(proj)
    y = ops.fno_block_ends_nd(*args, modes, lift=lift_t, proj=proj_t,
                              path=path, policy=policy)
    leaves = args + list(lift_t or ()) + list(proj_t or ())
    return y, leaves


# ---------------------------------------------------------------------------
# The ends block against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weight_mode", ["shared", "per_mode"])
@pytest.mark.parametrize("which", ENDS)
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_ends_block_matches_reference_f32(rank, which, weight_mode):
    """One launch (its plain version here) against the reference's fused
    ends path: output shape and values within 2e-4; the staged oracles
    ("ref", "staged") too."""
    block, lift, proj, modes = _block_case(rank, weight_mode, which,
                                           seed=rank)
    theirs = _theirs(block, lift, proj, modes)
    for path in ("fused", "staged", "ref"):
        ours, _ = _ours(block, lift, proj, modes, path=path)
        assert tuple(ours.shape) == tuple(theirs.shape), path
        assert ours.shape[1] == (COUT if proj is not None else H)
        _allclose_rel(_np(ours), theirs, F32_TOL, path)


@pytest.mark.parametrize("weight_mode", ["shared", "per_mode"])
@pytest.mark.parametrize("which", ENDS)
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_ends_block_bf16_matches_reference_bf16(rank, which, weight_mode):
    """Under the bf16 policy (f32 operands, bf16 compute): the port's
    fused ends within 2e-2 of the reference's bf16 fused ends, emitted in
    bf16."""
    block, lift, proj, modes = _block_case(rank, weight_mode, which,
                                           seed=10 + rank)
    theirs = _theirs(block, lift, proj, modes,
                     policy=JPolicy.from_name("bf16"))
    ours, _ = _ours(block, lift, proj, modes,
                    policy=PrecisionPolicy.from_name("bf16"))
    assert ours.dtype == torch.bfloat16
    _allclose_rel(_np(ours), np.asarray(theirs, np.float32), BF16_TOL)


@pytest.mark.parametrize("weight_mode", ["shared", "per_mode"])
@pytest.mark.parametrize("which", ENDS)
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_ends_block_grads_match_jax(rank, which, weight_mode):
    """The grads of x, wr, wi, wb, bias and every end-MLP leaf through the
    fused path's backward (autograd of the staged composition) against
    jax.grad of the reference's fused ends, each leaf within 2e-4 of its
    own magnitude, at its primal's dtype."""
    block, lift, proj, modes = _block_case(rank, weight_mode, which,
                                           seed=20 + rank)
    rng = np.random.default_rng(30 + rank)
    n_lift = 4 if lift is not None else 0

    def loss(*leaves):
        blk, rest = leaves[:5], leaves[5:]
        lf = tuple(rest[:n_lift]) if lift is not None else None
        pj = tuple(rest[n_lift:]) if proj is not None else None
        y = jops.fno_block_ends_nd(*blk, modes, lift=lf, proj=pj,
                                   path="pallas")
        return jnp.sum(y * g)

    flat = list(block) + list(lift or ()) + list(proj or ())
    y0 = _theirs(block, lift, proj, modes)
    g = jnp.asarray(rng.normal(size=y0.shape).astype(np.float32))
    theirs = jax.grad(loss, argnums=tuple(range(len(flat))))(
        *(jnp.asarray(a) for a in flat))
    ours, leaves = _ours(block, lift, proj, modes, grad=True)
    got = torch.autograd.grad(ours, leaves, torch.from_numpy(np.array(g)))
    assert len(got) == len(theirs) == 5 + 4 * (lift is not None) + 4 * (
        proj is not None)
    for i, (a, r) in enumerate(zip(got, theirs)):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape
        _leaf_close(_np(a), r, F32_TOL, f"leaf {i}")


def test_ends_partial_variant_raises():
    block, lift, proj, modes = _block_case(2, "shared", "both", seed=0)
    with pytest.raises(ValueError, match="full-fusion variant"):
        ops.fno_block_ends_nd(*(torch.from_numpy(a) for a in block), modes,
                              lift=tuple(map(torch.from_numpy, lift)),
                              variant="partial")
    with pytest.raises(ValueError, match="lift, proj or both"):
        ops.fno_block_ends_nd(*(torch.from_numpy(a) for a in block), modes)


def test_engine_checks_the_ends_operands():
    """The wrapper takes the ends only on a block forward (act="gelu",
    wb and bias) and checks every end operand's shape; the ends launch is
    counted "block_ends"."""
    spatial, modes = CASES[2]
    x = torch.randn(2, 3, *spatial)
    wr, wi, wb = (torch.randn(6, 8) for _ in range(3))
    bias = torch.randn(6, 1)
    lift = (torch.randn(12, 3), torch.randn(12, 1), torch.randn(8, 12),
            torch.randn(8, 1))
    mats = spectral.operand_tensors(spatial, modes, "float32", "cpu")
    y = engine.fused_block(x, wr, wi, wb, bias, mats, lift=lift)
    assert tuple(y.shape) == (2, 6) + spatial
    with pytest.raises(ValueError, match="act='gelu'"):
        engine.fused_block(x, wr, wi, wb, bias, mats, lift=lift,
                           act="linear")
    with pytest.raises(ValueError, match="act='gelu'"):
        engine.fused_block(x, wr, wi, wb, None, mats, lift=lift)
    with pytest.raises(ValueError, match="l2w"):
        engine.fused_block(x, wr, wi, wb, bias, mats,
                           lift=lift[:2] + (torch.randn(8, 11),) + lift[3:])
    with pytest.raises(ValueError, match="p1w"):
        engine.fused_block(x[:, :1].expand(2, 8, *spatial).contiguous(), wr,
                           wi, wb, bias, mats,
                           proj=(torch.randn(5, 8), torch.randn(5, 1),
                                 torch.randn(1, 5), torch.randn(1, 1)))
    assert engine.launch_kind(wb, "gelu", False, ends=True) == "block_ends"


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------
# arch -> the ends launch's plan with both ends at the cluster the picker
# takes for B=8 (fno2d: 16 blocks fit the batch in one wave).
ENDS_PLANS = {
    "fno2d": (16, {"cluster": 16, "hs": 4, "os": 4, "rows_f": 47,
                   "rows_i": 31, "smem": 232192, "chain": "fma", "wl": 128,
                   "dp": 32, "ep": 128}),
    "fno3d": (16, {"cluster": 16, "hs": 2, "os": 2, "rows_f": 3,
                   "rows_i": 2, "smem": 213888, "chain": "fma", "wl": 64,
                   "dp": 16, "ep": 128}),
    "fno2d-large": (16, {"cluster": 16, "hs": 8, "os": 8, "rows_f": 27,
                         "rows_i": 16, "smem": 229504, "chain": "fma",
                         "wl": 128, "dp": 32, "ep": 32}),
}

# arch -> the lift-only and the projection-only launch's plans at the same
# cluster. The lift runs the CUDA cores' chain; both take the block's
# cluster and slices, and the inverse chunk that fits beside the ends'
# scratch, which shares phase 3's shared memory.
ENDS_ONLY_PLANS = {
    "fno2d": (
        {"cluster": 16, "hs": 4, "os": 4, "rows_f": 47, "rows_i": 31,
         "smem": 231680, "chain": "fma", "wl": 128, "dp": 32, "ep": 128},
        {"cluster": 16, "hs": 4, "os": 4, "rows_f": 64, "rows_i": 31,
         "smem": 232192, "chain": "tc", "wl": 128, "dp": 32, "ep": 128}),
    "fno3d": (
        {"cluster": 16, "hs": 2, "os": 2, "rows_f": 3, "rows_i": 2,
         "smem": 213888, "chain": "fma", "wl": 64, "dp": 16, "ep": 128},
        {"cluster": 16, "hs": 2, "os": 2, "rows_f": 2, "rows_i": 2,
         "smem": 205952, "chain": "tc", "wl": 64, "dp": 16, "ep": 128}),
    "fno2d-large": (
        {"cluster": 16, "hs": 8, "os": 8, "rows_f": 27, "rows_i": 16,
         "smem": 229504, "chain": "fma", "wl": 128, "dp": 32, "ep": 32},
        {"cluster": 16, "hs": 8, "os": 8, "rows_f": 64, "rows_i": 16,
         "smem": 230656, "chain": "tc", "wl": 128, "dp": 32, "ep": 32}),
}


def _untiled(plan):
    """A pinned plan with its untiled tiling fields: every hidden channel's
    spectra held at once (hc = hs) and one out tile."""
    return {**plan, "hc": plan["hs"], "ot": 1}


@pytest.mark.parametrize("arch", list(ENDS_PLANS))
def test_ends_plans_fit_full_width(arch):
    """At full width the ends launches fit a block's shared memory: the
    lift's hidden slice of a chunk takes fewer s_1 rows where needed, and
    the points a block takes of a piece (ep) halve from 128 until the plan
    fits (fno2d-large: 32); the lift runs the CUDA cores' chain ("fma").
    The lift-only and projection-only launches fit too, with the block's
    cluster and slices and the exact plans of ENDS_ONLY_PLANS; without the
    ends the plan is the block's, with no "ep"."""
    cfg = tconfigs.get_config(arch)
    lw = cfg.lifting_dim or 2 * cfg.hidden
    per_mode = cfg.weight_mode == "per_mode"
    cl, want = ENDS_PLANS[arch]
    args = (cfg.hidden, cfg.hidden, cfg.spatial, cfg.modes, cl, per_mode)
    cin, cout = cfg.in_channels, cfg.out_channels
    assert engine.launch_plan(*args, ends=(cin, lw, lw, cout)) == \
        _untiled(want)
    block = engine.launch_plan(*args)
    assert "ep" not in block and engine.launch_plan(*args, ends=None) == block
    for ends, pinned in zip(((cin, lw, 0, 0), (cfg.hidden, 0, lw, cout)),
                            ENDS_ONLY_PLANS[arch]):
        plan = engine.launch_plan(*args, ends=ends)
        assert plan == _untiled(pinned), ends
        assert plan["smem"] <= engine._SMEM_LIMIT and plan["ep"] >= 32
        for k in ("cluster", "hs", "os"):
            assert plan[k] == block[k], k
        assert plan["rows_i"] <= block["rows_i"]
        assert plan["chain"] == ("fma" if ends[1] else block["chain"])


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------
def _setup(arch, seed=0, batch=2, num_layers=None, fuse_block=True,
           weight_mode="shared"):
    """An ends-fused reduced config on both sides, the same params (one
    converted tree), and a batch {"x", "y"} of numpy f32."""
    over = {"fuse_block": fuse_block, "fuse_ends": True,
            "weight_mode": weight_mode}
    if num_layers:
        over["num_layers"] = num_layers
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), **over)
    jparams = jfno.init_fno(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    tcfg = dataclasses.replace(tconfigs.get_config(arch, reduced=True),
                               path="fused", **over)
    rng = np.random.default_rng(seed)
    sp = tuple(jcfg.spatial)
    b = {"x": rng.normal(size=(batch, jcfg.in_channels) + sp)
         .astype(np.float32),
         "y": rng.normal(size=(batch, jcfg.out_channels) + sp)
         .astype(np.float32)}
    return jcfg, jparams, tcfg, tparams, b


def test_with_fuse_ends_and_the_converted_tree():
    """``with_fuse_ends`` sets the field as the reference's does, and the
    ends-fused model's tree converts leaf for leaf: the same paths, shapes
    and values as the reference's init."""
    ours = tconfigs.with_fuse_ends(tconfigs.get_config("fno2d"))
    from repro.configs.fno import with_fuse_ends as jwith_fuse_ends
    theirs = jwith_fuse_ends(jget_config("fno2d"))
    assert ours.fuse_ends and theirs.fuse_ends
    assert not tconfigs.with_fuse_ends(ours, False).fuse_ends
    assert not tconfigs.get_config("fno2d").fuse_ends
    _, jparams, _, tparams, _ = _setup("fno2d")
    flat_t = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_o = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tparams))[0]
    assert [p for p, _ in flat_o] == [p for p, _ in flat_t]
    for (_, a), (_, r) in zip(flat_o, flat_t):
        np.testing.assert_array_equal(a, np.asarray(r))


@pytest.mark.parametrize("weight_mode", ["shared", "per_mode"])
@pytest.mark.parametrize("arch", ["fno1d", "fno2d", "fno3d"])
def test_ends_model_output_and_grads_match_reference(arch, weight_mode):
    """``apply_fno`` with ``with_fuse_ends`` on the reduced model against
    the reference's ends-fused pallas model: the output within 2e-4, the
    loss and every leaf's grad within 2e-4 of its own magnitude; and the
    same output as the port's model without the ends."""
    jcfg, jparams, tcfg, tparams, b = _setup(arch, seed=3,
                                             weight_mode=weight_mode)
    x = torch.from_numpy(b["x"])
    theirs = jfno.apply_fno(jparams, jcfg, jnp.asarray(b["x"]),
                            path="pallas")
    ours = tfno.apply_fno(tparams, tcfg, x)
    assert tuple(ours.shape) == tuple(theirs.shape)
    _allclose_rel(_np(ours), theirs, F32_TOL)
    plain = tfno.apply_fno(tparams, tconfigs.with_fuse_ends(tcfg, False), x)
    _allclose_rel(_np(ours), _np(plain), F32_TOL)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    jl, jg = jax.value_and_grad(lambda p: jfno.fno_loss(
        p, jcfg, jb, path="pallas"))(jparams)
    tl, tg = value_and_grad(make_loss_fn(tcfg, fno_path="fused"), tparams,
                            tree.map(torch.from_numpy, b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_TOL)
    theirs_g = jax.tree_util.tree_leaves(jg)
    ours_g = tree.leaves(tg)
    assert len(ours_g) == len(theirs_g)
    for i, (a, r) in enumerate(zip(ours_g, theirs_g)):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape
        _leaf_close(_np(a), r, F32_TOL, f"leaf {i}")


@pytest.mark.parametrize("arch", ["fno1d", "fno2d", "fno3d"])
def test_ends_model_bf16_matches_reference_bf16(arch):
    """Under bf16 the ends-fused model within 2e-2 of the reference's
    bf16 ends-fused model (both round the same boundary activations)."""
    jcfg, jparams, tcfg, tparams, b = _setup(arch, seed=4)
    theirs = jfno.apply_fno(jparams, jwith_precision(jcfg, "bf16"),
                            jnp.asarray(b["x"]), path="pallas")
    ours = tfno.apply_fno(tparams, tconfigs.with_precision(tcfg, "bf16"),
                          torch.from_numpy(b["x"]))
    assert ours.dtype == torch.bfloat16
    _allclose_rel(_np(ours), np.asarray(theirs, np.float32), BF16_TOL)


def test_one_layer_model_folds_both_ends_into_one_launch(monkeypatch):
    """A 1-layer model is one block launch with both ends (its plain
    version here: the wrapper is called once, with lift and proj), equal
    to the reference's within 2e-4, grads included."""
    jcfg, jparams, tcfg, tparams, b = _setup("fno2d", seed=5, num_layers=1)
    calls = []
    real = engine.fused_block

    def spy(*a, **kw):
        calls.append((kw.get("lift") is not None, kw.get("proj") is not None,
                      kw.get("act", "gelu")))
        return real(*a, **kw)
    monkeypatch.setattr(engine, "fused_block", spy)
    theirs = jfno.apply_fno(jparams, jcfg, jnp.asarray(b["x"]),
                            path="pallas")
    ours = tfno.apply_fno(tparams, tcfg, torch.from_numpy(b["x"]))
    assert calls == [(True, True, "gelu")]
    _allclose_rel(_np(ours), theirs, F32_TOL)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    jg = jax.grad(lambda p: jfno.fno_loss(p, jcfg, jb, path="pallas"))(
        jparams)
    _, tg = value_and_grad(make_loss_fn(tcfg, fno_path="fused"), tparams,
                           tree.map(torch.from_numpy, b))
    for a, r in zip(tree.leaves(tg), jax.tree_util.tree_leaves(jg)):
        _leaf_close(_np(a), r, F32_TOL)


def test_ends_model_launch_structure(monkeypatch):
    """An L-layer ends-fused model calls the block wrapper L times
    forward: the lift on the first, the projection on the last, plain
    blocks between; its backward calls the wrapper for the interior
    blocks only (gz recompute and dx), the end blocks differentiating
    their staged composition."""
    jcfg, jparams, tcfg, tparams, b = _setup("fno2d", seed=6, num_layers=3)
    calls = []
    real = engine.fused_block

    def spy(*a, **kw):
        calls.append(engine.launch_kind(
            a[3] if len(a) > 3 else kw.get("wb"), kw.get("act", "gelu"),
            kw.get("adjoint", False),
            kw.get("lift") is not None or kw.get("proj") is not None))
        return real(*a, **kw)
    monkeypatch.setattr(engine, "fused_block", spy)
    tb = tree.map(torch.from_numpy, b)
    tfno.apply_fno(tparams, tcfg, tb["x"])
    assert calls == ["block_ends", "block_fwd", "block_ends"]
    calls.clear()
    value_and_grad(make_loss_fn(tcfg, fno_path="fused"), tparams, tb)
    assert sorted(calls) == sorted(["block_ends", "block_fwd", "block_ends",
                                    "gz_recompute", "dx_adjoint"])


@pytest.mark.parametrize("variant", ["full", "partial"])
def test_fuse_ends_is_ignored_without_fuse_block(variant):
    """With fuse_block off (the spectral-only path) fuse_ends changes
    nothing: the port's output equals its own model without the flag,
    and the reference's with it."""
    jcfg, jparams, tcfg, tparams, b = _setup("fno2d", seed=7,
                                             fuse_block=False)
    x = torch.from_numpy(b["x"])
    ours = tfno.apply_fno(tparams, tcfg, x, variant=variant)
    plain = tfno.apply_fno(tparams, tconfigs.with_fuse_ends(tcfg, False), x,
                           variant=variant)
    torch.testing.assert_close(ours, plain, rtol=0, atol=0)
    theirs = jfno.apply_fno(jparams, jcfg, jnp.asarray(b["x"]),
                            path="pallas", variant=variant)
    _allclose_rel(_np(ours), theirs, F32_TOL)


def test_ends_model_partial_variant_raises():
    _, _, tcfg, tparams, b = _setup("fno2d", seed=8)
    with pytest.raises(ValueError, match="full-fusion variant"):
        tfno.apply_fno(tparams, tcfg, torch.from_numpy(b["x"]),
                       variant="partial")


def test_server_and_train_step_match_the_model_without_ends():
    """One FNOServer request (and a K=2 rollout) and one AdamW step on
    the ends-fused reduced fno2d equal the same on the model without the
    ends (2e-4; the step's loss, grad norm and every updated leaf)."""
    _, _, tcfg, tparams, b = _setup("fno2d", seed=9)
    base = tconfigs.with_fuse_ends(tcfg, False)
    x = torch.from_numpy(b["x"])
    srv = {c.fuse_ends: FNOServer(c, tparams, device="cpu", max_batch=4)
           for c in (tcfg, base)}
    for k in (1, 2):
        _allclose_rel(_np(srv[True](x, rollout_steps=k)),
                      _np(srv[False](x, rollout_steps=k)), F32_TOL)
    tb = tree.map(torch.from_numpy, b)
    outs = {}
    for c in (tcfg, base):
        opt = AdamW(lr=constant(1e-3))
        step = make_train_step(c, opt, fno_path="fused")
        outs[c.fuse_ends] = step(tparams, opt.init(tparams), tb)
    (p1, _, m1), (p0, _, m0) = outs[True], outs[False]
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                               rtol=F32_TOL)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m0["grad_norm"]), rtol=F32_TOL)
    for a, r in zip(tree.leaves(p1), tree.leaves(p0)):
        _allclose_rel(_np(a), _np(r), F32_TOL)


# ---------------------------------------------------------------------------
# chip_smoke.py's ends helpers
# ---------------------------------------------------------------------------
def _chip_smoke():
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("which", ["lift", "proj", "both"])
def test_chip_smoke_ends_bound_adds_the_mlps(which):
    """The ends launch's bound is the block forward's with the raw input
    read in place of x (lift), the model output written in place of y
    (proj), the MLPs' weights read once and their multiply-adds added."""
    cs = _chip_smoke()
    cfg = tconfigs.get_config("fno2d")
    b, h, sp, md = 8, cfg.hidden, cfg.spatial, cfg.modes
    cin, lw, lp, cout = cs.ends_dims_of(which, cfg)
    pts = int(np.prod(sp))
    for eb, peak in ((4, cs.PEAK_F32_FLOPS), (2, cs.PEAK_BF16_FLOPS)):
        base = cs.bound_parts("block_fwd", b, h, h, sp, md, eb, peak)
        ends = cs.bound_parts("block_ends", b, h, h, sp, md, eb, peak,
                              ends=(cin, lw, lp, cout))
        elems = ((b * (cin - h) * pts + lw * cin + lw + h * lw + h
                  if lw else 0)
                 + (b * (cout - h) * pts + lp * h + lp + cout * lp + cout
                    if lp else 0))
        macs = b * pts * ((lw * (cin + h) if lw else 0)
                          + (lp * (h + cout) if lp else 0))
        np.testing.assert_allclose(ends[0] - base[0],
                                   1e3 * eb * elems / cs.PEAK_BYTES,
                                   rtol=1e-9)
        np.testing.assert_allclose(ends[1] - base[1],
                                   1e3 * 2 * macs / peak, rtol=1e-9)
    assert (cin, lw, lp, cout) == {"lift": (3, 128, 0, 1),
                                   "proj": (3, 0, 128, 1),
                                   "both": (3, 128, 128, 1)}[which]


@pytest.mark.parametrize("which", ["lift", "proj", "both"])
def test_chip_smoke_ends_yardstick_computes_the_launch(monkeypatch, which):
    """The staged yardstick chip_smoke.py times beside an ends launch
    (``fno_block_ends_nd(path="ref")`` on the model layout of the
    launch's operands) computes that launch's function, and
    ``ends_launch`` drives the kernel wrapper with the right end."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    cfg = tconfigs.get_config("fno2d", reduced=True)
    x, xin, block, lift, proj = cs.ends_inputs(torch, cfg, 2, seed=3)
    mats = spectral.operand_tensors(cfg.spatial, cfg.modes, "float32",
                                    "cpu")
    y = cs.ends_launch(engine, which, x, xin, block, lift, proj, mats)
    model = lambda e: (e[0].t(), e[1].reshape(-1), e[2].t(),
                       e[3].reshape(-1))
    staged = ops.fno_block_ends_nd(
        xin if which != "proj" else x, *block[:3], block[3].reshape(-1),
        cfg.modes, lift=model(lift) if which != "proj" else None,
        proj=model(proj) if which != "lift" else None, path="ref")
    _allclose_rel(_np(y), _np(staged), F32_TOL)
