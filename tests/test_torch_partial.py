"""Port parity: the paper's partial fusion (``variant="partial"``) of
``repro_torch`` against the JAX reference.

* each plain kernel version against the reference wrapper that reaches its
  Pallas kernel (interpret mode, as the reference's own tests run it):
  ``truncated_rdft``, ``padded_irdft``, ``truncated_cdft``,
  ``padded_icdft`` with ``path="pallas"``, and
  ``engine.fused_fnond_core_call``; the oracle paths against the
  reference's "ref" and "xla" paths;
* the Kronecker-combined outer operands, bit-equal to the reference's in
  f32;
* ``fno_block_nd(variant="partial")`` at ranks 1–3 against the reference's
  partial block, its gradients against ``jax.grad`` of the reference's
  partial loss (each leaf against its own magnitude), and its launch
  structure (rdft, core, irdft forward; the three fused launches
  backward);
* ``apply_fno`` and the step-0 loss and grad norm of reduced fno2d/fno3d,
  and a CPU ``FNOServer(variant="partial")``.

Tolerances (DESIGN.md §4): f32 within 2e-4 of the reference (relative to
the output's magnitude, max(|ref|, 1)); bf16 forward within 2e-2 and bf16
grads within 5e-2 of the f32 reference. On the CPU every wrapper runs its
kernel's plain version; the CUDA kernels are checked on the card
(tests/test_torch_kernel_gpu.py, chip_smoke.py).
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
from repro.core import spectral as jspec
from repro.kernels import engine as jengine
from repro.kernels import ops as jops
from repro.train import serve_fno_step as jsfs
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.configs.base import PrecisionPolicy
from repro_torch.convert import params_from_jax
from repro_torch.core import fno as tfno
from repro_torch.core import spectral as tspec
from repro_torch.kernels import dft, engine
from repro_torch.kernels import ops as tops
from repro_torch.train import serve_fno_step as tsfs
from repro_torch.train.train_step import make_loss_fn, value_and_grad

_CASES = {
    1: ((64,), (17,)),
    2: ((16, 32), (5, 9)),
    3: ((8, 8, 16), (3, 3, 5)),
}
_NAMES = ("dx", "dwr", "dwi", "dwb", "dbias")
F32_TOL, BF16_TOL, BF16_GRAD_TOL = 2e-4, 2e-2, 5e-2


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


def _rows(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32)


# (kind, leading shape, input width, n, modes): ragged rows and widths.
_ROW_CASES = [("rdft", (3, 5), 37, 37, 9), ("irdft", (3, 5), 9, 37, 9),
              ("cdft", (4, 3), 20, 20, 7), ("icdft", (4, 3), 7, 20, 7)]
_TORCH_ROW = {"rdft": tops.truncated_rdft, "irdft": tops.padded_irdft,
              "cdft": tops.truncated_cdft, "icdft": tops.padded_icdft}
_JAX_ROW = {"rdft": jops.truncated_rdft, "irdft": jops.padded_irdft,
            "cdft": jops.truncated_cdft, "icdft": jops.padded_icdft}


def _row_call(fns, kind, ins, arg, **kw):
    out = fns[kind](*ins, arg, **kw)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _ROW_CASES, ids=lambda c: c[0])
def test_row_plain_versions_match_reference_pallas(case, dtype):
    """The fused path of each standalone transform (the row kernel's plain
    version on the CPU) against the reference's Pallas row kernel: f32 to
    2e-4; bf16 each side within 2e-2 of the f32 reference."""
    kind, lead, width, n, k = case
    ins = [_rows(lead + (width,), 7)]
    if kind != "rdft":
        ins.append(_rows(lead + (width,), 8))
    arg = n if kind in ("irdft", "icdft") else k
    ref32 = _row_call(_JAX_ROW, kind, [jnp.asarray(a) for a in ins], arg,
                      path="pallas")
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ours = _row_call(_TORCH_ROW, kind,
                     [torch.from_numpy(a).to(tdt) for a in ins], arg)
    theirs = _row_call(_JAX_ROW, kind,
                       [jnp.asarray(a).astype(jdt) for a in ins], arg,
                       path="pallas")
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for a, b, r in zip(ours, theirs, ref32):
        assert a.dtype == tdt and tuple(a.shape) == tuple(r.shape)
        _allclose_rel(_np(a), r, tol)
        _allclose_rel(np.asarray(b, np.float32), r, tol)


@pytest.mark.parametrize("path,jpath", [("ref", "ref"), ("staged", "xla")])
@pytest.mark.parametrize("case", _ROW_CASES, ids=lambda c: c[0])
def test_row_oracles_match_reference(case, path, jpath):
    kind, lead, width, n, k = case
    ins = [_rows(lead + (width,), 9)]
    if kind != "rdft":
        ins.append(_rows(lead + (width,), 10))
    arg = n if kind in ("irdft", "icdft") else k
    ours = _row_call(_TORCH_ROW, kind, [torch.from_numpy(a) for a in ins],
                     arg, path=path)
    theirs = _row_call(_JAX_ROW, kind, [jnp.asarray(a) for a in ins], arg,
                       path=jpath)
    for a, b in zip(ours, theirs):
        _allclose_rel(_np(a), b, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [2, 3])
def test_core_plain_matches_reference_core_call(rank, dtype):
    """``engine.fused_core`` (its plain version on the CPU) against the
    reference's ``fused_fnond_core_call`` on the same z, weights and the
    s_1 operands of the forward bundle; outputs in the reference's
    [B,K_R..K_2,O,s_1] layout."""
    spatial, modes = _CASES[rank]
    b, h, o = 2, 8, 6
    spec = tuple(modes[rank - 1:0:-1])
    zr, zi = (_rows((b, h, spatial[0]) + spec, s) for s in (11, 12))
    wr, wi = (_rows((o, h), s) / h for s in (13, 14))
    mats = jspec.fused_operand_mats(spatial, modes)
    ops = mats[2 * rank - 2:2 * rank + 2]
    ref32 = jengine.fused_fnond_core_call(
        *(jnp.asarray(a) for a in (zr, zi, wr, wi, *ops)), bb=1, bo=o, bh=h,
        interpret=True)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tmats = tspec.operand_tensors(spatial, modes, dtype, "cpu")
    ours = engine.fused_core(
        *(torch.from_numpy(a).to(tdt) for a in (zr, zi, wr, wi)),
        *tmats[2 * rank - 2:2 * rank + 2])
    theirs = jengine.fused_fnond_core_call(
        *(jnp.asarray(a).astype(jdt) for a in (zr, zi, wr, wi, *ops)),
        bb=1, bo=o, bh=h, interpret=True)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for a, c, r in zip(ours, theirs, ref32):
        assert a.dtype == tdt and tuple(a.shape) == tuple(r.shape)
        _allclose_rel(_np(a), r, tol)
        _allclose_rel(np.asarray(c, np.float32), r, tol)


@pytest.mark.parametrize("outer", [((32,), (9,)), ((8, 16), (3, 5)),
                                   ((64, 64), (16, 16)),
                                   ((6, 10, 12), (3, 4, 5))], ids=str)
def test_outer_operands_bit_equal_to_reference(outer):
    spatial, modes = outer
    for ours, theirs in ((tspec.outer_fwd_mats(spatial, modes),
                          jspec.outer_fwd_mats(spatial, modes)),
                         (tspec.outer_inv_mats(spatial, modes),
                          jspec.outer_inv_mats(spatial, modes))):
        for a, b in zip(ours, theirs):
            assert a.dtype == np.float32 and np.array_equal(a, b)
    fr, fi = tspec.row_operand_tensors("outer_fwd", spatial, modes,
                                       "bfloat16", "cpu")
    ref = torch.from_numpy(tspec.outer_fwd_mats(spatial, modes)[0])
    assert fr.dtype == torch.bfloat16 and torch.equal(
        fr, ref.to(torch.bfloat16))  # f64 -> f32 -> bf16, as the reference


# Rank-3 outer axes ((s_1, s_2, s_3), (k_1, k_2, k_3)): odd and ragged
# extents and fno3d's reduced size.
_OUTER_CASES = [((3, 6, 10), (2, 3, 4)), ((2, 5, 9), (2, 3, 5)),
                ((4, 16, 16), (2, 4, 4))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _OUTER_CASES, ids=str)
def test_outer_wrappers_match_reference_outer_transforms(case, dtype):
    """``dft.outer_rdft`` / ``outer_irdft`` through the port's
    ``_outer_fwd_batched`` / ``_outer_inv_batched`` (the per-axis factors;
    the plain version on the CPU) against the reference's, whose Pallas
    row kernels run in interpret mode: f32 within 2e-4; bf16 within 2e-2
    of the f32 reference."""
    spatial, modes = case
    b, h = 2, 3
    x = _rows((b, h) + spatial, 31)
    spec = (b, h, spatial[0], modes[2], modes[1])
    tr, ti = _rows(spec, 32), _rows(spec, 33)
    jf = jops._outer_fwd_batched(jnp.asarray(x), spatial, modes, True)
    ji = jops._outer_inv_batched(jnp.asarray(tr), jnp.asarray(ti), spatial,
                                 True)
    tdt = getattr(torch, dtype)
    t = lambda a: torch.from_numpy(a).to(tdt)
    ours_f = tops._outer_fwd_batched(t(x), spatial, modes)
    ours_i = tops._outer_inv_batched(t(tr), t(ti), spatial)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for a, r in zip(ours_f + (ours_i,), tuple(jf) + (ji,)):
        assert a.dtype == tdt and tuple(a.shape) == tuple(r.shape)
        _allclose_rel(_np(a), np.asarray(r, np.float32), tol)


@pytest.mark.parametrize("outer", [((6, 10), (3, 4)), ((5, 9), (3, 5)),
                                   ((64, 64), (16, 16))], ids=str)
def test_outer_factors_stack_to_the_combined_operands(outer):
    """The per-axis factors the outer wrappers take, stacked as the
    reference's Kronecker product (columns k_3..k_2, k_2 minor; rows of the
    inverse likewise), equal ``outer_fwd_mats`` / ``outer_inv_mats`` to f32
    rounding."""
    (n2, n3), (k2, k3) = outer
    c = lambda kind, n, k: (lambda p: p[0].double() + 1j * p[1].double())(
        tspec.row_operand_tensors(kind, (n,), (k,), "float32", "cpu"))
    fwd = torch.einsum("ab,cd->acdb", c("cdft", n2, k2), c("cdft", n3, k3))
    inv = torch.einsum("ba,dc->dbac", c("icdft", n2, k2), c("irdft", n3, k3))
    for got, want in ((fwd.reshape(n2 * n3, k3 * k2),
                       tspec.outer_fwd_mats((n2, n3), (k2, k3))),
                      (inv.reshape(k3 * k2, n2 * n3),
                       tspec.outer_inv_mats((n2, n3), (k2, k3)))):
        for part, ref in ((got.real, want[0]), (got.imag, want[1])):
            np.testing.assert_allclose(part.numpy(), ref, rtol=0,
                                       atol=4e-7)


def test_row_kernels_refuse_shapes_outside_their_plan():
    """The shape checks that stand before every launch, shown on CPU
    tensors: a slab or row over the shared-memory budget, factor pairs
    that do not match the slab, and more than two outer axes raise with
    the shape in the message."""
    f = lambda kind, n, k: tspec.row_operand_tensors(kind, (n,), (k,),
                                                     "float32", "cpu")
    with pytest.raises(ValueError, match="256x256 points.*shared memory"):
        dft.outer_rdft(torch.zeros(1, 256, 256), f("cdft", 256, 64),
                       f("cdft", 256, 64))
    with pytest.raises(ValueError, match="256x256 points.*shared memory"):
        dft.outer_irdft(torch.zeros(1, 64, 64), torch.zeros(1, 64, 64),
                        f("icdft", 256, 64), f("irdft", 256, 64))
    with pytest.raises(ValueError, match="rows of 4096 points"):
        dft.rdft(torch.zeros(2, 4096), *f("rdft", 4096, 64))
    with pytest.raises(ValueError, match="slabs must be"):
        dft.outer_rdft(torch.zeros(2, 10, 6), f("cdft", 6, 3),
                       f("cdft", 10, 4))
    with pytest.raises(ValueError, match="spatial \\(4, 4, 4, 4\\)"):
        tops._outer_fwd_batched(torch.zeros(1, 1, 4, 4, 4, 4), (4, 4, 4, 4),
                                (2, 2, 2, 2))
    # fno3d: at most 4 slabs of 64x64 a forward group, 2 an inverse one
    assert dft.max_group("rdft", torch.float32, 64, True) == 4
    assert dft.max_group("irdft", torch.float32, 64, True) == 2


def _block_args(rank, seed, b=2, h=8, o=6):
    spatial, modes = _CASES[rank]
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: (sc * rng.normal(size=s)).astype(np.float32)
    args = (mk(b, h, *spatial), mk(o, h, sc=1.0 / h), mk(o, h, sc=1.0 / h),
            mk(o, h, sc=1.0 / h), mk(o, sc=0.3))
    return args, modes


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_partial_block_matches_reference_partial(rank):
    args, modes = _block_args(rank, 100 + rank)
    ours = tops.fno_block_nd(*(torch.from_numpy(a) for a in args), modes,
                             path="fused", variant="partial")
    theirs = jops.fno_block_nd(*(jnp.asarray(a) for a in args), modes,
                               path="pallas", variant="partial")
    assert ours.dtype == torch.float32
    assert tuple(ours.shape) == tuple(theirs.shape)
    _allclose_rel(_np(ours), theirs, F32_TOL)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_partial_block_bf16_each_side_within_tolerance(rank):
    args, modes = _block_args(rank, 110 + rank)
    ref32 = jops.fno_block_nd(*(jnp.asarray(a) for a in args), modes,
                              path="xla")
    ours = tops.fno_block_nd(*(torch.from_numpy(a) for a in args), modes,
                             path="fused", variant="partial",
                             policy=PrecisionPolicy.from_name("bf16"))
    theirs = jops.fno_block_nd(*(jnp.asarray(a) for a in args), modes,
                               path="pallas", variant="partial",
                               policy=JPolicy.from_name("bf16"))
    assert ours.dtype == torch.bfloat16
    _allclose_rel(_np(ours), ref32, BF16_TOL)
    _allclose_rel(np.asarray(theirs, np.float32), ref32, BF16_TOL)


def _jax_grads(args, modes, policy=None):
    fn = lambda *a: jnp.sum(jnp.sin(jops.fno_block_nd(
        *a, modes, path="pallas", variant="partial",
        policy=policy).astype(jnp.float32)))
    return jax.grad(fn, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))


def _torch_grads(args, modes, policy=None):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = tops.fno_block_nd(*leaves, modes, path="fused", variant="partial",
                          policy=policy)
    return torch.autograd.grad(torch.sin(y.float()).sum(), leaves)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_partial_grads_match_reference_per_leaf(rank):
    """Every cotangent of the partial block against jax.grad of the
    reference's partial block, each within 2e-4 of its own magnitude."""
    args, modes = _block_args(rank, 120 + rank)
    for name, a, b in zip(_NAMES, _torch_grads(args, modes),
                          _jax_grads(args, modes)):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        _leaf_close(_np(a), b, F32_TOL, name)


@pytest.mark.parametrize("rank", [2, 3])
def test_partial_grads_bf16_within_tolerance(rank):
    args, modes = _block_args(rank, 130 + rank)
    ref32 = _jax_grads(args, modes)
    ours = _torch_grads(args, modes, PrecisionPolicy.from_name("bf16"))
    for name, a, c in zip(_NAMES, ours, ref32):
        assert a.dtype == torch.float32, name
        _allclose_rel(_np(a), c, BF16_GRAD_TOL, name)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_partial_launch_structure(rank, monkeypatch):
    """Forward: one rdft, one core and one irdft call per block (rank 1:
    one bare-spectral block call); backward: the gz-recompute, dx-adjoint
    and wgrad calls of the full variant, and no full-block forward."""
    calls = []

    def spy(mod, name, label=None):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            what = label(a, kw) if label else name
            calls.append(what)
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    kind = lambda a, kw: engine.launch_kind(a[3], kw.get("act", "gelu"),
                                            kw.get("adjoint", False))
    spy(dft, "rdft")
    spy(dft, "cdft")
    spy(dft, "irdft")
    spy(dft, "outer_rdft", lambda a, kw: "rdft")  # rank 3: counted so too
    spy(dft, "outer_irdft", lambda a, kw: "irdft")
    spy(engine, "fused_core", lambda a, kw: "core")
    spy(engine, "fused_block", kind)
    spy(engine, "fused_wgrad", lambda a, kw: "wgrad")
    args, modes = _block_args(rank, 140 + rank)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = tops.fno_block_nd(*leaves, modes, variant="partial")
    fwd = (["spectral_fwd"] if rank == 1 else ["rdft", "core", "irdft"])
    assert calls == fwd
    torch.autograd.grad(y.sum(), leaves)
    assert calls == fwd + ["gz_recompute", "dx_adjoint", "wgrad"]


def test_partial_contract():
    """Unknown variants, per-mode weights on the core whose modes differ
    from the operands', and tensors that require grad are refused, never
    served by another path."""
    args, modes = _block_args(2, 150)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="variant"):
        tops.fno_block_nd(*t, modes, variant="half")
    z = torch.zeros((1, 8, 16, 9))
    f = tspec.operand_tensors((16, 32), (5, 9), "float32", "cpu")
    with pytest.raises(ValueError, match="per-mode"):  # modes (5, 8)
        engine.fused_core(z, z, torch.zeros(6, 8, 5, 8),
                          torch.zeros(6, 8, 5, 8), *f[2:6])
    with pytest.raises(ValueError, match="bare spectral"):
        engine.fused_block(t[0], t[1], t[2], None, t[4].reshape(-1, 1),
                           tspec.operand_tensors((16, 32), modes, "float32",
                                                 "cpu"), act="linear")
    x = torch.zeros((2, 32), requires_grad=True)
    cr, ci = tspec.row_operand_tensors("rdft", (32,), (9,), "float32", "cpu")
    with pytest.raises(RuntimeError, match="requires grad"):
        dft.rdft(x, cr, ci)
    with pytest.raises(ValueError, match="operand"):
        dft.rdft(x.detach(), ci[:5], ci[:5])


def _setup(arch, seed=0, batch=2):
    jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                               fuse_block=True)
    jparams = jfno.init_fno(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, jcfg.in_channels)
                   + tuple(jcfg.spatial)).astype(np.float32)
    tcfg = dataclasses.replace(
        tconfigs.with_fuse_block(tconfigs.get_config(arch, reduced=True)),
        path="fused")
    return jcfg, jparams, tcfg, tparams, x


@pytest.mark.parametrize("arch", ["fno2d", "fno3d"])
def test_apply_fno_partial_matches_reference(arch):
    jcfg, jparams, tcfg, tparams, x = _setup(arch, seed=3)
    theirs = jfno.apply_fno(jparams, jcfg, jnp.asarray(x), path="pallas",
                            variant="partial")
    ours = tfno.apply_fno(tparams, tcfg, torch.from_numpy(x),
                          variant="partial")
    assert tuple(ours.shape) == tuple(theirs.shape)
    _allclose_rel(_np(ours), theirs, F32_TOL)
    ref32 = jfno.apply_fno(jparams, jcfg, jnp.asarray(x), path="xla")
    ours16 = tfno.apply_fno(tparams, tconfigs.with_precision(tcfg, "bf16"),
                            torch.from_numpy(x), variant="partial")
    assert ours16.dtype == torch.bfloat16
    _allclose_rel(_np(ours16), ref32, BF16_TOL)


@pytest.mark.parametrize("arch", ["fno2d", "fno3d"])
def test_partial_step0_loss_and_grads_match_reference(arch):
    """Step-0 loss, grad norm and every leaf's grad of the partial variant
    against jax.value_and_grad of the reference's partial loss."""
    jcfg, jparams, tcfg, tparams, x = _setup(arch, seed=4)
    y = _rows((x.shape[0], jcfg.out_channels) + tuple(jcfg.spatial), 5)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    jl, jg = jax.value_and_grad(lambda p: jfno.fno_loss(
        p, jcfg, jb, path="pallas", variant="partial"))(jparams)
    tl, tg = value_and_grad(
        make_loss_fn(tcfg, fno_path="fused", fno_variant="partial"), tparams,
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=F32_TOL)
    jleaves = jax.tree_util.tree_leaves(jg)
    gn = lambda ls: float(np.sqrt(sum(np.sum(np.asarray(a, np.float64) ** 2)
                                      for a in ls)))
    np.testing.assert_allclose(gn([_np(a) for a in tree.leaves(tg)]),
                               gn(jleaves), rtol=F32_TOL)
    for a, b in zip(tree.leaves(tg), jleaves):
        _leaf_close(_np(a), b, F32_TOL)


def test_cpu_server_partial_matches_reference():
    """A CPU ``FNOServer(variant="partial")`` request (a chunked one and a
    K=2 rollout) against the reference's partial server; on the CPU the
    wrappers run plain versions and count no launch."""
    jcfg, jparams, tcfg, tparams, _ = _setup("fno2d", seed=6)
    jsrv = jsfs.FNOServer(dataclasses.replace(jcfg, path="pallas"), jparams,
                          variant="partial", max_batch=4)
    tsrv = tsfs.FNOServer(tcfg, tparams, device="cpu", variant="partial",
                          max_batch=4)
    engine.LAUNCHES.clear()
    for n, k in ((5, 1), (3, 2)):
        x = _rows((n, 3, 32, 32), n)
        ours = tsrv(torch.from_numpy(x), rollout_steps=k)
        theirs = jsrv(jnp.asarray(x), rollout_steps=k)
        assert tuple(ours.shape) == tuple(theirs.shape) == (n, 1, 32, 32)
        _allclose_rel(_np(ours), theirs, F32_TOL)
    assert sum(engine.LAUNCHES.values()) == 0
    assert tsrv.stats["requests"] == 2
