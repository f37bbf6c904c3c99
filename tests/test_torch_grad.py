"""Port parity, backward: the fused FNO block's gradients and the three
backward launches of ``repro_torch`` against the JAX reference.

* ``ops.fno_block_nd(path="fused")`` differentiated by torch autograd (its
  Function's backward runs the gz-recompute, dx-adjoint and wgrad
  wrappers, which run their plain versions on CPU tensors) against
  ``jax.grad`` of the reference's one-kernel block (``path="pallas"``, the
  Pallas kernels in interpret mode), ranks 1–3 at the odd extents: f32 to
  2e-4, bf16 to 5e-2 of the f32 reference (DESIGN.md §4);
* each backward plain version against the reference kernel launch it
  stands for (``_fnond_fused`` with ``act="gelu_vjp"`` or the adjoint
  bundle, ``_fnond_wgrad(with_bypass=True)``);
* the adjoint and wgrad operand bundles, bit-equal to the reference's in
  f32;
* the launch structure: one block-kernel call forward, three backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PrecisionPolicy as JPolicy
from repro.core import spectral as jspec
from repro.kernels import ops as jops
from repro_torch.configs.base import PrecisionPolicy
from repro_torch.core import spectral as tspec
from repro_torch.kernels import engine
from repro_torch.kernels import ops as tops

_CASES = {
    1: ((64,), (17,)),
    2: ((16, 32), (5, 9)),
    3: ((8, 8, 16), (3, 3, 5)),
}
_NAMES = ("dx", "dwr", "dwi", "dwb", "dbias")


def _allclose_rel(a, b, tol, name=""):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol,
                               err_msg=name)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _block_args(rank, seed, b=2, h=8, o=6):
    spatial, modes = _CASES[rank]
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: (sc * rng.normal(size=s)).astype(np.float32)
    args = (mk(b, h, *spatial), mk(o, h, sc=1.0 / h), mk(o, h, sc=1.0 / h),
            mk(o, h, sc=1.0 / h), mk(o, sc=0.3))
    return args, modes


def _jax_grads(args, modes, policy=None):
    fn = lambda *a: jnp.sum(jnp.sin(jops.fno_block_nd(
        *a, modes, path="pallas", policy=policy).astype(jnp.float32)))
    return jax.grad(fn, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))


def _torch_grads(args, modes, policy=None):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = tops.fno_block_nd(*leaves, modes, path="fused", policy=policy)
    return torch.autograd.grad(torch.sin(y.float()).sum(), leaves)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_fused_block_grads_match_reference_f32(rank):
    args, modes = _block_args(rank, 50 + rank)
    ours = _torch_grads(args, modes)
    theirs = _jax_grads(args, modes)
    for name, a, b in zip(_NAMES, ours, theirs):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        _allclose_rel(_np(a), b, 2e-4, name)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_fused_block_grads_bf16_within_tolerance(rank):
    """bf16 policy with f32 primals: every grad comes back in f32, within
    5e-2 of the f32 reference, as the reference's own bf16 grads are."""
    args, modes = _block_args(rank, 60 + rank)
    ref32 = _jax_grads(args, modes)
    ours = _torch_grads(args, modes, PrecisionPolicy.from_name("bf16"))
    theirs = _jax_grads(args, modes, JPolicy.from_name("bf16"))
    for name, a, b, c in zip(_NAMES, ours, theirs, ref32):
        assert a.dtype == torch.float32, name
        _allclose_rel(_np(a), c, 5e-2, name)
        _allclose_rel(np.asarray(b, np.float32), c, 5e-2, name)


def test_bypass_grad_comes_back_through_the_transpose():
    """``apply_fno_block_nd`` hands the kernel wbᵀ of the stored [C_in,
    C_out] bypass weight; its grad reaches the stored layout transposed
    back, equal to the staged path's."""
    from repro_torch.core import spectral_conv as sc
    args, modes = _block_args(2, 70)
    x, wr, wi, wb, bias = (torch.from_numpy(a) for a in args)
    grads = {}
    for path in ("fused", "staged"):
        spec = {"wr": wr.clone(), "wi": wi.clone()}
        byp = {"w": wb.t().contiguous().requires_grad_(True),
               "b": bias.clone().requires_grad_(True)}
        y = sc.apply_fno_block_nd(spec, byp, x, modes, path=path)
        grads[path] = torch.autograd.grad(torch.sin(y).sum(),
                                          [byp["w"], byp["b"]])
    for a, b in zip(grads["fused"], grads["staged"]):
        assert a.shape == b.shape
        _allclose_rel(_np(a), _np(b), 2e-4)


def _backward_operands(rank, seed):
    args, modes = _block_args(rank, seed)
    spatial = _CASES[rank][0]
    rng = np.random.default_rng(seed + 1)
    gy = rng.normal(size=(2, 6) + spatial).astype(np.float32)
    return args, gy, modes


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_backward_plain_versions_match_reference_kernels(rank):
    """gz, dx and (dW, dW_b, dbias) of the plain versions against the
    reference's own kernel launches (interpret mode)."""
    (x, wr, wi, wb, bias), gy, modes = _backward_operands(rank, 80 + rank)
    spatial = x.shape[2:]
    pol = JPolicy()
    j = lambda a: jnp.asarray(a)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    mats = {k: tspec.operand_tensors(spatial, modes, "float32", "cpu", k)
            for k in ("forward", "adjoint", "wgrad")}

    gz = engine.fused_block_plain(t(x), t(wr), t(wi), t(wb),
                                  t(bias).reshape(-1, 1), mats["forward"],
                                  act="gelu_vjp", gy=t(gy))
    jgz = jops._fnond_fused(j(x), j(wr), j(wi), modes, 2, 8, 8, True, pol,
                            wb=j(wb), bias=j(bias), gy=j(gy),
                            act="gelu_vjp")
    _allclose_rel(_np(gz), jgz, 2e-4, "gz")

    dx = engine.fused_block_plain(gz, t(wr.T), t(wi.T), t(wb.T), None,
                                  mats["adjoint"], act="linear")
    jdx = jops._fnond_fused(jgz, j(wr.T), j(wi.T), modes, 2, 8, 8, True,
                            pol, adjoint=True, wb=j(wb.T))
    _allclose_rel(_np(dx), jdx, 2e-4, "dx")

    ours = engine.fused_wgrad_plain(t(x), gz, mats["wgrad"])
    theirs = jops._fnond_wgrad(j(x), jgz, modes, 2, 8, 8, True, False, pol,
                               with_bypass=True)
    for name, a, b in zip(_NAMES[1:], ours, theirs):
        _allclose_rel(_np(a).reshape(np.shape(b)), b, 2e-4, name)
    assert tuple(ours[3].shape) == (6, 1)


@pytest.mark.parametrize("spatial,modes", list(_CASES.values()) + [
    ((128, 128), (32, 32))])
def test_adjoint_and_wgrad_bundles_bit_equal(spatial, modes):
    pairs = [(tspec.fused_operand_mats(spatial, modes, adjoint=True),
              jspec.fused_operand_mats(spatial, modes, "float32", True)),
             (tspec.wgrad_operand_mats(spatial, modes),
              jspec.wgrad_operand_mats(spatial, modes, "float32"))]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs) == 4 * len(spatial)
        for a, b in zip(ours, theirs):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("n,k", [(16, 5), (9, 4), (64, 33)])
def test_adjoint_factories_bit_equal(n, k):
    pairs = [(tspec.rdft_adjoint_mats(n, k), jspec.rdft_adjoint_mats(n, k)),
             (tspec.irdft_adjoint_mats(n, k),
              jspec.irdft_adjoint_mats(n, k)),
             (tspec.cdft_adjoint_mats(n, k), jspec.cdft_adjoint_mats(n, k)),
             (tspec.cdft_adjoint_mats(n, k, True),
              jspec.cdft_adjoint_mats(n, k, True))]
    for ours, theirs in pairs:
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def test_operand_tensors_cached_per_kind():
    sp, m = _CASES[2]
    fwd = tspec.operand_tensors(sp, m, "float32", "cpu")
    adj = tspec.operand_tensors(sp, m, "float32", "cpu", "adjoint")
    wg = tspec.operand_tensors(sp, m, "float32", "cpu", "wgrad")
    assert fwd is tspec.operand_tensors(sp, m, "float32", "cpu", "forward")
    assert adj is not fwd and wg is not fwd
    assert tuple(adj[0].shape) == tuple(fwd[0].shape)  # [n_R, k_R]
    with pytest.raises(ValueError, match="kind"):
        tspec.operand_tensors(sp, m, "float32", "cpu", "transposed")


def test_function_launch_structure(monkeypatch):
    """Forward is one block-kernel call; backward is gz recompute, dx
    adjoint, wgrad — in that order, on detached tensors."""
    calls = []
    block, wgrad = engine.fused_block, engine.fused_wgrad

    def rec_block(*a, **kw):
        calls.append(kw.get("act", "gelu"))
        assert not any(t.requires_grad for t in a if torch.is_tensor(t))
        return block(*a, **kw)

    def rec_wgrad(*a, **kw):
        calls.append("wgrad")
        return wgrad(*a, **kw)

    monkeypatch.setattr(engine, "fused_block", rec_block)
    monkeypatch.setattr(engine, "fused_wgrad", rec_wgrad)
    args, modes = _block_args(1, 90)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = tops.fno_block_nd(*leaves, modes, path="fused")
    assert calls == ["gelu"]
    y.sum().backward()
    assert calls == ["gelu", "gelu_vjp", "linear", "wgrad"]
    assert all(t.grad is not None for t in leaves)


def test_fused_block_grads_keep_primal_dtypes():
    """bf16 primals get bf16 grads; the f32 weights beside them get f32."""
    args, modes = _block_args(2, 91)
    x = torch.from_numpy(args[0]).to(torch.bfloat16).requires_grad_(True)
    ws = [torch.from_numpy(a).requires_grad_(True) for a in args[1:]]
    y = tops.fno_block_nd(x, *ws, modes, path="fused",
                          policy=PrecisionPolicy.from_name("bf16"))
    assert y.dtype == torch.bfloat16
    grads = torch.autograd.grad(y.float().sum(), [x, *ws])
    assert grads[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in grads[1:])


def test_inference_calls_skip_the_function():
    """Without a gradient to track (serving), the Function records no graph
    node; with one, its backward is recorded. Both give the same output."""
    args, modes = _block_args(2, 92)
    plain = [torch.from_numpy(a) for a in args]
    assert tops.fno_block_nd(*plain, modes, path="fused").grad_fn is None
    leaves = [t.clone().requires_grad_(True) for t in plain]
    with torch.no_grad():
        y0 = tops.fno_block_nd(*leaves, modes, path="fused")
    assert y0.grad_fn is None
    y1 = tops.fno_block_nd(*leaves, modes, path="fused")
    assert type(y1.grad_fn).__name__ == "_FusedBlockBackward"
    torch.testing.assert_close(y0, y1.detach(), rtol=0, atol=0)
