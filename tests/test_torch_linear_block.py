"""Port parity: the linear FNO block — the TP-partial mode of the block
kernel (``act="linear"``: the pre-activation spectral(x) + x·W_bᵀ + bias
with no GELU, emitted at ``out_dtype``) — of ``repro_torch`` against the
JAX reference's ``ops.fno_block_nd(path="pallas", act="linear",
out_dtype="float32")``, its Pallas kernels in interpret mode as its own
tests run them: forward and every grad at ranks 1–3, shared and per-mode
weights, both variants, f32 and bf16; the emitted dtype; and the launch
structure (one linear block launch forward, or rdft → core → irdft and the
tail; dx and wgrad backward, no gz recompute).

Tolerances (DESIGN.md §4): f32 within 2e-4 of the reference, bf16 forward
within 2e-2 and bf16 grads within 5e-2 of the f32 reference. On the CPU the
wrappers run the kernels' plain versions; the CUDA kernel's linear
epilogue with a bias and f32 output is held against its plain version
under emulation (tests/test_torch_kernel_emulated_fno3d.py) and on the
card (tests/test_torch_kernel_gpu.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PrecisionPolicy as JPolicy
from repro.kernels import ops as jops
from repro_torch.configs.base import PrecisionPolicy
from repro_torch.core import spectral as tspec
from repro_torch.kernels import dft, engine
from repro_torch.kernels import ops as tops

_CASES = {
    1: ((64,), (17,)),
    2: ((16, 32), (5, 9)),
    3: ((8, 8, 16), (3, 3, 5)),
}
_NAMES = ("dx", "dwr", "dwi", "dwb", "dbias")
F32_TOL, BF16_TOL, BF16_GRAD_TOL = 2e-4, 2e-2, 5e-2
# (rank, variant): rank 1's partial variant is the bare layer and the tail.
_BLOCKS = [(r, v) for r in (1, 2, 3) for v in ("full", "partial")]


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


def _block_args(rank, seed, per_mode, b=2, h=8, o=6):
    """x, wr, wi (shared [O,H] or per-mode [O,H,k…]), wb, bias as numpy
    f32."""
    spatial, modes = _CASES[rank]
    rng = np.random.default_rng(seed)
    w = (o, h) + (modes if per_mode else ())
    mk = lambda *s, sc=1.0: (sc * rng.normal(size=s)).astype(np.float32)
    return (mk(b, h, *spatial), mk(*w, sc=1.0 / h), mk(*w, sc=1.0 / h),
            mk(o, h, sc=1.0 / h), mk(o, sc=0.3)), modes


def _torch_block(args, modes, variant, policy=None):
    """The port's linear block (f32 out) and the grads of Σ sin(y)."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = tops.fno_block_nd(*leaves, modes, path="fused", variant=variant,
                          policy=policy, act="linear",
                          out_dtype=torch.float32)
    return y, torch.autograd.grad(torch.sin(y).sum(), leaves)


@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("rank,variant", _BLOCKS,
                         ids=[f"r{r}-{v}" for r, v in _BLOCKS])
def test_linear_block_matches_reference(rank, variant, per_mode):
    """Forward and every grad of Σ sin(y) against the reference's pallas
    linear block (f32 out): f32 within 2e-4 (forward of the output's
    magnitude, grads of each leaf's own); under bf16 (f32 master weights,
    bf16 compute) the output is still f32, within 2e-2, and the grads,
    back at f32, within 5e-2 of the f32 reference."""
    args, modes = _block_args(rank, 10 * rank + per_mode, per_mode)
    fn = lambda *a: jops.fno_block_nd(*a, modes, path="pallas",
                                      variant=variant, act="linear",
                                      out_dtype="float32")
    jy, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    jgrads = vjp(jnp.cos(jy))
    y, grads = _torch_block(args, modes, variant)
    assert y.dtype == torch.float32 and tuple(y.shape) == jy.shape
    _allclose_rel(_np(y), jy, F32_TOL, "y")
    for name, a, r in zip(_NAMES, grads, jgrads):
        assert a.dtype == torch.float32 and tuple(a.shape) == r.shape, name
        _leaf_close(_np(a), r, F32_TOL, name)
    y16, grads16 = _torch_block(args, modes, variant,
                                PrecisionPolicy.from_name("bf16"))
    assert y16.dtype == torch.float32  # the accumulator dtype, not bf16
    _allclose_rel(_np(y16), jy, BF16_TOL, "y bf16")
    for name, a, r in zip(_NAMES, grads16, jgrads):
        assert a.dtype == torch.float32, name
        _leaf_close(_np(a), r, BF16_GRAD_TOL, name)


def test_linear_block_emits_f32_under_bf16_like_the_reference():
    """Under the bf16 policy the reference's linear block emits f32 when
    asked; the port does too, and its default is the compute dtype."""
    args, modes = _block_args(2, 5, False)
    jpol, tpol = JPolicy.from_name("bf16"), PrecisionPolicy.from_name("bf16")
    theirs = jops.fno_block_nd(*(jnp.asarray(a) for a in args), modes,
                               path="pallas", policy=jpol, act="linear",
                               out_dtype="float32")
    targs = [torch.from_numpy(a) for a in args]
    ours = tops.fno_block_nd(*targs, modes, policy=tpol, act="linear",
                             out_dtype=torch.float32)
    assert theirs.dtype == jnp.float32 and ours.dtype == torch.float32
    default = tops.fno_block_nd(*targs, modes, policy=tpol, act="linear")
    assert default.dtype == torch.bfloat16
    ref32 = jops.fno_block_nd(*(jnp.asarray(a) for a in args), modes,
                              path="xla", act="linear")
    _allclose_rel(_np(ours), ref32, BF16_TOL)
    _allclose_rel(np.asarray(theirs, np.float32), ref32, BF16_TOL)


@pytest.mark.parametrize("rank,variant", _BLOCKS,
                         ids=[f"r{r}-{v}" for r, v in _BLOCKS])
def test_linear_block_launch_structure(monkeypatch, rank, variant):
    """Forward: one linear block launch (full) or rdft, core, irdft (rank
    1: the bare layer) and the tail; backward: dx through the adjoint
    bundle and the wgrad with its bypass — never a gz recompute. Each call
    is counted as ``engine.launch_kind`` names what the caller asked."""
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
    spy(engine, "fused_block", lambda a, kw: engine.launch_kind(
        a[3], kw.get("act", "gelu"), kw.get("adjoint", False)))
    spy(engine, "fused_wgrad", lambda a, kw: (
        "wgrad" if kw.get("with_bypass", True) else "spectral_wgrad"))
    args, modes = _block_args(rank, 40 + rank, False)
    y, _ = _torch_block(args, modes, variant)
    if variant == "full":
        fwd = ["block_linear"]
    else:
        fwd = ["spectral_fwd"] if rank == 1 else ["rdft", "core", "irdft"]
    assert calls == fwd + ["dx_adjoint", "wgrad"]
    if variant == "full":
        assert tuple(calls) == engine.LINEAR_KINDS


def test_launch_kinds_name_what_was_asked():
    """The block kernel's launch kinds: the caller's act and adjoint flag
    name them, never the operands alone (a bypassed linear launch is the
    linear block unless adjoint=True marks it a dx)."""
    wb = torch.zeros(2, 2)
    assert engine.launch_kind(wb, "gelu", False) == "block_fwd"
    assert engine.launch_kind(wb, "gelu_vjp", False) == "gz_recompute"
    assert engine.launch_kind(wb, "linear", False) == "block_linear"
    assert engine.launch_kind(wb, "linear", True) == "dx_adjoint"
    assert engine.launch_kind(None, "linear", False) == "spectral_fwd"
    assert engine.launch_kind(None, "linear", True) == "spectral_dx"
    assert engine.KINDS == ("block_fwd", "gz_recompute", "dx_adjoint",
                            "wgrad")


def test_linear_block_contract():
    args, modes = _block_args(2, 7, False)
    targs = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="act"):
        tops.fno_block_nd(*targs, modes, act="relu")
    # The oracles compute the same pre-activation (at the compute dtype).
    fused = tops.fno_block_nd(*targs, modes, act="linear")
    for path in ("ref", "staged"):
        _allclose_rel(_np(tops.fno_block_nd(*targs, modes, path=path,
                                            act="linear")),
                      _np(fused), F32_TOL, path)
    # adjoint=True marks a dx: the linear epilogue only.
    x, wr, wi, wb, bias = targs
    mats = tspec.operand_tensors(x.shape[2:], modes, "float32", "cpu")
    with pytest.raises(ValueError, match="adjoint=True"):
        engine.fused_block(x, wr, wi, wb, bias.reshape(-1, 1), mats,
                           adjoint=True)
