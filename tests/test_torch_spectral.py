"""Port parity: DFT operand algebra, the torch.fft oracle and the staged
path of ``repro_torch`` against the JAX reference (CPU).

The operand bundles must be bit-equal to ``repro.core.spectral`` in f32
(and after the same bf16 rounding); ``ref_fnond`` and the staged spectral
layer must match the reference's ``ref``/``xla`` paths to the relative
2e-4 f32 contract of tests/test_fused_block.py, ranks 1–3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spectral as jspec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs.base import PrecisionPolicy
from repro_torch.core import spectral as tspec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

_CASES = {
    1: ((64,), (17,)),
    2: ((16, 32), (5, 9)),
    3: ((8, 8, 16), (3, 3, 5)),
}


def _allclose_rel(a, b, tol):
    """Tolerance scaled to the reference magnitude."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _layer_args(rank, weight_mode, seed, b=2, h=8, o=6):
    spatial, modes = _CASES[rank]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h) + spatial).astype(np.float32)
    wshape = (o, h) if weight_mode == "shared" else (o, h) + modes
    wr = (rng.normal(size=wshape) / h).astype(np.float32)
    wi = (rng.normal(size=wshape) / h).astype(np.float32)
    return (x, wr, wi), modes


@pytest.mark.parametrize("spatial,modes", list(_CASES.values()) + [
    ((256,), (64,)), ((128, 128), (32, 32)), ((64, 64, 64), (16, 16, 16))])
def test_operand_bundle_bit_equal(spatial, modes):
    """The odd test extents and the full-width fno1d/2d/3d bundles."""
    ours = tspec.fused_operand_mats(spatial, modes)
    theirs = jspec.fused_operand_mats(spatial, modes, "float32")
    assert len(ours) == len(theirs) == 4 * len(spatial)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_operand_tensors_bf16_round_like_reference(rank):
    """The device bundle at the bf16 spectral dtype rounds exactly as the
    reference's bf16 bundle does."""
    spatial, modes = _CASES[rank]
    ours = tspec.operand_tensors(spatial, modes, "bfloat16", "cpu")
    theirs = jspec.fused_operand_mats(spatial, modes, "bfloat16")
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.bfloat16 and a.is_contiguous()
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))


@pytest.mark.parametrize("n,k", [(16, 5), (32, 17), (64, 33), (9, 4)])
def test_factories_bit_equal(n, k):
    pairs = [(tspec.rdft_mats(n, k), jspec.rdft_mats(n, k)),
             (tspec.irdft_mats(n, k), jspec.irdft_mats(n, k)),
             (tspec.cdft_mats(n, k), jspec.cdft_mats(n, k)),
             (tspec.cdft_mats(n, k, True), jspec.cdft_mats(n, k, True))]
    for ours, theirs in pairs:
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def test_staged_transforms_match_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 4, 24)).astype(np.float32)
    xi = rng.normal(size=(3, 4, 24)).astype(np.float32)
    tx, txi = torch.from_numpy(x), torch.from_numpy(xi)
    jx, jxi = jnp.asarray(x), jnp.asarray(xi)
    for a, b in zip(tspec.truncated_rdft(tx, 7), jspec.truncated_rdft(jx, 7)):
        _allclose_rel(_np(a), b, 2e-4)
    for a, b in zip(tspec.truncated_cdft(tx, txi, 7),
                    jspec.truncated_cdft(jx, jxi, 7)):
        _allclose_rel(_np(a), b, 2e-4)
    zr, zi = tx[..., :7].contiguous(), txi[..., :7].contiguous()
    _allclose_rel(_np(tspec.padded_irdft(zr, zi, 24)),
                  jspec.padded_irdft(jx[..., :7], jxi[..., :7], 24), 2e-4)
    for a, b in zip(tspec.padded_icdft(zr, zi, 24),
                    jspec.padded_icdft(jx[..., :7], jxi[..., :7], 24)):
        _allclose_rel(_np(a), b, 2e-4)


@pytest.mark.parametrize("weight_mode", ["shared", "per_mode"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_ref_fnond_matches_reference(rank, weight_mode):
    args, modes = _layer_args(rank, weight_mode, 10 + rank)
    ours = tref.ref_fnond(*(torch.from_numpy(a) for a in args), modes)
    theirs = jref.ref_fnond(*(jnp.asarray(a) for a in args), modes)
    assert ours.dtype == torch.float32
    _allclose_rel(_np(ours), theirs, 2e-4)


@pytest.mark.parametrize("weight_mode", ["shared", "per_mode"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_staged_layer_matches_reference_xla(rank, weight_mode):
    args, modes = _layer_args(rank, weight_mode, 20 + rank)
    targs = [torch.from_numpy(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    ours = tops.spectral_layer_nd(*targs, modes, path="staged")
    theirs = jops._fnond_xla(*jargs, modes)
    _allclose_rel(_np(ours), theirs, 2e-4)
    # the two port oracles agree with each other too
    _allclose_rel(_np(ours), _np(tops.spectral_layer_nd(*targs, modes,
                                                        path="ref")), 2e-4)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_staged_layer_bf16_within_bf16_tolerance(rank):
    """bf16 policy: each side is held to the f32 reference within 2e-2."""
    args, modes = _layer_args(rank, "shared", 30 + rank)
    pol = PrecisionPolicy.from_name("bf16")
    targs = [torch.from_numpy(a) for a in args]
    ours = tops.spectral_layer_nd(*targs, modes, path="staged", policy=pol)
    assert ours.dtype == torch.bfloat16
    ref32 = jref.ref_fnond(*(jnp.asarray(a) for a in args), modes)
    _allclose_rel(_np(ours), ref32, 2e-2)
    from repro.configs.base import PrecisionPolicy as JPolicy
    theirs = jops._fnond_xla(*(jnp.asarray(a) for a in args), modes,
                             JPolicy.from_name("bf16"))
    _allclose_rel(np.asarray(theirs, np.float32), ref32, 2e-2)
