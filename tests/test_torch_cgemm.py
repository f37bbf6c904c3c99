"""Port parity: the complex matrix product ``ops.cgemm`` of ``repro_torch``
against the reference's ``repro.kernels.ops.cgemm(path="pallas")`` (its
Pallas kernel in interpret mode, as its own tests run it) at the
reference's five cases — square, ragged, tall-skinny, just past the block
edges — in f32 and bf16 with the reference's tolerances
(``tests/test_kernels_cgemm.py``). On the CPU the fused path runs the
kernel's plain version; ``csrc/cgemm.cu`` itself is held against that
plain version under emulation (tests/test_torch_kernel_emulated_spectral.py)
and on the card (tests/test_torch_kernel_gpu.py, chip_smoke.py).
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import cgemm as cgemm_k
from repro_torch.kernels import engine
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as ref_k

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [
    (32, 16, 24),
    (128, 128, 128),
    (37, 19, 23),  # ragged (the reference pads; the port masks)
    (256, 8, 64),  # tall-skinny, the paper's FNO regime
    (130, 257, 129),  # just past block boundaries
]
_TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
        "bfloat16": dict(rtol=0.05, atol=0.5)}


def _planes(m, k, n):
    rng = np.random.default_rng(m * 31 + n)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return mk(m, k), mk(m, k), mk(k, n), mk(k, n)


@pytest.mark.parametrize("m,k,n", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cgemm_matches_reference(m, k, n, dtype):
    planes = _planes(m, k, n)
    theirs = jops.cgemm(*(jnp.asarray(a, getattr(jnp, dtype))
                          for a in planes), path="pallas")
    tdt = getattr(torch, dtype)
    ins = [torch.from_numpy(a).to(tdt) for a in planes]
    ours = tops.cgemm(*ins, path="fused")
    ref = ref_k.ref_cgemm(*ins)
    for a, r, f32 in zip(ours, theirs, ref):
        assert a.dtype == tdt and tuple(a.shape) == (m, n)
        a = a.float().numpy()
        np.testing.assert_allclose(a, np.asarray(r, np.float32),
                                   **_TOL[dtype])
        np.testing.assert_allclose(a, f32.numpy(), **_TOL[dtype])


def test_cgemm_oracle_paths_and_contract():
    """"ref"/"staged" are the four f32 products; the wrapper takes no
    mismatched or non-2D planes, and on the CPU launches nothing."""
    planes = [torch.from_numpy(a) for a in _planes(37, 19, 23)]
    ref = ref_k.ref_cgemm(*planes)
    for path in ("ref", "staged"):
        for a, r in zip(tops.cgemm(*planes, path=path), ref):
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, r, rtol=0, atol=0)
    half = [p.to(torch.bfloat16) for p in planes]
    for a, r in zip(tops.cgemm(*half, path="ref"), ref_k.ref_cgemm(*half)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, r)
    before = sum(engine.LAUNCHES.values())
    cr, ci = cgemm_k.cgemm(*planes)
    assert sum(engine.LAUNCHES.values()) == before
    torch.testing.assert_close(cr, ref[0], rtol=1e-5, atol=1e-5)
    ar, ai, br, bi = planes
    with pytest.raises(ValueError, match="bi must be"):
        cgemm_k.cgemm(ar, ai, br, bi[:5])
    with pytest.raises(ValueError, match=r"A \[M,K\]"):
        cgemm_k.cgemm(ar[None], ai, br, bi)
    with pytest.raises(TypeError, match="share"):
        cgemm_k.cgemm(ar, ai, br, bi.double())
    with pytest.raises(ValueError, match="unknown path"):
        tops.cgemm(*planes, path="pallas")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_cgemm_bounds():
    """(64,64,8192): 0.268 GFLOP (8 per complex multiply-add) takes 4.0 µs
    at 67 TFLOP/s, its 8.4 MB of planes 2.5 µs at 3.35 TB/s;
    (128,128,8192): 1.07 GFLOP, 16.0 µs, 16.9 MB. Both are operation-bound
    in f32; in bf16 the tensor-core rate leaves them byte-bound."""
    cs = _chip_smoke()
    t_bytes, t_ops = cs.cgemm_bound_parts(64, 64, 8192, 4,
                                          cs.PEAK_F32_FLOPS)
    assert 8 * 64 * 64 * 8192 == 268_435_456
    assert round(1e3 * t_ops, 1) == 4.0
    nbytes = 4 * 2 * (64 * 64 + 64 * 8192 + 64 * 8192)  # A, B, C planes
    assert nbytes == 8_421_376
    assert t_bytes == pytest.approx(1e3 * nbytes / cs.PEAK_BYTES)
    assert cs.cgemm_bound(64, 64, 8192, 4, cs.PEAK_F32_FLOPS) == \
        (t_ops, "operations")
    t_bytes, t_ops = cs.cgemm_bound_parts(128, 128, 8192, 4,
                                          cs.PEAK_F32_FLOPS)
    assert round(1e3 * t_ops, 1) == 16.0
    assert t_bytes == pytest.approx(1e3 * 16_908_288 / cs.PEAK_BYTES)
    assert cs.cgemm_bound(128, 128, 8192, 2, cs.PEAK_BF16_FLOPS)[1] == \
        "bytes"
