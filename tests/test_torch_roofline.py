"""The port's roofline (``repro_torch.roofline``) against the reference's.

``fno_model_flops`` and ``fno_model_bytes`` equal the reference's
(``repro/roofline/analysis.py``) on every preset, full width and reduced,
f32 and bf16, both variants, training and serving, whole-block fusion on
and off. The per-launch bounds ``chip_smoke.py`` prints moved into
``roofline.analysis`` unchanged: they reproduce the bound column of the
kernel table (PERF.md §6, rows 1a, 3 and 7), and ``chip_smoke.py`` reads
them (and the H100's rates) from there. The tuning key's first six
segments are the reference's.
"""
import importlib.util
import os

import pytest

from repro import configs as jconfigs
from repro.configs.fno import with_fuse_block as jwith_fuse_block
from repro.configs.fno import with_precision as jwith_precision
from repro.roofline import analysis as janalysis
from repro.tuning import plans as jplans
from repro_torch import configs as tconfigs
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import hw
from repro_torch.tuning import plans as tplans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("fno1d", "fno2d", "fno2d-large", "fno3d")


def _cfgs(arch, reduced, dtype, fuse):
    j = jwith_fuse_block(jwith_precision(
        jconfigs.get_config(arch, reduced=reduced), dtype), fuse)
    t = tconfigs.with_fuse_block(tconfigs.with_precision(
        tconfigs.get_config(arch, reduced=reduced), dtype), fuse)
    return j, t


@pytest.mark.parametrize("fuse", [True, False], ids=["block", "staged"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "serve"])
@pytest.mark.parametrize("variant", ["full", "partial"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_counts_equal_the_references(arch, reduced, dtype, variant,
                                           training, fuse):
    j, t = _cfgs(arch, reduced, dtype, fuse)
    assert t.param_count() == j.param_count()
    assert tanalysis.fno_model_flops(t, 8, training=training) == \
        janalysis.fno_model_flops(j, 8, training=training)
    assert tanalysis.fno_model_bytes(
        t, 8, variant=variant, training=training) == \
        janalysis.fno_model_bytes(j, 8, variant=variant, training=training)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4), (4, 1)])
def test_collective_bytes_and_roofline_terms(dp, tp):
    """The collective bytes are the reference's; the Roofline's terms are
    the counts over the H100's rates, the bound their largest."""
    j, t = _cfgs("fno2d", False, "bf16", True)
    for scattered in (True, False):
        assert tanalysis.fno_collective_bytes(
            t, dp, tp, scattered=scattered) == \
            janalysis.fno_collective_bytes(j, dp, tp, scattered=scattered)
    r = tanalysis.fno_roofline(t, 8, training=True, dp=dp, tp=tp)
    assert r.chips == dp * tp
    assert r.t_compute == pytest.approx(
        janalysis.fno_model_flops(j, 8) / (dp * tp) / hw.PEAK_BF16_FLOPS)
    assert r.t_memory == pytest.approx(
        janalysis.fno_model_bytes(j, 8) / (dp * tp) / hw.HBM_BW)
    coll = janalysis.fno_collective_bytes(j, dp, tp, batch=8)["total"]
    assert r.t_collective == pytest.approx(coll / hw.NVLINK_BW)
    assert r.t_bound == max(r.t_compute, r.t_memory, r.t_collective)
    assert r.share(2 * r.t_bound) == pytest.approx(0.5)


def test_h100_constants():
    """The published H100 SXM rates at 700 W, f32 bounded at the faster of
    3xTF32 (495/3 TFLOP/s) and the CUDA cores (67), and the block's shared
    memory the planners hold every launch to."""
    assert hw.POWER_LIMIT_W == 700.0
    assert hw.PEAK_3XTF32_FLOPS == hw.PEAK_TF32_FLOPS / 3 == 165e12
    assert hw.PEAK_F32_FLOPS == 165e12 and hw.PEAK_BF16_FLOPS == 989e12
    assert hw.PEAK_FFMA_FLOPS == 67e12 and hw.HBM_BW == 3.35e12
    assert hw.HBM_BYTES == 80 * 2 ** 30 and hw.NVLINK_BW == 450e9
    assert hw.SMEM_PER_BLOCK == 232448
    assert hw.peak_flops("bf16") == hw.peak_flops("bfloat16") == 989e12
    from repro_torch.kernels import engine
    assert engine._SMEM_LIMIT == hw.SMEM_PER_BLOCK


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_reads_the_roofline_package():
    """chip_smoke.py keeps no copy of the rates or the bounds."""
    cs = _chip_smoke()
    for name in ("bound_parts", "bound_ms", "cgemm_bound_parts",
                 "cgemm_bound", "block_flops", "dense_dft_flops",
                 "PARTIAL_LAUNCHES"):
        assert getattr(cs, name) is getattr(tanalysis, name), name
    assert cs.PEAK_BYTES == hw.HBM_BW and cs.PEAK_F32_FLOPS == \
        hw.PEAK_F32_FLOPS and cs.PEAK_BF16_FLOPS == hw.PEAK_BF16_FLOPS
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "def bound_parts" not in src and "= 3.35e12" not in src


# (kind, B, H, O, spatial, modes, per_mode, (f32 ms, bf16 ms)) of the
# kernel table's bound column (PERF.md §6), 4 decimals.
TABLE_BOUNDS = [
    ("block_fwd", 8, 64, 64, (128, 128), (32, 32), False, (0.0201, 0.0100)),
    ("block_fwd", 8, 32, 32, (64, 64, 64), (16, 16, 16), False,
     (0.1603, 0.0801)),
    ("core", 8, 64, 64, (128, 128), (32, 32), False, (0.0100, 0.0050)),
    ("core", 8, 128, 128, (128, 128), (32, 32), True, (0.0601, 0.0301)),
    ("core", 8, 32, 32, (64, 64, 64), (16, 16, 16), False, (0.0200, 0.0100)),
]


@pytest.mark.parametrize("row", TABLE_BOUNDS,
                         ids=lambda r: f"{r[0]}-h{r[2]}-{len(r[4])}d")
def test_bounds_reproduce_the_kernel_table(row):
    kind, b, h, o, spatial, modes, per_mode, want = row
    for (eb, peak), w in zip(((4, hw.PEAK_F32_FLOPS),
                              (2, hw.PEAK_BF16_FLOPS)), want):
        ms, by = tanalysis.bound_ms(kind, b, h, o, spatial, modes, eb, peak,
                                    per_mode)
        assert round(ms, 4) == w and by == "bytes"


def test_cgemm_bounds_reproduce_row_7():
    """(64,64,8192): 0.0025 / 0.0013 ms by bytes; (128,128,8192): 0.0065
    by operations in f32, 0.0025 by bytes in bf16."""
    ms, by = tanalysis.cgemm_bound(64, 64, 8192, 4, hw.PEAK_F32_FLOPS)
    assert (round(ms, 4), by) == (0.0025, "bytes")
    ms, by = tanalysis.cgemm_bound(64, 64, 8192, 2, hw.PEAK_BF16_FLOPS)
    assert (round(ms, 4), by) == (0.0013, "bytes")
    ms, by = tanalysis.cgemm_bound(128, 128, 8192, 4, hw.PEAK_F32_FLOPS)
    assert (round(ms, 4), by) == (0.0065, "operations")
    ms, by = tanalysis.cgemm_bound(128, 128, 8192, 2, hw.PEAK_BF16_FLOPS)
    assert (round(ms, 4), by) == (0.0025, "bytes")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_tuning_keys_extend_the_references(arch, reduced):
    """shape_class, the dtype tag and the first six key segments are the
    reference's for the same workload; the seventh is the batch bucket."""
    j, _ = _cfgs(arch, reduced, "f32", True)
    klass = tplans.shape_class(j.hidden, j.hidden, j.spatial, j.modes)
    assert klass == jplans.shape_class(j.hidden, j.hidden, j.spatial,
                                       j.modes)
    assert tplans.dtype_tag("bfloat16") == jplans.dtype_tag("bfloat16")
    for launch in tplans.LAUNCH_KINDS:
        for b, bucket in ((1, 1), (3, 4), (8, 8)):
            key = tplans.workload_key(launch, "float32", b, j.hidden,
                                      j.hidden, j.spatial, j.modes,
                                      j.weight_mode == "per_mode")
            ref = jplans.plan_key(
                j.ndim, klass, "per_mode" if j.weight_mode == "per_mode"
                else "shared", "f32",
                "block_fwd" if j.ndim == 1 and launch == "core" else launch)
            assert key == f"{ref}/b{bucket}"
    assert tplans.workload_key("block_fwd", "float32", 9, j.hidden,
                               j.hidden, j.spatial, j.modes, False) is None


def test_model_flops_count_the_truncated_stages():
    """fno2d's forward by hand: the rDFT, cDFT, CGEMM, icDFT and irDFT
    stages, the bypass and epilogue a layer, the lift and projection."""
    _, t = _cfgs("fno2d", False, "f32", True)
    h, (x, y), (kx, ky) = t.hidden, t.spatial, t.modes
    spectral = (4 * h * x * y * ky + 8 * h * ky * x * kx
                + 8 * kx * ky * h * h + 8 * h * ky * kx * x
                + 4 * h * x * ky * y)
    layer = spectral + 2 * x * y * h * h + 12 * x * y * h
    ends = 2 * x * y * (3 * 128 + 128 * h) + 2 * x * y * (h * 128 + 128)
    want = 8 * (t.num_layers * layer + ends)
    assert tanalysis.fno_model_flops(t, 8, training=False) == want
    assert tanalysis.fno_model_flops(t, 8) == 3 * want
