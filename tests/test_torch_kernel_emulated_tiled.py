"""The block and wgrad kernels' tiled code (``kTiled``) run on the CPU.

``csrc/fused_block.cu`` and ``csrc/fused_wgrad.cu`` are compiled with g++
against ``tests/cuda_emulation`` (as tests/test_torch_kernel_emulated.py
compiles them) and launched at plans that pin both tiling axes through
``plan=`` (``FNOConfig.block_plan``'s pins): clusters of 2 blocks of 6
hidden channels at hidden 12, a hidden k-loop of 4 channels a block (chunks
of 8: the last one ragged, its second block empty) and 3 out tiles of 4
channels; the wgrad then takes 2 hidden tiles × 3 out tiles a sample, B=2,
so its batch reduction runs per tile (the block B=1: the batch is its grid
axis only). At ranks 1–3, at the smallest extents each:

* the block in every epilogue (gelu with wb and bias, gelu_vjp, the
  adjoint dx through the weights' transposed view emitted in f32, the bare
  spectral layer) and the wgrad with and without the bypass, against their
  plain versions (f32 within 2e-4, bf16 within 2e-2 of the f32 plain
  version); per-mode W at rank 2;
* at one shape a rank, against the reference's own tiling: its
  ``fused_fnond_call`` / ``fused_fnond_wgrad_call`` in interpret mode with
  out and hidden blocks of 4 (bo < O, bh < H), through its ops' padding;
* mutated copies that must fail: C overwritten instead of accumulated
  across the hidden chunks, an out tile's first channel off by one (the
  block), the wgrad's tiles sharing one ticket counter a rank.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PrecisionPolicy as JPolicy
from repro.kernels import ops as jops
from repro_torch.core import spectral
from repro_torch.kernels import build, engine

from test_torch_kernel_emulated import _caught, _compile, _inputs, _rel_err

B, H = 2, 12
PINS = (("cluster", 2), ("hc", 4), ("ot", 3))
# rank -> (spatial, modes)
CASES = {1: ((16,), (5,)), 2: ((8, 8), (3, 3)), 3: ((4, 4, 6), (2, 2, 3))}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated_tiled")
    return (build.load_block_library(_compile(out, "fused_block")),
            build.load_wgrad_library(_compile(out, "fused_wgrad")))


def _mats(spatial, modes, dtype):
    return {k: spectral.operand_tensors(spatial, modes, dtype, "cpu", k)
            for k in ("forward", "adjoint", "wgrad")}


def _block_runs(lib, args, gy, spatial, modes, dtype):
    """The block's four epilogues at the pinned tiled plan: name ->
    output."""
    x, wr, wi, wb, bias = args
    tdt, mats = getattr(torch, dtype), _mats(spatial, modes, dtype)
    t = lambda a: a.to(tdt).contiguous()
    launch = lambda *a, **kw: engine._launch(lib, *a, spatial, modes, None,
                                             plan=PINS, **kw)
    return {
        "gelu": launch(t(x), t(wr), t(wi), t(wb), t(bias), mats["forward"]),
        "gelu_vjp": launch(t(x), t(wr), t(wi), t(wb), t(bias),
                           mats["forward"], act="gelu_vjp", gy=t(gy)),
        "adjoint": launch(t(gy), t(wr).transpose(0, 1),
                          t(wi).transpose(0, 1), t(wb.t()), None,
                          mats["adjoint"], act="linear",
                          out_dtype=torch.float32, adjoint=True),
        "bare": launch(t(x), t(wr), t(wi), None, None, mats["forward"],
                       act="linear"),
    }


def _block_refs(args, gy, m32):
    x, wr, wi, wb, bias = args
    sw = lambda w: w.transpose(0, 1).contiguous()
    return {
        "gelu": engine.fused_block_plain(x, wr, wi, wb, bias, m32["forward"]),
        "gelu_vjp": engine.fused_block_plain(x, wr, wi, wb, bias,
                                             m32["forward"], act="gelu_vjp",
                                             gy=gy),
        "adjoint": engine.fused_block_plain(gy, sw(wr), sw(wi), sw(wb), None,
                                            m32["adjoint"], act="linear"),
        "bare": engine.fused_block_plain(x, wr, wi, None, None,
                                         m32["forward"], act="linear"),
    }


def _case(rank, seed, per_mode=False, b=B):
    spatial, modes = CASES[rank]
    x, wr, wi, wb, bias = _inputs(spatial, b, H, H, seed)
    if per_mode:
        gen = torch.Generator().manual_seed(seed)
        wr, wi = (torch.randn((H, H) + modes, generator=gen) / H
                  for _ in range(2))
    gy = torch.randn((b, H) + spatial,
                     generator=torch.Generator().manual_seed(seed + 1))
    return spatial, modes, (x, wr, wi, wb, bias), gy


def test_the_pins_reach_both_tiling_axes():
    """The pinned plans hold a ragged hidden k-loop and 3 out tiles, the
    wgrad 2 hidden tiles."""
    for spatial, modes in CASES.values():
        block = engine.launch_plan(H, H, spatial, modes, hc=4, ot=3,
                                   max_cluster=2)
        wgrad = engine.wgrad_plan(H, H, spatial, modes, hc=4, ot=3,
                                  max_cluster=2)
        for p in (block, wgrad):
            assert (p["cluster"], p["hs"], p["os"], p["hc"], p["ot"]) == (
                2, 6, 2, 4, 3)
        assert H % (2 * 4) != 0 and wgrad["ht"] == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_emulated_tiled_block_matches_plain(libs, rank, dtype):
    spatial, modes, args, gy = _case(rank, 60 + rank, b=1)
    ours = _block_runs(libs[0], args, gy, spatial, modes, dtype)
    refs = _block_refs(args, gy, _mats(spatial, modes, "float32"))
    tol = 2e-4 if dtype == "float32" else 2e-2
    for name, y in ours.items():
        assert tuple(y.shape) == (1, H) + spatial, name
        assert bool(torch.isfinite(y).all()), name
        assert _rel_err(y, refs[name]) <= tol, (name, _rel_err(y, refs[name]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_emulated_tiled_wgrad_matches_plain(libs, rank, dtype):
    spatial, modes, (x, *_), gz = _case(rank, 70 + rank)
    tdt = getattr(torch, dtype)
    mats = _mats(spatial, modes, dtype)["wgrad"]
    m32 = _mats(spatial, modes, "float32")["wgrad"]
    tol = 2e-4 if dtype == "float32" else 2e-2
    for bypass in (True, False):
        outs = engine._launch_wgrad(libs[1], x.to(tdt), gz.to(tdt), mats,
                                    spatial, modes, None,
                                    with_bypass=bypass, plan=PINS)
        refs = engine.fused_wgrad_plain(x, gz, m32, with_bypass=bypass)
        assert len(outs) == len(refs) == (4 if bypass else 2)
        for i, (a, r) in enumerate(zip(outs, refs)):
            assert a.shape == r.shape and bool(torch.isfinite(a).all())
            assert _rel_err(a, r) <= tol, (bypass, i, _rel_err(a, r))


def test_emulated_tiled_per_mode_matches_plain(libs):
    """Per-mode W [O,H,k_1,k_2]: the block's forward (W streamed from
    device memory per out tile) and the per-mode wgrad (each tile's spectra
    in its own workspace slot, its batch reduction per tile)."""
    spatial, modes, args, gz = _case(2, 80, per_mode=True)
    x, wr, wi, wb, bias = args
    mats = _mats(spatial, modes, "float32")
    y = engine._launch(libs[0], x, wr, wi, wb, bias, mats["forward"],
                       spatial, modes, None, plan=PINS)
    ref = engine.fused_block_plain(x, wr, wi, wb, bias, mats["forward"])
    assert _rel_err(y, ref) <= 2e-4
    for bypass in (True, False):
        outs = engine._launch_wgrad(libs[1], x, gz, mats["wgrad"], spatial,
                                    modes, None, per_mode=True,
                                    with_bypass=bypass, plan=PINS)
        refs = engine.fused_wgrad_plain(x, gz, mats["wgrad"], per_mode=True,
                                        with_bypass=bypass)
        for a, r in zip(outs, refs):
            assert a.shape == r.shape and _rel_err(a, r) <= 2e-4


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_emulated_tiled_kernels_match_the_reference_tiling(libs, rank):
    """The reference's kernels tile the same way (grid o/bo, h/bh with
    out and hidden blocks of 4, its hidden axis the k-loop): its block
    forward and wgrad in interpret mode against the emulated tiled kernels,
    f32 within 2e-4."""
    spatial, modes, (x, wr, wi, wb, bias), gy = _case(rank, 90 + rank)
    j = lambda a: jnp.asarray(a.numpy())
    mats = _mats(spatial, modes, "float32")
    y = engine._launch(libs[0], x, wr, wi, wb, bias, mats["forward"],
                       spatial, modes, None, plan=PINS)
    jy = jops._fnond_fused(j(x), j(wr), j(wi), modes, B, 4, 4, True,
                           JPolicy(), wb=j(wb), bias=j(bias)[:, 0],
                           act="gelu")
    assert _rel_err(y, torch.from_numpy(np.asarray(jy))) <= 2e-4
    dw = engine._launch_wgrad(libs[1], x, gy, mats["wgrad"], spatial, modes,
                              None, plan=PINS)
    jdw = jops._fnond_wgrad(j(x), j(gy), modes, B, 4, 4, True, False,
                            JPolicy(), with_bypass=True)
    for a, r in zip(dw, jdw):
        r = torch.from_numpy(np.asarray(r)).reshape(a.shape)
        assert _rel_err(a, r) <= 2e-4


# (kernel, exact source piece, its mutation): C overwritten instead of
# accumulated across the hidden chunks; an out tile's first channel off by
# one; the wgrad's tiles sharing one ticket counter a rank.
TILED_MUTATIONS = {
    "c_overwritten": ("fused_block",
                      "const bool acc = j > 0 && o < os;",
                      "const bool acc = false;"),
    "out_offset": ("fused_block",
                   "const int ob = static_cast<int>(blockIdx.z) * cl * os;",
                   "const int ob = static_cast<int>(blockIdx.z) * cl * os"
                   " + 1;"),
    "shared_tickets": ("fused_wgrad", "(kTiled ? z * cl + rank : rank)",
                       "(rank)"),
}


@pytest.mark.parametrize("mutation", list(TILED_MUTATIONS))
def test_emulated_tiled_mutations_are_caught(tmp_path, mutation):
    """Each mutation fails the comparison that the unmutated kernels pass
    (rank 2, f32)."""
    name, old, new = TILED_MUTATIONS[mutation]
    path = _compile(tmp_path, name, mutation=(old, new))
    spatial, modes, args, gy = _case(2, 62)
    m32 = _mats(spatial, modes, "float32")
    if name == "fused_block":
        lib = build.load_block_library(path)
        y = engine._launch(lib, *args, m32["forward"], spatial, modes, None,
                           plan=PINS)
        ref = engine.fused_block_plain(*args, m32["forward"])
        assert _caught([y], [ref], 2e-4)
    else:
        lib = build.load_wgrad_library(path)
        x = args[0]
        outs = engine._launch_wgrad(lib, x, gy, m32["wgrad"], spatial,
                                    modes, None, plan=PINS)
        assert _caught(outs, engine.fused_wgrad_plain(x, gy, m32["wgrad"]),
                       2e-4)
