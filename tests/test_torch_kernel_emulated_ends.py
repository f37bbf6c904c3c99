"""The block kernel's fused model ends, run on the CPU.

``src/repro_torch/csrc/fused_block.cu`` is compiled with g++ against the
emulation headers in ``tests/cuda_emulation`` (one POSIX thread per CUDA
thread, real barriers, one shared-memory buffer per block; see
tests/test_torch_kernel_emulated.py) and its ends launches — the lift
prologue, the projection epilogue and both in one launch — are held
against ``engine.fused_block_plain`` at ranks 1–3, shared and per-mode
weights, f32 and bf16, with the cluster forced to 2 and 4 blocks (the
lift, the lifted bypass and the projection exchange points across blocks,
and with 6 out channels on 4 blocks one block holds none), both chunks
forced short and ragged (the lift's rows_f, the inverse and projection's
rows_i), and the points a block takes of a piece (ep) forced to 3, so
every chunk has several pieces, the last one ragged and some blocks
without points. Two mutated copies must fail the same comparison: the
cluster barrier before the projection's gather dropped (a block reads
another's channels before they are written), and the lift's b2 dropped.
The card itself is checked by tests/test_torch_kernel_gpu.py and
chip_smoke.py.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import spectral
from repro_torch.kernels import build, engine

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"

# rank -> (spatial, modes, B, H, O, C_in, L, Lp, C_out, rows_f, rows_i):
# every chunk count ragged (64 = 3·20 + 4 = 2·24 + 16; 16 = 5·3 + 1;
# 8 = 2·3 + 2).
CASES = {
    1: ((64,), (17,), 2, 8, 6, 3, 12, 10, 2, 20, 24),
    2: ((16, 32), (5, 9), 2, 8, 6, 3, 16, 12, 1, 3, 3),
    3: ((8, 8, 16), (3, 3, 5), 2, 8, 6, 1, 8, 8, 1, 3, 3),
}
# The cluster barrier ahead of the projection's gather, and the lift's b2.
DROP_PROJ_SYNC = (
    "      cluster.sync();  // every block's activated channels are in its ys",
    "")
DROP_LIFT_B2 = ("tile_gemm<T, kBiasRound>(a.l2w, a.L, act, a.ep, a.H, np, "
                "a.L, a.l2b, h,",
                "tile_gemm<T, kStore>(a.l2w, a.L, act, a.ep, a.H, np, "
                "a.L, nullptr, h,")


def _compile(out: Path, mutation=None) -> Path:
    """Compile csrc/fused_block.cu for the CPU; `mutation` (old, new)
    replaces one exact piece of the source first."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    src = (build.CSRC / "fused_block.cu").read_text()
    if mutation is not None:
        assert src.count(mutation[0]) == 1, mutation[0]
        src = src.replace(*mutation)
    decl = "extern __shared__ float smem[];"
    assert src.count(decl) == 1
    cpp = out / "fused_block.cpp"
    cpp.write_text(src.replace(decl,
                               "float* smem = g_smem[blockIdx.x].data();"))
    lib = out / "libfused_block_emulated.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", "-include", "cuda_runtime.h",
         f"-I{EMULATION}", f"-I{build.CSRC}", str(cpp), "-o", str(lib)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return build.load_block_library(lib)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("emulated_ends"))


def _force(monkeypatch, cluster, rows_f, rows_i, ep=None):
    """Every block plan at clusters of `cluster` with `rows_f` and
    `rows_i` s_1 rows a chunk and `ep` points a block of each piece (fewer
    rows and points need less of the work area)."""
    def forced(lib, code, b, h, o, spatial, modes, per_mode=False,
               ends=None):
        plan = engine.launch_plan(h, o, spatial, modes, cluster, per_mode,
                                  ends)
        assert plan["cluster"] == cluster
        assert plan["rows_f"] >= rows_f and plan["rows_i"] >= rows_i
        assert plan["ep"] >= (ep or 1)
        return dict(plan, rows_f=rows_f, rows_i=rows_i,
                    ep=ep or plan["ep"])
    monkeypatch.setattr(engine, "pick_plan", forced)


def _inputs(rank, per_mode, seed):
    """x (the hidden input), x_in (the raw input), the block's operands
    and the two ends in the engine layout, f32."""
    spatial, modes, b, h, o, cin, lw, lp, cout = CASES[rank][:9]
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.tensor(sc * rng.normal(size=s),
                                         dtype=torch.float32)
    wshape = (o, h) + (tuple(modes) if per_mode else ())
    block = [mk(*wshape, sc=1.0 / h), mk(*wshape, sc=1.0 / h),
             mk(o, h, sc=1.0 / h), mk(o, 1, sc=0.3)]
    lift = (mk(lw, cin, sc=0.7), mk(lw, 1, sc=0.3), mk(h, lw, sc=lw ** -0.5),
            mk(h, 1, sc=0.3))
    proj = (mk(lp, o, sc=o ** -0.5), mk(lp, 1, sc=0.3),
            mk(cout, lp, sc=lp ** -0.5), mk(cout, 1, sc=0.3))
    return mk(b, h, *spatial), mk(b, cin, *spatial), block, lift, proj


def _ends(which, x, xin, lift, proj):
    """(input, ends kwargs) of one ends launch."""
    return {"lift": (xin, {"lift": lift}), "proj": (x, {"proj": proj}),
            "both": (xin, {"lift": lift, "proj": proj})}[which]


def _rel_err(y, ref) -> float:
    y, ref = y.float(), ref.float()
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def _run(lib, rank, which, dtype, per_mode=False, seed=0):
    """The emulated kernel's launch at `dtype` and the f32 plain version on
    the same inputs."""
    spatial, modes = CASES[rank][:2]
    x, xin, block, lift, proj = _inputs(rank, per_mode, seed)
    inp, ends = _ends(which, x, xin, lift, proj)
    m32 = spectral.operand_tensors(spatial, modes, "float32", "cpu")
    ref = engine.fused_block_plain(inp, *block[:2], *block[2:], m32, **ends)
    tdt = getattr(torch, dtype)
    cast = lambda t: t.to(tdt)
    ends_t = {k: tuple(cast(t) for t in v) for k, v in ends.items()}
    mats = spectral.operand_tensors(spatial, modes, dtype, "cpu")
    y = engine._launch(lib, cast(inp), *[cast(t) for t in block], mats,
                       spatial, modes, None, **ends_t)
    return y, ref


@pytest.mark.parametrize("cluster,ep", [(2, None), (4, None), (4, 3)],
                         ids=["cl2", "cl4", "cl4-ep3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["lift", "proj", "both"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_emulated_ends_match_plain(emulated, monkeypatch, rank, which,
                                   dtype, cluster, ep):
    """The lift, the projection and both, at ragged chunks and pieces on
    forced clusters: f32 within 2e-4 of the plain version, bf16 within
    2e-2 of the f32 plain version; the output has the model's channels."""
    _force(monkeypatch, cluster, *CASES[rank][9:], ep=ep)
    y, ref = _run(emulated, rank, which, dtype, seed=10 * rank + cluster)
    cout = CASES[rank][8] if which != "lift" else CASES[rank][4]
    assert y.shape == ref.shape == (CASES[rank][2], cout) + CASES[rank][0]
    assert y.dtype == getattr(torch, dtype) and bool(torch.isfinite(y).all())
    tol = 2e-4 if dtype == "float32" else 2e-2
    assert _rel_err(y, ref) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_emulated_ends_per_mode_weights(emulated, monkeypatch, rank, dtype):
    """Both ends around per-mode weights [O,H,k_1..k_R] (fno2d-large's
    layout), at the planner's own cluster and ragged chunks."""
    spatial, modes, b, h, o, cin, lw, lp, cout, rf, ri = CASES[rank]
    _force(monkeypatch, engine.launch_plan(
        h, o, spatial, modes, per_mode=True,
        ends=(cin, lw, lp, cout))["cluster"], rf, ri)
    y, ref = _run(emulated, rank, "both", dtype, per_mode=True, seed=rank)
    assert bool(torch.isfinite(y).all())
    assert _rel_err(y, ref) <= (2e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("mutation,which", [(DROP_PROJ_SYNC, "proj"),
                                            (DROP_LIFT_B2, "lift")],
                         ids=["proj_cluster_sync", "lift_b2"])
def test_emulated_ends_mutations_are_caught(tmp_path, monkeypatch, mutation,
                                            which):
    """A projection that gathers before every block has written its
    channels, or a lift without its b2, fails the comparison (NaN counts
    as failing)."""
    lib = _compile(tmp_path, mutation)
    _force(monkeypatch, 4, *CASES[2][9:], ep=3)
    y, ref = _run(lib, 2, which, "float32", seed=5)
    assert not _rel_err(y, ref) <= 2e-4
