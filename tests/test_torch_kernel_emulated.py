"""The fused block kernel's CUDA source, run on the CPU.

``src/repro_torch/csrc/fused_block.cu`` is compiled with g++ against the
emulation headers in ``tests/cuda_emulation`` (one POSIX thread per CUDA
thread, real barriers for ``__syncthreads`` and the cluster barrier, one
shared-memory buffer per block that the cluster's other blocks map), loaded
through the same ``ctypes`` signature and launch plan as on the card, and
compared with the kernel's plain PyTorch version. This checks the kernel's
indexing, chunking, masking and cluster exchange at every rank without a
GPU; the card itself is checked by tests/test_torch_kernel_gpu.py and
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

# (spatial, modes, B, H, O): the odd extents of test_fused_block.py at ranks
# 1–3, and shapes whose chunks over s_1 are ragged in both directions.
CASES = [
    ((64,), (17,), 2, 8, 6),
    ((16, 32), (5, 9), 2, 8, 6),
    ((8, 8, 16), (3, 3, 5), 2, 8, 6),
    ((20, 256), (7, 40), 1, 8, 8),
    ((10, 16, 32), (5, 6, 9), 1, 4, 8),
    ((100,), (30,), 1, 3, 5),
    ((12, 20), (4, 6), 2, 16, 16),  # clusters of 16 (the batch fits)
    ((12, 20), (4, 6), 5, 16, 16),  # clusters of 8 (it does not)
]
EMULATED_MAX_CLUSTERS = 4  # cuda_emulation/cuda_runtime.h


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    out = tmp_path_factory.mktemp("emulated")
    src = (build.CSRC / "fused_block.cu").read_text()
    decl = "extern __shared__ float smem[];"
    assert src.count(decl) == 1
    cpp = out / "fused_block.cpp"
    cpp.write_text(src.replace(decl,
                               "float* smem = g_smem[blockIdx.x].data();"))
    lib = out / "libfused_block_emulated.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", "-include", "cuda_runtime.h",
         f"-I{EMULATION}", str(cpp), "-o", str(lib)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return build.load_block_library(lib)


def _inputs(spatial, b, h, o, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.tensor(sc * rng.normal(size=s),
                                         dtype=torch.float32)
    return [mk(b, h, *spatial), mk(o, h, sc=1.0 / h), mk(o, h, sc=1.0 / h),
            mk(o, h, sc=1.0 / h), mk(o, 1, sc=0.3)]


def _rel_err(y, ref) -> float:
    y, ref = y.float(), ref.float()
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_emulated_kernel_matches_plain(emulated, case, dtype):
    spatial, modes, b, h, o = case
    args = _inputs(spatial, b, h, o, seed=len(spatial) + h)
    ref = engine.fused_block_plain(
        *args, spectral.operand_tensors(spatial, modes, "float32", "cpu"))
    tdt = getattr(torch, dtype)
    targs = [a.to(tdt) for a in args]
    mats = spectral.operand_tensors(spatial, modes, dtype, "cpu")
    y = engine._launch(emulated, *targs, mats, spatial, modes, None)
    assert y.dtype == tdt and tuple(y.shape) == (b, o) + spatial
    assert bool(torch.isfinite(y).all())
    if dtype == "float32":
        assert _rel_err(y, ref) <= 2e-4
    else:  # bf16: against the f32 plain version, and at most a rounding
        assert _rel_err(y, ref) <= 2e-2  # step away from the bf16 one
        assert _rel_err(y, engine.fused_block_plain(*targs, mats)) <= 1e-2


def test_cluster_size_follows_the_card(emulated):
    """16-block clusters when the whole batch fits the card at once (the
    emulated card holds 4), else the portable 8; narrow layers stay
    smaller."""
    pick = lambda b, h: engine.pick_plan(emulated, 0, b, h, h, (12, 20),
                                         (4, 6))["cluster"]
    assert pick(1, 16) == 16 and pick(EMULATED_MAX_CLUSTERS, 64) == 16
    assert pick(EMULATED_MAX_CLUSTERS + 1, 64) == 8
    assert pick(1, 8) == 8 and pick(1, 6) == 4


def test_emulated_kernel_rejects_too_many_out_channels(emulated,
                                                       monkeypatch):
    """The C entry refuses a plan whose out slice exceeds its registers,
    and the wrapper raises with the error's name."""
    spatial, modes = (16,), (5,)
    args = _inputs(spatial, 1, 4, 4, seed=0)
    mats = spectral.operand_tensors(spatial, modes, "float32", "cpu")
    bad = dict(engine.launch_plan(4, 4, spatial, modes), os=9)
    monkeypatch.setattr(engine, "launch_plan", lambda *a: bad)
    with pytest.raises(RuntimeError, match="launch failed"):
        engine._launch(emulated, *args, mats, spatial, modes, None)
