"""The block and wgrad kernel sources at fno3d's chunking, and the block
kernel's linear (TP-partial) epilogue, run on the CPU.

fno3d at full width (hidden 32, 64³, modes 16³) fits a block's shared
memory only with 3 s_1 rows per forward-chain chunk (``engine._fit_rows``),
not the register-filling 8, and then the last chunk of 64 rows is ragged.
``src/repro_torch/csrc/fused_block.cu`` and ``fused_wgrad.cu`` are
compiled with g++ against the emulation headers in ``tests/cuda_emulation``
(one POSIX thread per CUDA thread, real barriers, one shared-memory buffer
per block; see tests/test_torch_kernel_emulated.py) and every launch that
runs a forward chain (``fno::forward_chain``; the wgrad's tensor-core
``chain::forward_chain``) is held against its plain PyTorch version at a
forced chunk of 2 and of 3 rows at rank 3: the block forward, gz
recompute, dx through the adjoint bundle, the bare layer's forward and
dx, and the wgrad with and without its bypass — at odd extents and at
fno3d's channel slicing (clusters of 16, two hidden and two out channels
a block). A copy of ``fno_common.cuh`` that drops the chunk's offset into
the s_1 operand must fail the same comparison. Then the linear epilogue
with wb, a bias and an f32 output under bf16 inputs (the TP-partial block)
against its plain version at ranks 1–3. The card itself is checked by
tests/test_torch_kernel_gpu.py and chip_smoke.py.
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
HEADER = "fno_common.cuh"

# (spatial, modes, B, H, O) at rank 3: odd extents (8 and 10 rows of s_1:
# ragged at 3 rows a chunk), and fno3d's slicing at clusters of 16.
CASES = [((8, 8, 16), (3, 3, 5), 2, 8, 6),
         ((10, 16, 32), (5, 6, 9), 1, 4, 8),
         ((7, 8, 8), (3, 4, 3), 2, 32, 32)]
# The forward-chain offset into the s_1 operand, and its dropped copy.
DROP_C0 = ("const T* f1r = m.r[R - 1] + c0 * g.k1;",
           "const T* f1r = m.r[R - 1];")


def _compile(out: Path, name: str, header_mutation=None) -> Path:
    """Compile csrc/<name>.cu for the CPU beside a copy of the shared
    header (found before the sources' own; the other headers come from
    csrc); `header_mutation` (old, new) replaces one exact piece of the
    header first."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    header = (build.CSRC / HEADER).read_text()
    if header_mutation is not None:
        assert header.count(header_mutation[0]) == 1, header_mutation[0]
        header = header.replace(*header_mutation)
    (out / HEADER).write_text(header)
    src = (build.CSRC / f"{name}.cu").read_text()
    decl = "extern __shared__ float smem[];"
    assert src.count(decl) == 1
    cpp = out / f"{name}.cpp"
    cpp.write_text(src.replace(decl,
                               "float* smem = g_smem[blockIdx.x].data();"))
    lib = out / f"lib{name}_emulated.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", "-include", "cuda_runtime.h",
         f"-I{out}", f"-I{EMULATION}", f"-I{build.CSRC}", str(cpp), "-o",
         str(lib)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated_block")
    return build.load_block_library(_compile(out, "fused_block"))


@pytest.fixture(scope="module")
def emulated_wgrad(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated_wgrad")
    return build.load_wgrad_library(_compile(out, "fused_wgrad"))


def _force_rows(monkeypatch, rows_f):
    """Every block and wgrad plan at `rows_f` s_1 rows per forward-chain
    chunk (fewer rows than planned need less of the work area)."""
    for name in ("pick_plan", "pick_wgrad_plan"):
        pick = getattr(engine, name)

        def forced(*a, _pick=pick, **kw):
            plan = _pick(*a, **kw)
            assert plan["rows_f"] >= rows_f
            return dict(plan, rows_f=rows_f)
        monkeypatch.setattr(engine, name, forced)


def _inputs(spatial, b, h, o, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.tensor(sc * rng.normal(size=s),
                                         dtype=torch.float32)
    return ([mk(b, h, *spatial), mk(o, h, sc=1.0 / h), mk(o, h, sc=1.0 / h),
             mk(o, h, sc=1.0 / h), mk(o, 1, sc=0.3)],
            mk(b, o, *spatial))


def _rel_err(y, ref) -> float:
    y, ref = y.float(), ref.float()
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


_NAMES = ("y", "gz", "dx", "bare", "bare_dx", "dwr", "dwi", "dwb", "dbias",
          "bare_dwr", "bare_dwi")


def _launches(lib, wlib, args, gy, spatial, modes, dtype, plain=False):
    """Every launch that runs the forward chain, as the fused paths issue
    them (the kernels, or with plain=True their f32 plain versions); gz
    feeds dx and the wgrads. Returns outputs in ``_NAMES`` order."""
    tdt = torch.float32 if plain else getattr(torch, dtype)
    x, wr, wi, wb, bias = [a.to(tdt) for a in args]
    gy = gy.to(tdt)
    mats = {k: spectral.operand_tensors(spatial, modes,
                                        "float32" if plain else dtype,
                                        "cpu", k)
            for k in ("forward", "adjoint", "wgrad")}
    if plain:
        block = lambda *a, **kw: engine.fused_block_plain(*a, **kw)
        wgrad = lambda *a, **kw: engine.fused_wgrad_plain(*a, **kw)
    else:
        block = lambda *a, **kw: engine._launch(lib, *a, spatial, modes,
                                                None, **kw)
        wgrad = lambda x_, g_, m_, **kw: engine._launch_wgrad(
            wlib, x_, g_, m_, spatial, modes, None, **kw)
    wrt, wit = wr.transpose(0, 1), wi.transpose(0, 1)
    y = block(x, wr, wi, wb, bias, mats["forward"])
    gz = block(x, wr, wi, wb, bias, mats["forward"], act="gelu_vjp", gy=gy)
    dx = block(gz, wrt, wit, wb.t().contiguous(), None, mats["adjoint"],
               act="linear")
    bare = block(x, wr, wi, None, None, mats["forward"], act="linear")
    bare_dx = block(gy, wrt, wit, None, None, mats["adjoint"], act="linear")
    dw = wgrad(x, gz, mats["wgrad"])
    bare_dw = wgrad(x, gy, mats["wgrad"], with_bypass=False)
    return (y, gz, dx, bare, bare_dx) + tuple(dw) + tuple(bare_dw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows_f", [2, 3])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}h{c[3]}")
def test_emulated_chunked_forward_chain_matches_plain(
        emulated, emulated_wgrad, monkeypatch, case, rows_f, dtype):
    """Each launch with the forward chain streamed 2 or 3 s_1 rows at a
    time (ragged last chunks at 3) against the plain versions: f32 within
    2e-4, bf16 within 2e-2 of the f32 chain (gz from the kernel feeds both
    sides' dx and wgrad)."""
    spatial, modes, b, h, o = case
    _force_rows(monkeypatch, rows_f)
    args, gy = _inputs(spatial, b, h, o, seed=rows_f + h)
    outs = _launches(emulated, emulated_wgrad, args, gy, spatial, modes,
                     dtype)
    refs = list(_launches(None, None, args, gy, spatial, modes, dtype,
                          plain=True))
    x32, wr, wi, wb, _ = args
    m32 = {k: spectral.operand_tensors(spatial, modes, "float32", "cpu", k)
           for k in ("adjoint", "wgrad")}
    gz = outs[1].float()  # dx and dW of the kernel's own gz
    refs[2] = engine.fused_block_plain(gz, wr.t().contiguous(),
                                       wi.t().contiguous(),
                                       wb.t().contiguous(), None,
                                       m32["adjoint"], act="linear")
    refs[5:9] = engine.fused_wgrad_plain(x32, gz, m32["wgrad"])
    tol = 2e-4 if dtype == "float32" else 2e-2
    for name, a, ref in zip(_NAMES, outs, refs):
        assert a.shape == ref.shape and bool(torch.isfinite(a).all()), name
        assert _rel_err(a, ref) <= tol, (name, _rel_err(a, ref))


def test_fno3d_slicing_plans_clusters_of_16(emulated, emulated_wgrad):
    """The third case slices as fno3d does: 32 channels on clusters of 16,
    two hidden and two out channels a block."""
    spatial, modes, b, h, o = CASES[2]
    for plan in (engine.pick_plan(emulated, 0, b, h, o, spatial, modes),
                 engine.pick_wgrad_plan(emulated_wgrad, 0, b, h, o, spatial,
                                        modes)):
        assert (plan["cluster"], plan["hs"], plan["os"]) == (16, 2, 2)


def test_emulated_dropped_chunk_offset_is_caught(tmp_path, monkeypatch):
    """A forward chain that reads every chunk against the first rows of
    the s_1 operand (the chunk offset dropped) fails the comparison once
    the chain runs in chunks."""
    spatial, modes, b, h, o = CASES[0]
    _force_rows(monkeypatch, 3)
    lib = build.load_block_library(_compile(tmp_path, "fused_block",
                                            DROP_C0))
    args, _ = _inputs(spatial, b, h, o, seed=7)
    mats = spectral.operand_tensors(spatial, modes, "float32", "cpu")
    y = engine._launch(lib, *args, mats, spatial, modes, None)
    assert _rel_err(y, engine.fused_block_plain(*args, mats)) > 2e-4


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_emulated_linear_epilogue_with_bias_emits_f32(emulated, rank):
    """The TP-partial block: bf16 x, weights, wb and bias, no activation,
    the output written in f32 (out_f32), against the f32 plain version
    within 2e-2 and the bf16 plain version within 1e-2."""
    spatial, modes, b, h, o = [((64,), (17,), 2, 8, 6),
                               ((16, 32), (5, 9), 2, 8, 6),
                               CASES[0]][rank - 1]
    args, _ = _inputs(spatial, b, h, o, seed=60 + rank)
    ref = engine.fused_block_plain(
        *args, spectral.operand_tensors(spatial, modes, "float32", "cpu"),
        act="linear")
    a16 = [a.to(torch.bfloat16) for a in args]
    m16 = spectral.operand_tensors(spatial, modes, "bfloat16", "cpu")
    y = engine._launch(emulated, *a16, m16, spatial, modes, None,
                       act="linear", out_dtype=torch.float32)
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    assert _rel_err(y, ref) <= 2e-2
    plain16 = engine.fused_block_plain(*a16, m16, act="linear",
                                       out_dtype=torch.float32)
    assert _rel_err(y, plain16) <= 1e-2
    # The bias is in it: without, the output moves by the bias.
    nobias = engine._launch(emulated, *a16[:4], None, m16, spatial, modes,
                            None, act="linear", out_dtype=torch.float32)
    shift = (y - nobias).mean(dim=[0] + list(range(2, 2 + rank)))
    torch.testing.assert_close(shift, a16[4].float().reshape(-1),
                               rtol=0, atol=1e-4)
