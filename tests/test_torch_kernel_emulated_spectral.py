"""The spectral-only path's kernel sources and the complex product, run on
the CPU.

``src/repro_torch/csrc/cgemm.cu``, ``fused_wgrad.cu`` (its bypass-free
mode, ``kBypass=false``) and ``fused_block.cu`` (the bare layer's adjoint)
are compiled with g++ against the emulation headers in
``tests/cuda_emulation`` (one POSIX thread per CUDA thread, real barriers,
one shared-memory buffer per block; see tests/test_torch_kernel_emulated.py),
loaded through the same ``ctypes`` signatures and launch plans as on the
card, and compared with the kernels' plain PyTorch versions: the complex
product at ragged and tile-crossing shapes, the wgrad kernel without its
bypass phase with shared and per-mode weights at ranks 1–3, and the bare
block kernel with the adjoint bundle and the weights' transposed view.
Mutated copies (a sign flipped in the product's imaginary cross term, one
TF32 pass in place of three, a dropped conj in the bypass-free dW) must
fail the same comparisons. The
card itself is checked by tests/test_torch_kernel_gpu.py and chip_smoke.py.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import spectral
from repro_torch.kernels import build, engine
from repro_torch.kernels import cgemm as cgemm_k

EMULATION = Path(__file__).resolve().parent / "cuda_emulation"

# (M, K, N): ragged everywhere, one more than a tile in every direction,
# a tall K against few outputs (A resident in shared memory), then K past
# a block's shared memory (K walked in chunks, the last ragged: 2 in f32;
# 4 in f32 and 2 in bf16), and M in two slices with K chunked in f32.
CGEMM_CASES = [(37, 19, 23), (65, 17, 129), (8, 130, 70), (16, 700, 20),
               (8, 1200, 24), (130, 257, 129)]
# (spatial, modes, B, H, O): the odd extents at ranks 1–3 and clusters of
# 16 blocks with one hidden channel each.
CASES = [((64,), (17,), 2, 8, 6), ((16, 32), (5, 9), 2, 8, 6),
         ((8, 8, 16), (3, 3, 5), 2, 8, 6), ((12, 20), (4, 6), 2, 16, 16)]


def _compile(out: Path, name: str, mutation=None,
             header_mutation=None) -> Path:
    """Compile csrc/<name>.cu for the CPU; `mutation` (old, new) replaces
    one exact piece of the source first, `header_mutation` (header, old,
    new) one of a shared header, whose mutated copy is compiled beside the
    source."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    src = (build.CSRC / f"{name}.cu").read_text()
    if mutation is not None:
        assert src.count(mutation[0]) == 1, mutation[0]
        src = src.replace(mutation[0], mutation[1])
    if header_mutation is not None:
        header, old, new = header_mutation
        text = (build.CSRC / header).read_text()
        assert text.count(old) == 1, old
        (out / header).write_text(text.replace(old, new))
    decl = "extern __shared__ float smem[];"
    assert src.count(decl) == 1
    cpp = out / f"{name}.cpp"
    cpp.write_text(src.replace(decl,
                               "float* smem = g_smem[blockIdx.x].data();"))
    lib = out / f"lib{name}_emulated.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-Wno-unknown-pragmas", "-include", "cuda_runtime.h",
         f"-I{EMULATION}", f"-I{build.CSRC}", str(cpp), "-o", str(lib)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return lib


@pytest.fixture(scope="module")
def emulated_cgemm(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated_cgemm")
    return build.load_cgemm_library(_compile(out, "cgemm"))


@pytest.fixture(scope="module")
def emulated_wgrad(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated_wgrad")
    return build.load_wgrad_library(_compile(out, "fused_wgrad"))


@pytest.fixture(scope="module")
def emulated_block(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated_block")
    return build.load_block_library(_compile(out, "fused_block"))


def _rel_err(y, ref) -> float:
    y, ref = y.float(), ref.float()
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def _caught(outs, refs, tol) -> bool:
    """A mutation is caught where an output misses its reference by more
    than `tol` or is not finite."""
    return any(not _rel_err(a, r) <= tol for a, r in zip(outs, refs))


def _planes(m, k, n, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32)
    return [mk(m, k), mk(m, k), mk(k, n), mk(k, n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CGEMM_CASES, ids=str)
def test_emulated_cgemm_matches_plain(emulated_cgemm, case, dtype):
    """f32 within 2e-4 of the plain version on the same inputs; bf16
    within 2e-2 of the f32 plain version and a rounding step of the bf16
    one."""
    m, k, n = case
    planes = _planes(m, k, n, seed=m + n)
    ref = cgemm_k.cgemm_plain(*planes)
    tdt = getattr(torch, dtype)
    ins = [a.to(tdt) for a in planes]
    outs = cgemm_k._launch(emulated_cgemm, *ins, None)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for a, r, r16 in zip(outs, ref, cgemm_k.cgemm_plain(*ins)):
        assert a.dtype == tdt and tuple(a.shape) == (m, n)
        assert _rel_err(a, r) <= tol
        assert _rel_err(a, r16) <= (2e-4 if dtype == "float32" else 1e-2)


def test_emulated_cgemm_plan_switches_at_the_budget(emulated_cgemm):
    """A stays resident in shared memory (one K chunk) at the FNO's shapes,
    (128,128) f32 included (both planes of 128 rows, 135 KB: 205 KB of a
    block's 232 KB with two strips of B and C); K is chunked where A and
    two strips of B do not fit, f32 (130,257) in two slices of 65 rows."""
    plan = lambda dt, m, k: cgemm_k.plan(emulated_cgemm, dt, m, k)
    f32, bf16 = torch.float32, torch.bfloat16
    for dt in (f32, bf16):
        for m in (64, 128):
            p = plan(dt, m, m)
            assert (p["slices"], p["chunks"]) == (1, 1), (dt, m, p)
            assert p["smem"] <= engine._SMEM_LIMIT
    assert plan(f32, 128, 128)["smem"] == 204_928
    assert plan(f32, 16, 700)["chunks"] == 2
    assert plan(bf16, 16, 700)["chunks"] == 1
    assert plan(f32, 8, 1200)["chunks"] == 4
    assert plan(bf16, 8, 1200)["chunks"] == 2
    p = plan(f32, 130, 257)
    assert (p["slices"], p["rows"], p["chunks"]) == (2, 65, 3)
    assert plan(bf16, 130, 257)["chunks"] == 1


def _inputs(spatial, modes, b, h, o, per_mode, seed):
    """x [B,H,s…], gz [B,O,s…], wr/wi (shared [O,H] or per-mode), f32."""
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.tensor(sc * rng.normal(size=s),
                                         dtype=torch.float32)
    w = (o, h) + (tuple(modes) if per_mode else ())
    return (mk(b, h, *spatial), mk(b, o, *spatial), mk(*w, sc=1.0 / h),
            mk(*w, sc=1.0 / h))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_emulated_bypass_free_wgrad_matches_plain(emulated_wgrad, case,
                                                  per_mode, dtype):
    """The wgrad kernel with kBypass=false: (dwr, dwi) only, against
    ``fused_wgrad_plain(with_bypass=False)`` in f32 (bf16: 2e-2, f32:
    2e-4)."""
    spatial, modes, b, h, o = case
    x, gz, _, _ = _inputs(spatial, modes, b, h, o, per_mode, seed=h + b)
    m32 = spectral.operand_tensors(spatial, modes, "float32", "cpu",
                                   "wgrad")
    ref = engine.fused_wgrad_plain(x, gz, m32, per_mode=per_mode,
                                   with_bypass=False)
    tdt = getattr(torch, dtype)
    mats = spectral.operand_tensors(spatial, modes, dtype, "cpu", "wgrad")
    outs = engine._launch_wgrad(emulated_wgrad, x.to(tdt), gz.to(tdt), mats,
                                spatial, modes, None, per_mode=per_mode,
                                with_bypass=False)
    assert len(outs) == len(ref) == 2
    for a, r in zip(outs, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert bool(torch.isfinite(a).all())
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: f"{c[0]}x{c[1]}")
def test_emulated_bare_adjoint_matches_plain(emulated_block, case,
                                             per_mode):
    """The bare layer's dx: the block kernel without wb, with the adjoint
    bundle and the weights' (out, hidden)-swapped view read through its
    strides, emitted in f32 from bf16 operands as the backward does
    under the bf16 policy (f32: 2e-4; bf16: 2e-2)."""
    spatial, modes, b, h, o = case
    _, gz, wr, wi = _inputs(spatial, modes, b, h, o, per_mode, seed=o + 7)
    ref = engine.fused_block_plain(
        gz, wr.transpose(0, 1), wi.transpose(0, 1), None, None,
        spectral.operand_tensors(spatial, modes, "float32", "cpu",
                                 "adjoint"), act="linear")
    for dtype, tol in (("float32", 2e-4), ("bfloat16", 2e-2)):
        tdt = getattr(torch, dtype)
        w_r, w_i = wr.to(tdt), wi.to(tdt)
        dx = engine._launch(
            emulated_block, gz.to(tdt), w_r.transpose(0, 1),
            w_i.transpose(0, 1), None, None,
            spectral.operand_tensors(spatial, modes, dtype, "cpu",
                                     "adjoint"),
            spatial, modes, None, act="linear", out_dtype=torch.float32)
        assert dx.dtype == torch.float32 and dx.shape == (b, h) + spatial
        assert _rel_err(dx, ref) <= tol


# Mutations, each of which the comparisons above must catch:
# (source, what, (old, new)).
MUTATIONS = [
    ("cgemm", "sign flipped in the imaginary cross term",
     ("rr[0][j][e] -= ii[0][j][e];", "rr[0][j][e] += ii[0][j][e];")),
    ("fused_wgrad", "dropped conj in the bypass-free dW",
     ("wsb[O * H + (o0 + o) * H + h] = -acci[o];  // conj",
      "wsb[O * H + (o0 + o) * H + h] = acci[o];")),
]


@pytest.mark.parametrize("mutation", MUTATIONS,
                         ids=lambda m: f"{m[0]}-{m[1].replace(' ', '_')}")
def test_emulated_mutations_are_caught(tmp_path, mutation):
    name, _, edit = mutation
    lib = _compile(tmp_path, name, edit)
    if name == "cgemm":
        planes = _planes(*CGEMM_CASES[1], seed=3)
        outs = cgemm_k._launch(build.load_cgemm_library(lib), *planes, None)
        refs = cgemm_k.cgemm_plain(*planes)
    else:
        spatial, modes, b, h, o = CASES[1]
        x, gz, _, _ = _inputs(spatial, modes, b, h, o, False, seed=4)
        mats = spectral.operand_tensors(spatial, modes, "float32", "cpu",
                                        "wgrad")
        outs = engine._launch_wgrad(build.load_wgrad_library(lib), x, gz,
                                    mats, spatial, modes, None,
                                    with_bypass=False)
        refs = engine.fused_wgrad_plain(x, gz, mats, with_bypass=False)
    assert _caught(outs, refs, 2e-4)


def test_emulated_cgemm_one_pass_tf32_is_caught(tmp_path):
    """f32 runs three TF32 products (3xTF32); one TF32 pass (the two small
    terms of tc_common.cuh dropped) misses the f32 tolerance at K = 130,
    where the unmutated kernel holds it."""
    planes = _planes(*CGEMM_CASES[2], seed=5)
    refs = cgemm_k.cgemm_plain(*planes)
    good = cgemm_k._launch(
        build.load_cgemm_library(_compile(tmp_path, "cgemm")), *planes, None)
    assert max(_rel_err(a, r) for a, r in zip(good, refs)) <= 2e-4
    mutated = tmp_path / "one_pass"
    mutated.mkdir()
    lib = build.load_cgemm_library(_compile(
        mutated, "cgemm", header_mutation=(
            "tc_common.cuh",
            "mma_tf32(d, a.lo, b.hi);\n    mma_tf32(d, a.hi, b.lo);\n", "")))
    outs = cgemm_k._launch(lib, *planes, None)
    assert _caught(outs, refs, 2e-4)
