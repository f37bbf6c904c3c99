"""The block kernel's tensor-core chains and the wgrad kernel's second
chain plan, run on the CPU.

``src/repro_torch/csrc/fused_block.cu`` runs its forward chain on the
tensor cores (``chain_tc.cuh``'s ``forward_chain``, its work area over C)
or, by the plan's "chain", on the CUDA cores, and its padded inverse chain
on the tensor cores (``inverse_chunk``: E_1's chunk columns in pieces of
"dp" rows, the last factor resident or in pieces of "wl" columns);
``fused_wgrad.cu`` runs either chain by its plan. Both are compiled with
g++ against the emulation headers in ``tests/cuda_emulation`` (one POSIX
thread per CUDA thread, real barriers, one shared-memory buffer per block,
the warp's mma.sync gathered at a warp barrier; see
tests/test_torch_kernel_emulated.py) and held against their plain PyTorch
versions: every block mode (forward, gz recompute, dx through the adjoint
bundle, the bare layer, the linear block with a bias and an f32 output) at
ranks 1–3 with either forward chain forced through the plan and the
inverse chain in ragged chunks and in pieces of both kinds; the wgrad
with the CUDA cores' chain forced; the planner's shared memory against the
kernel's own layout (``fused_block_smem``). Three mutated copies must fail
the same comparison: the tensor-core stages' E_i / F_i sign flip dropped,
one TF32 pass in the inverse stages (the forward chain on the CUDA cores),
and C with phase 1's work area laid over the spectra that phase 1 is still
writing. The card itself is checked by tests/test_torch_kernel_gpu.py and
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

# rank -> (spatial, modes, B, H, O, rows_i): ragged extents, k_1 past one
# piece of 4 E_1 rows, the last axis past one piece of 8 columns, and
# inverse chunks that leave a ragged last one.
CASES = {
    1: ((64,), (17,), 2, 8, 6, 24),
    2: ((16, 32), (5, 9), 2, 8, 6, 6),
    3: ((8, 8, 16), (6, 3, 5), 2, 8, 6, 3),
}
# The sign flip of the F_i / E_i lane feeding an imaginary input to a real
# output; one TF32 pass in the chains' products; C's offset over A's
# imaginary half.
SIGN_FLIP = ("chain_tc.cuh",
             "b.hi[1] = tc::lds32(q + off_f) ^ 0x80000000u;  // −F_i",
             "b.hi[1] = tc::lds32(q + off_f);")
ONE_PASS = ("chain_tc.cuh",
            "#pragma unroll\n    for (int i = 0; i < N; ++i) tc::mma_tf32("
            "s[i], a[i].lo, b[i].hi);\n#pragma unroll\n    for (int i = 0; "
            "i < N; ++i) tc::mma_tf32(s[i], a[i].hi, b[i].lo);\n", "")
C_OVER_A = ("B.c = align128(B.a + 8LL * hc * K);",
            "B.c = align128(B.a + 4LL * hc * K);")


def _compile(out: Path, name: str, mutation=None, header=None) -> Path:
    """Compile csrc/<name>.cu for the CPU; `mutation` (old, new) edits the
    source, `header` (file, old, new) a copy of a shared header compiled
    beside it (found before csrc's)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    src = (build.CSRC / f"{name}.cu").read_text()
    if mutation is not None:
        assert src.count(mutation[0]) == 1, mutation[0]
        src = src.replace(*mutation)
    if header is not None:
        text = (build.CSRC / header[0]).read_text()
        assert text.count(header[1]) == 1, header[1]
        (out / header[0]).write_text(text.replace(header[1], header[2]))
    decl = "extern __shared__ float smem[];"
    assert src.count(decl) == 1
    cpp = out / f"{name}.cpp"
    cpp.write_text(src.replace(decl,
                               "float* smem = g_smem[blockIdx.x].data();"))
    lib = out / f"lib{name}_emulated.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         "-fno-strict-aliasing", "-Wno-unknown-pragmas", "-include",
         "cuda_runtime.h", f"-I{out}", f"-I{EMULATION}", f"-I{build.CSRC}",
         str(cpp), "-o", str(lib)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated_chains")
    return build.load_block_library(_compile(out, "fused_block"))


@pytest.fixture(scope="module")
def emulated_wgrad(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated_chains_wgrad")
    return build.load_wgrad_library(_compile(out, "fused_wgrad"))


def _inputs(spatial, b, h, o, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.tensor(sc * rng.normal(size=s),
                                         dtype=torch.float32)
    return ([mk(b, h, *spatial), mk(o, h, sc=1.0 / h), mk(o, h, sc=1.0 / h),
             mk(o, h, sc=1.0 / h), mk(o, 1, sc=0.3)], mk(b, o, *spatial))


def _rel_err(y, ref) -> float:
    y, ref = y.float(), ref.float()
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def _modes(run, args, gy, mats, f32):
    """The block kernel's modes, as the fused paths issue them: (name,
    output) of the forward, the gz recompute, dx (the adjoint bundle, the
    weights' transposed view, f32 out), the bare layer and the linear
    block (bias, f32 out)."""
    x, wr, wi, wb, bias = args
    gz = run(*args, mats["forward"], act="gelu_vjp", gy=gy)
    return [("y", run(*args, mats["forward"])), ("gz", gz),
            ("dx", run(gz, wr.t(), wi.t(), wb.t().contiguous(), None,
                       mats["adjoint"], act="linear", out_dtype=f32)),
            ("bare", run(x, wr, wi, None, None, mats["forward"],
                         act="linear")),
            ("linear", run(*args, mats["forward"], act="linear",
                           out_dtype=f32))]


@pytest.mark.parametrize("chain", engine.CHAINS)
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_emulated_block_chains_match_plain(emulated, monkeypatch, rank,
                                           chain):
    """Every block mode with the forward chain on the tensor cores or on
    the CUDA cores (forced through the plan) and the inverse chain in
    ragged chunks, E_1 in pieces of 4 rows and the last factor in pieces of
    8 columns, against the plain versions: f32 within 2e-4 (dx and dW of
    the kernel's own gz), and the bf16 forward within 2e-2 of the f32 plain
    version."""
    spatial, modes, b, h, o, rows_i = CASES[rank]
    monkeypatch.setattr(engine, "FORCED",
                        {"chain": chain, "rows_i": rows_i, "dp": 4, "wl": 8})
    assert engine.pick_plan(emulated, 0, b, h, o, spatial,
                            modes)["rows_i"] == rows_i
    args, gy = _inputs(spatial, b, h, o, seed=10 * rank + len(chain))
    mats = {k: spectral.operand_tensors(spatial, modes, "float32", "cpu", k)
            for k in ("forward", "adjoint")}
    run = lambda *a, **kw: engine._launch(emulated, *a, spatial, modes, None,
                                          **kw)
    plain = lambda *a, **kw: engine.fused_block_plain(*a, **kw)
    f32 = torch.float32
    ours = _modes(run, args, gy, mats, f32)
    refs = dict(_modes(plain, args, gy, mats, f32))
    gz = ours[1][1]  # dx of the kernel's own gz on both sides
    wr, wi, wb = args[1:4]
    refs["dx"] = plain(gz, wr.t(), wi.t(), wb.t().contiguous(), None,
                       mats["adjoint"], act="linear", out_dtype=f32)
    for name, y in ours:
        assert bool(torch.isfinite(y).all()), name
        assert _rel_err(y, refs[name]) <= 2e-4, (name, _rel_err(y, refs[name]))
    a16 = [t.to(torch.bfloat16) for t in args]
    m16 = spectral.operand_tensors(spatial, modes, "bfloat16", "cpu")
    y16 = engine._launch(emulated, *a16, m16, spatial, modes, None)
    assert _rel_err(y16, refs["y"]) <= 2e-2


@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_emulated_wgrad_cuda_core_chain_matches_plain(
        emulated_wgrad, monkeypatch, rank, per_mode):
    """The wgrad with the CUDA cores' chain forced through the plan (the
    chain it takes where the tensor cores' does not fit), with its bypass,
    shared and per-mode W, B=5, against the plain version within 2e-4."""
    spatial, modes, b, h, o = [((100,), (30,), 5, 3, 5),
                               ((12, 20), (4, 6), 5, 6, 6),
                               ((5, 6, 7), (3, 3, 4), 5, 4, 6)][rank - 1]
    monkeypatch.setattr(engine, "FORCED", {"chain": "fma"})
    rng = np.random.default_rng(rank)
    x = torch.tensor(rng.normal(size=(b, h) + spatial), dtype=torch.float32)
    gz = torch.tensor(rng.normal(size=(b, o) + spatial), dtype=torch.float32)
    mats = spectral.operand_tensors(spatial, modes, "float32", "cpu",
                                    "wgrad")
    plan = engine.pick_wgrad_plan(emulated_wgrad, 0, b, h, o, spatial, modes,
                                  per_mode)
    assert plan["chain"] == "fma"
    outs = engine._launch_wgrad(emulated_wgrad, x, gz, mats, spatial, modes,
                                None, per_mode=per_mode)
    refs = engine.fused_wgrad_plain(x, gz, mats, per_mode=per_mode)
    for a, r in zip(outs, refs):
        assert a.shape == r.shape and _rel_err(a, r) <= 2e-4


def test_emulated_block_plan_matches_the_kernel_layout(emulated):
    """kernels/engine.py's shared-memory plan is the kernel's own layout
    (fused_block_smem), f32 and bf16, with either chain, shared and
    per-mode W, with and without the ends (where a forced chain or the
    ends fit), at the presets' widths, the shapes the wgrad's tensor-core
    chain refused, odd ones, and in pieces."""
    shapes = [(64, (128, 128), (32, 32)), (32, (64, 64, 64), (16, 16, 16)),
              (128, (128, 128), (32, 32)), (64, (256,), (64,)),
              (64, (256, 256), (32, 32)), (16, (512, 512), (64, 64)),
              (32, (8192,), (2048,)), (16, (128, 128, 128), (16, 16, 16))]
    shapes += [(h, s, m) for s, m, _, h, _, _ in CASES.values()]
    for h, spatial, modes in shapes:
        for per_mode in (False, True):
            for chain, ends in ((None, None), ("tc", None),
                                ("fma", None), (None, (3, 2 * h, 2 * h, 1)),
                                (None, (h, 0, 2 * h, 1))):
                try:
                    plan = engine.launch_plan(h, h, spatial, modes, 16,
                                              per_mode, ends, chain=chain)
                except ValueError:  # a forced chain, or the ends, too big
                    assert chain or ends
                    continue
                lift, lp, cout = ends[1:] if ends else (0, 0, 0)
                dims = engine._dims(1, h, h, spatial, modes)
                pl = engine.block_ints(plan)
                wl = engine._ints([int(per_mode), 1, 1])
                ed = engine._ints(list(ends)) if ends else None
                for code, esize in ((0, 4), (1, 2)):
                    want = engine._block_layout(
                        esize, h, h, spatial, modes, plan["hs"], plan["os"],
                        plan["rows_f"], plan["rows_i"], plan["wl"],
                        plan["dp"], plan["chain"], per_mode, lift, lp, cout,
                        plan.get("ep", 0))["bytes"]
                    got = emulated.fused_block_smem(code, len(spatial), dims,
                                                    pl, wl, ed)
                    assert got == want <= plan["smem"], (h, spatial, ends)


@pytest.mark.parametrize("mutation", ["sign_flip", "one_pass", "c_over_a"])
def test_emulated_chain_mutations_are_caught(tmp_path, monkeypatch,
                                             mutation):
    """Each mutation fails the block forward's comparison that the
    unmutated kernel passes (test_emulated_block_chains_match_plain): the
    dropped sign flip in both chains, one TF32 pass in the inverse chain
    (the forward chain on the CUDA cores, so only the inverse stages run on
    the tensor cores), and C with phase 1's work area over A's imaginary
    half, which the chain is still writing."""
    spatial, modes, b, h, o, rows_i = CASES[2]
    edit = {"sign_flip": {"header": SIGN_FLIP},
            "one_pass": {"header": ONE_PASS},
            "c_over_a": {"mutation": C_OVER_A}}[mutation]
    monkeypatch.setattr(engine, "FORCED", {
        "chain": "fma" if mutation == "one_pass" else "tc", "rows_i": rows_i})
    lib = build.load_block_library(_compile(tmp_path, "fused_block", **edit))
    args, _ = _inputs(spatial, b, h, o, seed=3)
    mats = spectral.operand_tensors(spatial, modes, "float32", "cpu")
    y = engine._launch(lib, *args, mats, spatial, modes, None)
    assert not _rel_err(y, engine.fused_block_plain(*args, mats)) <= 2e-4
