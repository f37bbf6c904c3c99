"""The port's CUDA kernel sources, run on the CPU.

``src/repro_torch/csrc/fused_block.cu``, ``fused_wgrad.cu``,
``dft_rows.cu`` and ``fused_core.cu`` are compiled with g++ against the
emulation headers in ``tests/cuda_emulation`` (one POSIX thread per CUDA
thread, real barriers for ``__syncthreads`` and the cluster barrier, one
shared-memory buffer per block that the cluster's other blocks map,
clusters run in grid order, blocks of a launch without clusters one at a
time), loaded through the same ``ctypes`` signatures and launch plans as
on the card, and compared with the kernels' plain PyTorch versions: the
block forward, the bare spectral layer, the backward's three launches (gz
recompute, dx adjoint, wgrad), the row DFTs and the partial-fusion core.
This checks the kernels' indexing, chunking, masking, cluster exchange and
the wgrad kernel's batch reduction at every rank without a GPU; mutated
copies of the new sources (a dropped imaginary term, an off-by-one on a
ragged edge) must fail the same comparison. The card itself is checked by
tests/test_torch_kernel_gpu.py and chip_smoke.py.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import spectral
from repro_torch.kernels import build, dft, engine

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


def _compile(out: Path, name: str, mutation=None) -> Path:
    """Compile csrc/<name>.cu for the CPU; `mutation` (old, new) replaces
    one exact piece of the source first."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    src = (build.CSRC / f"{name}.cu").read_text()
    if mutation is not None:
        assert src.count(mutation[0]) >= 1, mutation[0]
        src = src.replace(mutation[0], mutation[1], 1)
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
def emulated(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated")
    return build.load_block_library(_compile(out, "fused_block"))


@pytest.fixture(scope="module")
def emulated_wgrad(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated_wgrad")
    return build.load_wgrad_library(_compile(out, "fused_wgrad"))


@pytest.fixture(scope="module")
def emulated_rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated_rows")
    return build.load_dft_rows_library(_compile(out, "dft_rows"))


@pytest.fixture(scope="module")
def emulated_core(tmp_path_factory):
    out = tmp_path_factory.mktemp("emulated_core")
    return build.load_core_library(_compile(out, "fused_core"))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_emulated_backward_kernels_match_plain(emulated, emulated_wgrad,
                                               case, dtype):
    """The backward's three launches: gz = gy·gelu'(z) (recompute mode),
    dx through the adjoint bundle with transposed weights (linear mode, no
    bias, emitted in f32), and dW, dW_b, dbias from the wgrad kernel,
    against the plain versions in f32 (bf16: 2e-2, f32: 2e-4)."""
    spatial, modes, b, h, o = case
    x, wr, wi, wb, bias = _inputs(spatial, b, h, o, seed=len(spatial) + o)
    gy = torch.randn((b, o) + spatial,
                     generator=torch.Generator().manual_seed(h))
    tdt = getattr(torch, dtype)
    t = lambda a: a.to(tdt).contiguous()
    mats = {k: spectral.operand_tensors(spatial, modes, dtype, "cpu", k)
            for k in ("forward", "adjoint", "wgrad")}
    m32 = {k: spectral.operand_tensors(spatial, modes, "float32", "cpu", k)
           for k in ("forward", "adjoint", "wgrad")}
    gz = engine._launch(emulated, t(x), t(wr), t(wi), t(wb), t(bias),
                        mats["forward"], spatial, modes, None,
                        act="gelu_vjp", gy=t(gy))
    dx = engine._launch(emulated, gz, t(wr.t()), t(wi.t()), t(wb.t()), None,
                        mats["adjoint"], spatial, modes, None, act="linear",
                        out_dtype=torch.float32)
    dw = engine._launch_wgrad(emulated_wgrad, t(x), gz, mats["wgrad"],
                              spatial, modes, None)
    gz32 = engine.fused_block_plain(x, wr, wi, wb, bias, m32["forward"],
                                    act="gelu_vjp", gy=gy)
    dx32 = engine.fused_block_plain(gz.float(), wr.t().contiguous(),
                                    wi.t().contiguous(), wb.t().contiguous(),
                                    None, m32["adjoint"], act="linear")
    dw32 = engine.fused_wgrad_plain(x, gz.float(), m32["wgrad"])
    tol = 2e-4 if dtype == "float32" else 2e-2
    assert gz.dtype == tdt and dx.dtype == torch.float32
    for name, a, ref in zip(("gz", "dx", "dwr", "dwi", "dwb", "dbias"),
                            (gz, dx, *dw), (gz32, dx32, *dw32)):
        assert a.shape == ref.shape and bool(torch.isfinite(a).all()), name
        assert _rel_err(a, ref) <= tol, (name, _rel_err(a, ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_emulated_bare_spectral_matches_plain(emulated, rank, dtype):
    """The block kernel without wb and bias (linear epilogue): the bare
    spectral layer, the rank-1 partial variant's forward."""
    spatial, modes, b, h, o = CASES[rank - 1]
    x, wr, wi = _inputs(spatial, b, h, o, seed=30 + rank)[:3]
    ref = engine.fused_block_plain(
        x, wr, wi, None, None,
        spectral.operand_tensors(spatial, modes, "float32", "cpu"),
        act="linear")
    tdt = getattr(torch, dtype)
    y = engine._launch(emulated, *[a.to(tdt) for a in (x, wr, wi)], None,
                       None, spectral.operand_tensors(spatial, modes, dtype,
                                                      "cpu"),
                       spatial, modes, None, act="linear")
    assert y.dtype == tdt and bool(torch.isfinite(y).all())
    assert _rel_err(y, ref) <= (2e-4 if dtype == "float32" else 2e-2)


# Row-kernel cases (kind, leading shape, n, k): ragged rows (130 > one
# 128-row tile), ragged input chunks (n not a multiple of 16), ragged output
# tiles (k = 45 > 32), and a rank-3 outer operand.
ROW_CASES = [("rdft", (3, 5), 37, 9), ("rdft", (130,), 20, 11),
             ("cdft", (3,), 100, 45), ("icdft", (3, 5), 37, 9),
             ("irdft", (130,), 20, 11), ("irdft", (2, 3), 100, 45),
             ("outer_fwd", (2, 3), (6, 10), (3, 4)),
             ("outer_inv", (2, 3), (6, 10), (3, 4))]
_LAUNCH_KIND = {"rdft": "rdft", "cdft": "cdft", "icdft": "cdft",
                "irdft": "irdft", "outer_fwd": "rdft", "outer_inv": "irdft"}
_PLAIN = {"rdft": dft.rdft_plain, "cdft": dft.cdft_plain,
          "irdft": dft.irdft_plain}


def _row_inputs(kind, lead, n, k, seed):
    """f32 inputs and operands of one row case."""
    sp, md = (n, k) if isinstance(n, tuple) else ((n,), (k,))
    mats = spectral.row_operand_tensors(kind, sp, md, "float32", "cpu")
    launch = _LAUNCH_KIND[kind]
    rng = np.random.default_rng(seed)
    mk = lambda: torch.tensor(rng.normal(size=lead + (mats[0].shape[0],)),
                              dtype=torch.float32)
    ins = (mk(),) if launch == "rdft" else (mk(), mk())
    return launch, ins, mats, (sp, md)


def _run_rows(lib, case, dtype):
    """(kernel outputs at `dtype`, f32 plain outputs) of one row case."""
    kind, lead, n, k = case
    launch, ins, mats, (sp, md) = _row_inputs(kind, lead, n, k, seed=len(lead))
    ref = _PLAIN[launch](*ins, *mats)
    ref = ref if isinstance(ref, tuple) else (ref,)
    tdt = getattr(torch, dtype)
    tm = spectral.row_operand_tensors(kind, sp, md, dtype, "cpu")
    outs = dft._launch(lib, launch, tuple(a.to(tdt) for a in ins), tm, None)
    return outs, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ROW_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_emulated_row_kernels_match_plain(emulated_rows, case, dtype):
    outs, ref = _run_rows(emulated_rows, case, dtype)
    for a, r in zip(outs, ref):
        assert a.dtype == getattr(torch, dtype) and a.shape == r.shape
        assert bool(torch.isfinite(a).all())
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


# Core cases (B, H, O, s_1, K_1, K_R..K_2): rank 2 and 3 spectra, odd
# extents, channel counts off the kTP grouping, and no outer axis.
CORE_CASES = [(2, 8, 6, 16, 5, (9,)), (1, 5, 7, 33, 4, (3, 5)),
              (2, 3, 2, 10, 10, ())]


def _core_inputs(case, seed):
    b, h, o, n1, k1, spec = case
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.tensor(sc * rng.normal(size=s),
                                         dtype=torch.float32)
    f = [torch.from_numpy(m) for m in spectral.cdft_mats(n1, k1)]
    g = [torch.from_numpy(m) for m in spectral.cdft_mats(n1, k1, True)]
    return [mk(b, h, n1, *spec), mk(b, h, n1, *spec), mk(o, h, sc=1.0 / h),
            mk(o, h, sc=1.0 / h)] + f + g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [4096, 16], ids=["one", "chunked"])
@pytest.mark.parametrize("case", CORE_CASES, ids=str)
def test_emulated_core_matches_plain(emulated_core, monkeypatch, case,
                                     chunk, dtype):
    """The partial-fusion core against its plain version; chunk=16 forces
    several (ragged) s_1 chunks in the forward stage."""
    monkeypatch.setattr(engine, "_CORE_CHUNK", chunk)
    args = _core_inputs(case, seed=case[3])
    ref = engine.fused_core_plain(*args)
    tdt = getattr(torch, dtype)
    y = engine._launch_core(emulated_core, *[a.to(tdt) for a in args], None)
    for a, r in zip(y, ref):
        assert a.dtype == tdt and a.shape == r.shape
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


# Mutations of the new sources, each of which the comparisons above must
# catch: (source, what, (old, new)).
MUTATIONS = [
    ("dft_rows", "dropped imaginary term",
     ("acc_r[u][v] = fmaf(xr[u], mr[v], fmaf(-xi[u], mi[v], acc_r[u][v]));",
      "acc_r[u][v] = fmaf(xr[u], mr[v], acc_r[u][v]);")),
    ("dft_rows", "off-by-one on the ragged input edge",
     ("const bool in = gr < M && gc < n_in;",
      "const bool in = gr < M && gc < n_in - 1;")),
    ("fused_core", "dropped imaginary term",
     ("cr[u] = fmaf(wr, ar, fmaf(-wi, ai, cr[u]));",
      "cr[u] = fmaf(wr, ar, cr[u]);")),
    ("fused_core", "off-by-one on the ragged chunk edge",
     ("const int nr = min(a.rows, n1 - c0);",
      "const int nr = min(a.rows, n1 - c0 - 1);")),
]


@pytest.mark.parametrize("mutation", MUTATIONS,
                         ids=lambda m: f"{m[0]}-{m[1].replace(' ', '_')}")
def test_emulated_mutations_are_caught(tmp_path, monkeypatch, mutation):
    name, _, edit = mutation
    lib = _compile(tmp_path, name, edit)
    if name == "dft_rows":
        lib = build.load_dft_rows_library(lib)
        outs, ref = _run_rows(lib, ("cdft", (3,), 100, 45), "float32")
    else:
        monkeypatch.setattr(engine, "_CORE_CHUNK", 16)
        lib = build.load_core_library(lib)
        args = _core_inputs(CORE_CASES[1], seed=1)
        ref = engine.fused_core_plain(*args)
        outs = engine._launch_core(lib, *args, None)
    assert max(_rel_err(a, r) for a, r in zip(outs, ref)) > 2e-4
