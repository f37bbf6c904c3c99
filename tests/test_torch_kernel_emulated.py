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
recompute, dx adjoint, wgrad), the row DFTs and the partial-fusion core,
with shared and with per-mode weights (the core also at B = 1, 3 and 9,
ragged slices and tiles, and in many small chunks), and the core's plan
(``fused_core_plan``, read through the library) over every shape the
first core took.
This checks the kernels' indexing, chunking, masking, cluster exchange and
the wgrad kernel's batch reduction at every rank without a GPU; mutated
copies of the new sources (a dropped imaginary term, an off-by-one on a
ragged edge, a wrong mode index, a dropped conj; in the core also one TF32
pass in the CGEMM, the second sample group dropped, remote A read from
the wrong rank) must fail the same comparison. The card itself is checked
by tests/test_torch_kernel_gpu.py and chip_smoke.py.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.analysis import smem
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
KIND_CODES = {"rdft": 0, "irdft": 1, "cdft": 2}  # dft_rows_group / _smem


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
        assert src.count(mutation[0]) >= 1, mutation[0]
        src = src.replace(mutation[0], mutation[1], 1)
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
         "-fno-strict-aliasing",
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


def _caught(outs, refs, tol) -> bool:
    """A mutation is caught where an output misses its reference by more
    than `tol` or is not finite (a row never copied reads NaN in the
    emulation's shared memory; an element never written is whatever
    torch.empty left)."""
    return any(not _rel_err(a, r) <= tol for a, r in zip(outs, refs))


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
    dx through the adjoint bundle with the weights' transposed view, read
    through its strides as the fused path passes it (linear mode, no bias,
    emitted in f32), and dW, dW_b, dbias from the wgrad kernel, against
    the plain versions in f32 (bf16: 2e-2, f32: 2e-4)."""
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
    dx = engine._launch(emulated, gz, t(wr).t(), t(wi).t(), t(wb.t()), None,
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
# 128-row group), ragged widths (n, k off the product's tiles, k = 45 > 32),
# and the rank-3 outer transforms ((n2, n3), (k2, k3)) through the per-axis
# factors.
ROW_CASES = [("rdft", (3, 5), 37, 9), ("rdft", (130,), 20, 11),
             ("cdft", (3,), 100, 45), ("icdft", (3, 5), 37, 9),
             ("irdft", (130,), 20, 11), ("irdft", (2, 3), 100, 45),
             ("outer_fwd", (2, 3), (6, 10), (3, 4)),
             ("outer_inv", (2, 3), (6, 10), (3, 4))]


def _row_inputs(kind, lead, n, k, seed):
    """f32 inputs of one row case, and its operands at a dtype:
    dtype -> (operand pair, outer factor pair or None)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.tensor(rng.normal(size=lead + s),
                                 dtype=torch.float32)
    t = lambda kd, a, b, dt: spectral.row_operand_tensors(kd, (a,), (b,), dt,
                                                          "cpu")
    if kind == "outer_fwd":
        (n2, n3), (k2, k3) = n, k
        return (mk(n2, n3),), lambda dt: (t("cdft", n3, k3, dt),
                                          t("cdft", n2, k2, dt))
    if kind == "outer_inv":
        (n2, n3), (k2, k3) = n, k
        return (mk(k3, k2), mk(k3, k2)), lambda dt: (t("irdft", n3, k3, dt),
                                                     t("icdft", n2, k2, dt))
    width = n if kind in ("rdft", "cdft") else k
    ins = (mk(width),) if kind == "rdft" else (mk(width), mk(width))
    return ins, lambda dt: (spectral.row_operand_tensors(kind, (n,), (k,),
                                                         dt, "cpu"), None)


def _run_rows(lib, case, dtype, group=None):
    """(kernel outputs at `dtype`, f32 plain outputs) of one row case, in
    slab groups of at most `group` slabs (default: the wrapper's cap)."""
    kind, lead, n, k = case
    ins, mats = _row_inputs(kind, lead, n, k, seed=len(lead))
    m32, f32 = mats("float32")
    tdt = getattr(torch, dtype)
    args = tuple(a.to(tdt) for a in ins)
    if kind in ("cdft", "icdft"):
        ref = dft.cdft_plain(*ins, *m32)
        width, n_out = ins[0].shape[-1], m32[0].shape[1]
        return dft._launch_rows(lib, "cdft", args, mats(dtype)[0], None,
                                (1, width, 1, n_out), None,
                                group=group), ref
    if kind in ("outer_fwd", "outer_inv"):
        (n2, n3), (k2, k3) = n, k
        plain = (dft.outer_rdft_plain if kind == "outer_fwd"
                 else dft.outer_irdft_plain)
        ref = plain(*ins, f32, m32)
    else:
        n2, n3, k2, k3 = 1, n, 1, k
        ref = (dft.rdft_plain if kind == "rdft" else dft.irdft_plain)(*ins,
                                                                      *m32)
    launch = "rdft" if kind in ("rdft", "outer_fwd") else "irdft"
    outs = dft._launch_rows(lib, launch, args, *mats(dtype),
                            (n2, n3, k2, k3), None, group=group)
    return outs, ref if isinstance(ref, tuple) else (ref,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ROW_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_emulated_row_kernels_match_plain(emulated_rows, case, dtype):
    outs, ref = _run_rows(emulated_rows, case, dtype)
    for a, r in zip(outs, ref):
        assert a.dtype == getattr(torch, dtype) and a.shape == r.shape
        assert bool(torch.isfinite(a).all())
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


# The separable rdft / irdft with slab groups capped at `max rows` so that
# each of the 2 emulated blocks walks several double-buffered groups, the
# last one ragged: (kind, lead, n, k, max rows, slabs a group).
SLAB_CASES = [("outer_fwd", (7,), (6, 10), (3, 4), 12, 2),
              ("outer_inv", (7,), (6, 10), (3, 4), 12, 2),
              ("outer_fwd", (2, 5), (5, 9), (3, 5), 15, 3),
              ("outer_inv", (2, 5), (5, 9), (3, 5), 15, 3),
              ("outer_fwd", (3,), (5, 9), (3, 5), 256, 3),
              ("outer_inv", (3,), (5, 9), (3, 5), 256, 3),
              ("rdft", (37,), 24, 6, 8, 8), ("irdft", (37,), 24, 6, 8, 8),
              # 8 columns a thread in the product (every thread a tile)
              ("outer_fwd", (20,), (16, 64), (4, 32), 256, 16),
              ("irdft", (130,), 128, 9, 128, 128),
              # cdft on the row machinery, ragged rows and columns: one
              # group, two, and more groups than the grid's 2 blocks
              ("cdft", (5,), 100, 45, 64, 5),
              ("icdft", (7,), 37, 9, 4, 4),
              ("cdft", (37,), 24, 6, 8, 8),
              ("icdft", (130,), 20, 11, 64, 64),
              ("cdft", (2, 3), 128, 32, 1, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SLAB_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-g{c[5]}")
def test_emulated_slab_groups_match_plain(emulated_rows, case, dtype):
    """Rank-3 outer stage pairs at odd extents, the rank-2 one-stage path
    and cdft with both operands, several slabs (rows) a group and groups a
    block, against the plain versions (the reference's Kronecker-combined
    product at rank 3)."""
    kind, lead, n, k, max_rows, group = case
    outer = kind.startswith("outer")
    dims = ((n[0], n[1], k[0], k[1]) if outer else (1, k, 1, n)
            if kind == "icdft" else (1, n, 1, k))
    launch = {"outer_fwd": "rdft", "outer_inv": "irdft",
              "icdft": "cdft"}.get(kind, kind)
    cap = max(1, max_rows // dims[0])
    assert emulated_rows.dft_rows_group(
        KIND_CODES[launch], 0 if dtype == "float32" else 1, int(outer), cap,
        int(np.prod(lead)), *dims) == group
    outs, ref = _run_rows(emulated_rows, (kind, lead, n, k), dtype,
                          group=cap)
    for a, r in zip(outs, ref):
        assert a.dtype == getattr(torch, dtype) and a.shape == r.shape
        assert bool(torch.isfinite(a).all())
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_row_plan_matches_the_kernel_layout(emulated_rows, dtype):
    """kernels/dft.py's one-slab refusal uses the kernel's own layout, at
    fno3d's and fno2d's extents and odd ones, for any group size, for
    rdft, irdft and cdft (both operands); the launch takes the wrapper's
    cap at fno3d (cdft: fno2d's s_1 rows), and refuses a slab or row over
    the budget where the wrapper does."""
    code, esize = (0, 4) if dtype == "float32" else (1, 2)
    tdt = getattr(torch, dtype)
    rows = [(False, (1, 128, 1, 32)), (False, (1, 37, 1, 9)),
            (False, (1, 100, 1, 45))]
    shapes = [(True, (64, 64, 16, 16)), (True, (6, 10, 3, 4)),
              (True, (5, 9, 3, 5))] + rows
    for kind in ("rdft", "irdft", "cdft"):
        for outer, dims in (rows + [(False, (1, 32, 1, 128))]
                            if kind == "cdft" else shapes):
            for g in (1, 2, 3, 4, 7, 64):
                assert emulated_rows.dft_rows_smem(
                    KIND_CODES[kind], code, int(outer), g,
                    *dims) == dft.smem_bytes(kind, esize, outer, g,
                                             *dims), (kind, dims, g)
        # The cap at fno3d's slabs, at fno2d's s_1 rows for cdft; one
        # slab (row) over the budget refused on both sides.
        outer = kind != "cdft"
        cap = dft.max_group(kind, tdt, 64 if outer else 1, outer)
        dims = (64, 64, 16, 16) if outer else (1, 128, 1, 32)
        assert emulated_rows.dft_rows_group(
            KIND_CODES[kind], code, int(outer), cap, 16384, *dims) == cap
        big = (256, 256, 64, 64) if outer else (1, 512, 1, 128)
        assert emulated_rows.dft_rows_group(KIND_CODES[kind], code,
                                            int(outer), 1, 4, *big) == 0
        with pytest.raises(ValueError, match="shared memory"):
            dft.check_slab(kind, tdt, big, outer)
    err = emulated_rows.dft_rows_rdft(code, None, None, None, None, None,
                                      None, None, 4, 256, 256, 64, 64, 1,
                                      None)
    assert err != 0
    assert "invalid" in emulated_rows.dft_rows_error_string(err).decode()


# Mutations of the separable kernels that the slab comparisons must catch:
# (what, (old, new) in dft_rows.cu or (header, old, new), row case, dtype).
ROW_MUTATIONS = [
    ("K2 and K3 swapped in the output index",
     ("const long long at = ((slab0 + gi) * k3 + a0 + i) * k2 + b0;",
      "const long long at = ((slab0 + gi) * k2 + b0) * k3 + a0 + i;"),
     ("outer_fwd", (2, 3), (6, 10), (3, 4)), "float32"),
    ("the -Ui*Ei sign dropped",
     ("v = r < L.hb ? ld(a.m3r + m * n3 + s) : -ld(a.m3i + m * n3 + s);",
      "v = r < L.hb ? ld(a.m3r + m * n3 + s) : ld(a.m3i + m * n3 + s);"),
     ("outer_inv", (2, 3), (6, 10), (3, 4)), "float32"),
    ("the tensor-core product's depth offset dropped",
     ("tc_common.cuh", "load_a(a[i].hi, A + 16 * i * lda + k, lda);",
      "load_a(a[i].hi, A + 16 * i * lda, lda);"),
     ("rdft", (3, 5), 37, 9), "bfloat16"),
]


@pytest.mark.parametrize("mutation", ROW_MUTATIONS,
                         ids=lambda m: m[0].replace(" ", "_"))
def test_emulated_row_mutations_are_caught(tmp_path, mutation):
    _, edit, case, dtype = mutation
    lib = build.load_dft_rows_library(
        _compile(tmp_path, "dft_rows", edit) if len(edit) == 2
        else _compile(tmp_path, "dft_rows", header_mutation=edit))
    outs, ref = _run_rows(lib, case, dtype)
    assert _caught(outs, ref, 2e-4 if dtype == "float32" else 2e-2)


# Core cases (B, H, O, s_1, K_1, K_R..K_2): rank 2 and 3 spectra, odd
# extents, channel counts off the cluster's slices, and no outer axis.
CORE_CASES = [(2, 8, 6, 16, 5, (9,)), (1, 5, 7, 33, 4, (3, 5)),
              (2, 3, 2, 10, 10, ())]
# Forced plan fields (engine.CORE_LAUNCH): "chunked" runs every phase in
# several ragged chunks (4 s_1 rows of z and F, one mode k_1 of the CGEMM,
# 8 points of G) across a cluster of 2.
CORE_CHUNKS = {"one": {}, "chunked": {"cluster": 2, "ri": 4, "kc": 1,
                                      "wj": 8}}


def _launch_core(lib, args, force):
    """The core through `lib` at its plan with the fields `force` pinned
    (engine.FORCED["core"])."""
    with engine.forced_chain(core=force):
        return engine._launch_core(lib, *args, None)


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
@pytest.mark.parametrize("chunk", list(CORE_CHUNKS.values()),
                         ids=list(CORE_CHUNKS))
@pytest.mark.parametrize("case", CORE_CASES, ids=str)
def test_emulated_core_matches_plain(emulated_core, case, chunk, dtype):
    """The partial-fusion core against its plain version, at its plan and
    with every phase in several ragged chunks."""
    args = _core_inputs(case, seed=case[3])
    ref = engine.fused_core_plain(*args)
    tdt = getattr(torch, dtype)
    y = _launch_core(emulated_core, [a.to(tdt) for a in args], chunk)
    for a, r in zip(y, ref):
        assert a.dtype == tdt and a.shape == r.shape
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


# (B, H, O, s_1, K_1, K_R..K_2, per-mode, forced plan): one sample; ragged
# hidden and out slices (5 and 7 over 2 ranks) and a ragged column tile
# (P = 5 in tiles of 4); rank 3 with K_2 != K_3 and per-mode W at B=3; B=9,
# a second sample group of one, per-mode and shared; and F and G streamed
# in many small pieces (4 rows, 8 points) with one mode a CGEMM chunk.
CORE_EDGES = [
    (1, 5, 7, 10, 4, (5,), False, {"cluster": 2, "np": 4}),
    (3, 6, 5, 12, 5, (3, 4), True, {"cluster": 2, "ri": 4}),
    (9, 4, 4, 8, 3, (6,), True, {"cluster": 2}),
    (9, 4, 6, 8, 3, (2, 3), False, {}),
    (2, 4, 4, 40, 12, (3,), False, {"ri": 4, "wj": 8, "kc": 1}),
]


def _edge_inputs(case, seed):
    b, h, o, n1, k1, spec, per_mode, _ = case
    args = _core_inputs((b, h, o, n1, k1, spec), seed)
    if per_mode:  # [O,H,K_1,K_2..K_R]: the modes reversed against z's
        rng = np.random.default_rng(seed + 1)
        w = lambda: torch.tensor(rng.normal(size=(o, h, k1) + spec[::-1])
                                 / h, dtype=torch.float32)
        args[2:4] = [w(), w()]
    return args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CORE_EDGES,
                         ids=lambda c: "B{}-h{}-o{}-s{}-k{}-{}-{}".format(
                             c[0], c[1], c[2], c[3], c[4],
                             "x".join(map(str, c[5])),
                             "pm" if c[6] else "shared"))
def test_emulated_core_batches_and_edges(emulated_core, case, dtype):
    """The core at B = 1, 3 and 9 (a second sample group), ragged slices
    and tiles, rank 3 with K_2 != K_3, per-mode and shared W, and the
    factors streamed in small pieces, against its plain version."""
    args = _edge_inputs(case, seed=case[3] + case[0])
    ref = engine.fused_core_plain(*args)
    tdt = getattr(torch, dtype)
    y = _launch_core(emulated_core, [a.to(tdt) for a in args], case[7])
    for a, r in zip(y, ref):
        assert a.dtype == tdt and a.shape == r.shape
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


# The (hidden, rank, N, modes, per-mode) pairs the slice-1 core's planner
# took (engine.core_plan at 87c7a88, which depended on hidden, out, s_1
# and K_1 alone) over hidden 16–128, 2D 64²–512² and 3D 32³–128³, modes 8
# up to min(N/2, 64): 188 of 192 (it refused shared W at hidden 128,
# modes 64).
PARENT_CORE_PLANNED = [
    (16, 2, 64, 8, 0), (16, 2, 64, 8, 1), (16, 2, 64, 16, 0),
    (16, 2, 64, 16, 1), (16, 2, 64, 32, 0), (16, 2, 64, 32, 1),
    (16, 2, 128, 8, 0), (16, 2, 128, 8, 1), (16, 2, 128, 16, 0),
    (16, 2, 128, 16, 1), (16, 2, 128, 32, 0), (16, 2, 128, 32, 1),
    (16, 2, 128, 64, 0), (16, 2, 128, 64, 1), (16, 2, 256, 8, 0),
    (16, 2, 256, 8, 1), (16, 2, 256, 16, 0), (16, 2, 256, 16, 1),
    (16, 2, 256, 32, 0), (16, 2, 256, 32, 1), (16, 2, 256, 64, 0),
    (16, 2, 256, 64, 1), (16, 2, 512, 8, 0), (16, 2, 512, 8, 1),
    (16, 2, 512, 16, 0), (16, 2, 512, 16, 1), (16, 2, 512, 32, 0),
    (16, 2, 512, 32, 1), (16, 2, 512, 64, 0), (16, 2, 512, 64, 1),
    (16, 3, 32, 8, 0), (16, 3, 32, 8, 1), (16, 3, 32, 16, 0),
    (16, 3, 32, 16, 1), (16, 3, 64, 8, 0), (16, 3, 64, 8, 1),
    (16, 3, 64, 16, 0), (16, 3, 64, 16, 1), (16, 3, 64, 32, 0),
    (16, 3, 64, 32, 1), (16, 3, 128, 8, 0), (16, 3, 128, 8, 1),
    (16, 3, 128, 16, 0), (16, 3, 128, 16, 1), (16, 3, 128, 32, 0),
    (16, 3, 128, 32, 1), (16, 3, 128, 64, 0), (16, 3, 128, 64, 1),
    (32, 2, 64, 8, 0), (32, 2, 64, 8, 1), (32, 2, 64, 16, 0),
    (32, 2, 64, 16, 1), (32, 2, 64, 32, 0), (32, 2, 64, 32, 1),
    (32, 2, 128, 8, 0), (32, 2, 128, 8, 1), (32, 2, 128, 16, 0),
    (32, 2, 128, 16, 1), (32, 2, 128, 32, 0), (32, 2, 128, 32, 1),
    (32, 2, 128, 64, 0), (32, 2, 128, 64, 1), (32, 2, 256, 8, 0),
    (32, 2, 256, 8, 1), (32, 2, 256, 16, 0), (32, 2, 256, 16, 1),
    (32, 2, 256, 32, 0), (32, 2, 256, 32, 1), (32, 2, 256, 64, 0),
    (32, 2, 256, 64, 1), (32, 2, 512, 8, 0), (32, 2, 512, 8, 1),
    (32, 2, 512, 16, 0), (32, 2, 512, 16, 1), (32, 2, 512, 32, 0),
    (32, 2, 512, 32, 1), (32, 2, 512, 64, 0), (32, 2, 512, 64, 1),
    (32, 3, 32, 8, 0), (32, 3, 32, 8, 1), (32, 3, 32, 16, 0),
    (32, 3, 32, 16, 1), (32, 3, 64, 8, 0), (32, 3, 64, 8, 1),
    (32, 3, 64, 16, 0), (32, 3, 64, 16, 1), (32, 3, 64, 32, 0),
    (32, 3, 64, 32, 1), (32, 3, 128, 8, 0), (32, 3, 128, 8, 1),
    (32, 3, 128, 16, 0), (32, 3, 128, 16, 1), (32, 3, 128, 32, 0),
    (32, 3, 128, 32, 1), (32, 3, 128, 64, 0), (32, 3, 128, 64, 1),
    (64, 2, 64, 8, 0), (64, 2, 64, 8, 1), (64, 2, 64, 16, 0),
    (64, 2, 64, 16, 1), (64, 2, 64, 32, 0), (64, 2, 64, 32, 1),
    (64, 2, 128, 8, 0), (64, 2, 128, 8, 1), (64, 2, 128, 16, 0),
    (64, 2, 128, 16, 1), (64, 2, 128, 32, 0), (64, 2, 128, 32, 1),
    (64, 2, 128, 64, 0), (64, 2, 128, 64, 1), (64, 2, 256, 8, 0),
    (64, 2, 256, 8, 1), (64, 2, 256, 16, 0), (64, 2, 256, 16, 1),
    (64, 2, 256, 32, 0), (64, 2, 256, 32, 1), (64, 2, 256, 64, 0),
    (64, 2, 256, 64, 1), (64, 2, 512, 8, 0), (64, 2, 512, 8, 1),
    (64, 2, 512, 16, 0), (64, 2, 512, 16, 1), (64, 2, 512, 32, 0),
    (64, 2, 512, 32, 1), (64, 2, 512, 64, 0), (64, 2, 512, 64, 1),
    (64, 3, 32, 8, 0), (64, 3, 32, 8, 1), (64, 3, 32, 16, 0),
    (64, 3, 32, 16, 1), (64, 3, 64, 8, 0), (64, 3, 64, 8, 1),
    (64, 3, 64, 16, 0), (64, 3, 64, 16, 1), (64, 3, 64, 32, 0),
    (64, 3, 64, 32, 1), (64, 3, 128, 8, 0), (64, 3, 128, 8, 1),
    (64, 3, 128, 16, 0), (64, 3, 128, 16, 1), (64, 3, 128, 32, 0),
    (64, 3, 128, 32, 1), (64, 3, 128, 64, 0), (64, 3, 128, 64, 1),
    (128, 2, 64, 8, 0), (128, 2, 64, 8, 1), (128, 2, 64, 16, 0),
    (128, 2, 64, 16, 1), (128, 2, 64, 32, 0), (128, 2, 64, 32, 1),
    (128, 2, 128, 8, 0), (128, 2, 128, 8, 1), (128, 2, 128, 16, 0),
    (128, 2, 128, 16, 1), (128, 2, 128, 32, 0), (128, 2, 128, 32, 1),
    (128, 2, 128, 64, 1), (128, 2, 256, 8, 0), (128, 2, 256, 8, 1),
    (128, 2, 256, 16, 0), (128, 2, 256, 16, 1), (128, 2, 256, 32, 0),
    (128, 2, 256, 32, 1), (128, 2, 256, 64, 1), (128, 2, 512, 8, 0),
    (128, 2, 512, 8, 1), (128, 2, 512, 16, 0), (128, 2, 512, 16, 1),
    (128, 2, 512, 32, 0), (128, 2, 512, 32, 1), (128, 2, 512, 64, 1),
    (128, 3, 32, 8, 0), (128, 3, 32, 8, 1), (128, 3, 32, 16, 0),
    (128, 3, 32, 16, 1), (128, 3, 64, 8, 0), (128, 3, 64, 8, 1),
    (128, 3, 64, 16, 0), (128, 3, 64, 16, 1), (128, 3, 64, 32, 0),
    (128, 3, 64, 32, 1), (128, 3, 128, 8, 0), (128, 3, 128, 8, 1),
    (128, 3, 128, 16, 0), (128, 3, 128, 16, 1), (128, 3, 128, 32, 0),
    (128, 3, 128, 32, 1), (128, 3, 128, 64, 1),
]


@pytest.mark.parametrize("shape", PARENT_CORE_PLANNED,
                         ids=lambda s: "h{}-{}d-{}-m{}-{}".format(
                             *s[:4], "pm" if s[4] else "shared"))
def test_every_shape_the_first_core_planned_is_planned(emulated_core, shape):
    """The shape range is kept: the library's plan (fused_core_plan) takes
    every pair the first core took, at B = 1, 8, 9 and 128, f32 and bf16,
    within a block's shared memory and the grid's limits (the launch's
    grid is (cluster, column tiles, sample groups)); a per-mode plan
    groups min(B, 8) samples, so it reads W once a group."""
    hidden, rank, n, m, per_mode = shape
    p = m ** (rank - 1)
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 8, 9, 128):
            plan = engine.core_plan(emulated_core, dtype, b, hidden, hidden,
                                    n, m, p, bool(per_mode), m)
            assert plan["smem"] <= engine._SMEM_LIMIT
            assert plan["cluster"] * plan["hs"] >= hidden
            assert plan["ptiles"] <= GRID_YZ and plan["groups"] <= GRID_YZ
            if per_mode:
                assert plan["nb"] == min(b, 8)
                assert plan["w_bytes"] == (plan["groups"] * 2 * hidden
                                           * hidden * m * p * dtype.itemsize)


# Largest grid extent along y and z: the core's grid is (cluster, column
# tiles, sample groups).
GRID_YZ = 65535


def test_core_footprint_through_the_library(emulated_core):
    """The shared-memory check estimates the core's launch through its
    library (``fused_core_plan``, the one source of its layout) at the
    smallest shape of the partial path (reduced fno2d, B=2): the plan the
    launch takes, within a block; without the library the core is
    reported as not estimated."""
    cfg = configs.get_config("fno2d", reduced=True)
    est = smem.launch_estimate(cfg, "core", batch=2, lib=emulated_core)
    n1, (k1, k2) = cfg.spatial[0], cfg.modes
    assert est.fits and est.source == "rule"
    assert est.plan == engine.core_plan(emulated_core, torch.float32, 2,
                                        cfg.hidden, cfg.hidden, n1, k1, k2)
    assert smem.check_smem([cfg], libs={"core": emulated_core}) == []
    blind = smem.launch_estimate(cfg, "core", batch=2)
    assert not blind.fits and blind.error.startswith("not estimated")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_core_plan_holds_the_grid_limits(emulated_core, dtype):
    """The plan the library gives is one the card launches: at 3D 128³
    modes 64 with shared W (P = 4096 columns) B = 64 and 128 take 65,536
    tiles and more, which a grid of one tile axis could not hold, and a
    plan past the grid's limits (65,536 sample groups) is refused, not
    launched."""
    h, n, m = 16, 128, 64
    p = m * m
    for b in (64, 128):
        plan = engine.core_plan(emulated_core, dtype, b, h, h, n, m, p,
                                False, m)
        assert plan["ptiles"] <= GRID_YZ and plan["groups"] <= GRID_YZ
    assert plan["groups"] * plan["ptiles"] > GRID_YZ
    for b, per_mode in ((GRID_YZ + 1, False), (8 * GRID_YZ + 1, True)):
        with pytest.raises(ValueError, match="grid"):
            engine.core_plan(emulated_core, dtype, b, h, h, n, m, p,
                             per_mode, m)


# Mutations of the new sources, each of which the comparisons above must
# catch: (source, what, (old, new)), or (header, old, new) for a header the
# source includes. cdft's: the stacked operand's −Fi block dropped (the
# −xi·Fi term of yr), and one row fewer copied at each group's ragged edge.
MUTATIONS = [
    ("dft_rows", "dropped imaginary term",
     ("load_rows(neg_fi, L.ldb, a.m3i, n, k, a.vec_op);", "")),
    ("dft_rows", "off-by-one on the ragged input edge",
     ("const int nrows = min(G, a.slabs - grp * G);",
      "const int nrows = min(G, a.slabs - grp * G - 1);")),
    ("fused_core", "dropped imaginary term",
     ("chain_tc.cuh", "br[1] = im ^ 0x80000000u;  // −F_i", "br[1] = 0u;")),
    ("fused_core", "off-by-one on the ragged chunk edge",
     ("const int c0 = q * L.ri, nv = min(L.ri, n1 - c0);",
      "const int c0 = q * L.ri, nv = min(L.ri, n1 - c0 - 1);")),
    ("fused_core", "one-pass TF32 CGEMM",
     ("constexpr bool kWLo = std::is_same<T, float>::value, kALo = true;",
      "constexpr bool kWLo = false, kALo = false;")),
    ("fused_core", "remote A read from the wrong rank",
     ("cluster.map_shared_rank(A, q)",
      "cluster.map_shared_rank(A, (q + 1) % cl)")),
]


@pytest.mark.parametrize("mutation", MUTATIONS,
                         ids=lambda m: f"{m[0]}-{m[1].replace(' ', '_')}")
def test_emulated_mutations_are_caught(tmp_path, monkeypatch, mutation):
    name, _, edit = mutation
    lib = (_compile(tmp_path, name, edit) if len(edit) == 2
           else _compile(tmp_path, name, header_mutation=edit))
    if name == "dft_rows":
        lib = build.load_dft_rows_library(lib)
        outs, ref = _run_rows(lib, ("cdft", (3,), 100, 45), "float32")
    else:  # several ragged chunks across a cluster of 2
        lib = build.load_core_library(lib)
        args = _core_inputs(CORE_CASES[1], seed=1)
        ref = engine.fused_core_plain(*args)
        outs = _launch_core(lib, args, CORE_CHUNKS["chunked"])
    assert _caught(outs, ref, 2e-4)


# One TF32 pass: the two small terms of 3xTF32 (tc_common.cuh) dropped.
ONE_PASS_TF32 = (
    "tc_common.cuh",
    "mma_tf32(d, a.lo, b.hi);\n    mma_tf32(d, a.hi, b.lo);\n", "")


def test_emulated_one_pass_tf32_is_caught(tmp_path):
    """f32 runs three TF32 products (3xTF32); keeping only hi·hi, one TF32
    pass, misses the f32 tolerance (about 4× over it) at a depth of 2·104
    (cdft 100 → 45), which the unmutated kernel holds."""
    case = ROW_CASES[2]
    outs, ref = _run_rows(
        build.load_dft_rows_library(_compile(tmp_path, "dft_rows")), case,
        "float32")
    assert not _caught(outs, ref, 2e-4)
    mutated = tmp_path / "one_pass"
    mutated.mkdir()
    lib = build.load_dft_rows_library(
        _compile(mutated, "dft_rows", header_mutation=ONE_PASS_TF32))
    outs, ref = _run_rows(lib, case, "float32")
    assert _caught(outs, ref, 2e-4)


# The wgrad kernel at ranks 1–3 with B=5, more clusters than the emulated
# card holds at once, and point counts whose dW_b split (chunks of
# plan["cols"] points, consecutive chunks a block) leaves a ragged last
# chunk in the last block: (spatial, modes, B, H, O).
WGRAD_CASES = [((100,), (30,), 5, 3, 5), ((12, 20), (4, 6), 5, 6, 6),
               ((5, 6, 7), (3, 3, 4), 5, 4, 6)]


def _wgrad_run(lib, case, dtype, per_mode=False, bypass=True, seed=0):
    """(kernel outputs at `dtype`, f32 plain outputs) of one wgrad case."""
    spatial, modes, b, h, o = case
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(b, h) + spatial), dtype=torch.float32)
    gz = torch.tensor(rng.normal(size=(b, o) + spatial), dtype=torch.float32)
    tdt = getattr(torch, dtype)
    mats = spectral.operand_tensors(spatial, modes, dtype, "cpu", "wgrad")
    outs = engine._launch_wgrad(lib, x.to(tdt), gz.to(tdt), mats, spatial,
                                modes, None, per_mode=per_mode,
                                with_bypass=bypass)
    m32 = spectral.operand_tensors(spatial, modes, "float32", "cpu", "wgrad")
    return outs, engine.fused_wgrad_plain(x, gz, m32, per_mode=per_mode,
                                          with_bypass=bypass)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bypass", [True, False], ids=["bypass", "bare"])
@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("case", WGRAD_CASES,
                         ids=lambda c: f"rank{len(c[0])}")
def test_emulated_wgrad_modes_match_plain(emulated_wgrad, case, per_mode,
                                          bypass, dtype):
    """Every mode of the wgrad kernel (shared or per-mode W, with or
    without the bypass) against its plain version: f32 within 2e-4, bf16
    within 2e-2 of the f32 plain version."""
    spatial, modes, b, h, o = case
    plan = engine.wgrad_plan(h, o, spatial, modes, per_mode=per_mode)
    pts = int(np.prod(spatial))
    assert b > EMULATED_MAX_CLUSTERS and pts % plan["cols"] != 0
    assert -(-pts // plan["cols"]) >= plan["cluster"]
    outs, refs = _wgrad_run(emulated_wgrad, case, dtype, per_mode, bypass,
                            seed=len(spatial))
    assert len(outs) == len(refs) == (4 if bypass else 2)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for a, r in zip(outs, refs):
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert bool(torch.isfinite(a).all())
        assert _rel_err(a, r) <= tol


def test_emulated_wgrad_plan_matches_the_kernel_layout(emulated_wgrad):
    """kernels/engine.py's shared-memory plan is the kernel's own layout
    (fused_wgrad_smem), f32 and bf16, with and without the bypass, shared
    and per-mode W, at the presets' widths, odd ones and two whose chain is
    the CUDA cores' (2D 256² modes 32 at hidden 64: the resident factors do
    not fit; 1D 2048 modes 512: the accumulator tiles do not)."""
    shapes = [(64, 64, (128, 128), (32, 32)), (32, 32, (64, 64, 64),
                                               (16, 16, 16)),
              (128, 128, (128, 128), (32, 32)), (64, 64, (256,), (64,)),
              (64, 64, (256, 256), (32, 32)), (16, 16, (2048,), (512,))]
    shapes += [(h, o, s, m) for s, m, _, h, o in WGRAD_CASES + CASES[:3]]
    for h, o, spatial, modes in shapes:
        for per_mode in (False, True):
            plan = engine.wgrad_plan(h, o, spatial, modes, per_mode=per_mode)
            r = len(spatial)
            dims = engine._dims(1, h, o, spatial, modes)
            for bypass in (True, False):
                pl = engine.wgrad_ints(plan, per_mode, 1, bypass)
                for code, esize in ((0, 4), (1, 2)):
                    want = engine._wgrad_bytes(
                        esize, h, o, spatial, modes, plan["hs"], plan["os"],
                        plan["rows_f"], plan["cols"], bypass,
                        plan["chain"])[0]
                    got = emulated_wgrad.fused_wgrad_smem(code, r, dims, pl)
                    assert got == want <= plan["smem"], (h, spatial, bypass)
            assert plan["smem"] == engine._wgrad_bytes(
                4, h, o, spatial, modes, plan["hs"], plan["os"],
                plan["rows_f"], plan["cols"], chain=plan["chain"])[0]


# Mutations of the wgrad kernel that its comparisons must catch: (what,
# (old, new) in fused_wgrad.cu or (header, old, new), case index, dtype).
WGRAD_MUTATIONS = [
    ("one cluster rank's dW_b partial dropped",
     ("for (int q = 0; q < cl; ++q) s += cluster.map_shared_rank(part, q)",
      "for (int q = 0; q < cl - 1; ++q) s += cluster.map_shared_rank(part, "
      "q)"), 1, "float32"),
    ("an off-by-one at the ragged point edge",
     ("const int p0 = q * cp, nv = min(cp, S - p0);",
      "const int p0 = q * cp, nv = min(cp, S - p0 - 1);"), 1, "float32"),
    ("one TF32 pass in the chain",
     ("chain_tc.cuh",
      "#pragma unroll\n    for (int i = 0; i < N; ++i) tc::mma_tf32(s[i], "
      "a[i].lo, b[i].hi);\n#pragma unroll\n    for (int i = 0; i < N; ++i) "
      "tc::mma_tf32(s[i], a[i].hi, b[i].lo);\n", ""), 2, "float32"),
]


@pytest.mark.parametrize("mutation", WGRAD_MUTATIONS,
                         ids=lambda m: m[0].replace(" ", "_"))
def test_emulated_wgrad_mutations_are_caught(tmp_path, emulated_wgrad,
                                             mutation):
    """Each mutation fails the comparison that the unmutated kernel
    passes."""
    _, edit, index, dtype = mutation
    case = WGRAD_CASES[index]
    outs, refs = _wgrad_run(emulated_wgrad, case, dtype, seed=9)
    assert not _caught(outs, refs, 2e-4)
    lib = build.load_wgrad_library(
        _compile(tmp_path, "fused_wgrad", edit) if len(edit) == 2
        else _compile(tmp_path, "fused_wgrad", header_mutation=edit))
    outs, refs = _wgrad_run(lib, case, dtype, seed=9)
    assert _caught(outs, refs, 2e-4)


# Per-mode weights [O,H,k_1..k_R]: the odd extents at ranks 1–3 and a
# cluster of 16 blocks with one hidden channel each.
PM_CASES = [CASES[0], CASES[1], CASES[2], CASES[6]]


def _per_mode_inputs(spatial, modes, b, h, o, seed):
    x, _, _, wb, bias = _inputs(spatial, b, h, o, seed)
    rng = np.random.default_rng(seed + 1)
    w = lambda: torch.tensor(rng.normal(size=(o, h) + modes) / h,
                             dtype=torch.float32)
    return [x, w(), w(), wb, bias]


def _per_mode_launches(lib, wlib, args, gy, spatial, modes, dtype):
    """The per-mode forward, gz recompute, dx adjoint (weights as the
    transposed view ops passes), bare spectral layer and wgrad launches at
    `dtype`; returns their outputs in that order."""
    tdt = getattr(torch, dtype)
    x, wr, wi, wb, bias = [a.to(tdt) for a in args]
    mats = {k: spectral.operand_tensors(spatial, modes, dtype, "cpu", k)
            for k in ("forward", "adjoint", "wgrad")}
    run = lambda *a, **kw: engine._launch(lib, *a, spatial, modes, None,
                                          **kw)
    y = run(x, wr, wi, wb, bias, mats["forward"])
    gz = run(x, wr, wi, wb, bias, mats["forward"], act="gelu_vjp",
             gy=gy.to(tdt))
    dx = run(gz, wr.transpose(0, 1), wi.transpose(0, 1),
             wb.t().contiguous(), None, mats["adjoint"], act="linear",
             out_dtype=torch.float32)
    bare = run(x, wr, wi, None, None, mats["forward"], act="linear")
    dw = engine._launch_wgrad(wlib, x, gz, mats["wgrad"], spatial, modes,
                              None, per_mode=True)
    return (y, gz, dx, bare) + tuple(dw)


def _per_mode_plain(args, gy, gz, spatial, modes):
    x, wr, wi, wb, bias = args
    m32 = {k: spectral.operand_tensors(spatial, modes, "float32", "cpu", k)
           for k in ("forward", "adjoint", "wgrad")}
    plain = engine.fused_block_plain
    gz = gz.float()
    return ((plain(x, wr, wi, wb, bias, m32["forward"]),
             plain(x, wr, wi, wb, bias, m32["forward"], act="gelu_vjp",
                   gy=gy),
             plain(gz, wr.transpose(0, 1), wi.transpose(0, 1),
                   wb.t().contiguous(), None, m32["adjoint"], act="linear"),
             plain(x, wr, wi, None, None, m32["forward"], act="linear"))
            + engine.fused_wgrad_plain(x, gz, m32["wgrad"], per_mode=True))


_PM_NAMES = ("y", "gz", "dx", "bare", "dwr", "dwi", "dwb", "dbias")


@pytest.mark.parametrize("chunk,dtype", [(None, "float32"),
                                         (None, "bfloat16"),
                                         (7, "float32")],
                         ids=["chunk_fits-f32", "chunk_fits-bf16",
                              "chunk_7-f32"])
@pytest.mark.parametrize("case", PM_CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_emulated_per_mode_kernels_match_plain(emulated, emulated_wgrad,
                                               monkeypatch, case, chunk,
                                               dtype):
    """Per-mode weights through every block-kernel mode (the dx adjoint
    reads the [H,O,K] swap through strides) and the per-mode wgrad, whose
    batch reduction runs over chunks of modes (chunk_7: ragged ones) and
    reads every cluster rank's spectra (the clusters of 16 case: one
    hidden channel per rank), against the plain versions (f32 2e-4; bf16
    2e-2 of the f32 chain)."""
    spatial, modes, b, h, o = case
    if chunk is not None:
        monkeypatch.setattr(engine, "wgrad_mode_chunk",
                            lambda *a: chunk)
    args = _per_mode_inputs(spatial, modes, b, h, o, seed=80 + len(spatial))
    gy = torch.randn((b, o) + spatial,
                     generator=torch.Generator().manual_seed(o))
    outs = _per_mode_launches(emulated, emulated_wgrad, args, gy, spatial,
                              modes, dtype)
    refs = _per_mode_plain(args, gy, outs[1], spatial, modes)
    tol = 2e-4 if dtype == "float32" else 2e-2
    assert tuple(outs[4].shape) == (o, h) + modes
    for name, a, ref in zip(_PM_NAMES, outs, refs):
        assert a.shape == ref.shape and bool(torch.isfinite(a).all()), name
        assert _rel_err(a, ref) <= tol, (name, _rel_err(a, ref))


def _per_mode_core_inputs(case, seed):
    args = _core_inputs(case, seed)
    b, h, o, n1, k1, spec = case
    rng = np.random.default_rng(seed + 1)
    w = lambda: torch.tensor(rng.normal(size=(o, h, k1) + spec[::-1]) / h,
                             dtype=torch.float32)
    return args[:2] + [w(), w()] + args[4:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CORE_CASES, ids=str)
def test_emulated_per_mode_core_matches_plain(emulated_core, case, dtype):
    """The core with per-mode weights [O,H,K_1,K_2..K_R] (their mode order
    reversed against the spectrum's K_R..K_2), every phase in several
    chunks."""
    args = _per_mode_core_inputs(case, seed=case[3] + 1)
    ref = engine.fused_core_plain(*args)
    tdt = getattr(torch, dtype)
    y = _launch_core(emulated_core, [a.to(tdt) for a in args],
                     CORE_CHUNKS["chunked"])
    for a, r in zip(y, ref):
        assert a.dtype == tdt and a.shape == r.shape
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


# Mutations of the per-mode paths: (source, what, (old, new)).
PER_MODE_MUTATIONS = [
    ("fused_block", "wrong mode index",  # the untiled kernel's line
     ("const size_t wbase = static_cast<size_t>(o0) * a.w_so + kk;\n"
      "    float cr[kMaxOut]",
      "const size_t wbase = static_cast<size_t>(o0) * a.w_so + (kk ^ 1);\n"
      "    float cr[kMaxOut]")),
    ("fused_wgrad", "dropped conj",
     ("a.dwi[at] = -acci[u][o];  // conj", "a.dwi[at] = acci[u][o];")),
    ("fused_core", "wrong mode index",
     ("? src[(pp % a.K2) * (P / a.K2) + pp / a.K2]", "? src[pp]")),
    ("fused_core", "second sample group dropped",
     ("t.nbv = min(L.nb, a.B - t.b0);",
      "t.nbv = grp > 0 ? 0 : min(L.nb, a.B - t.b0);")),
]


@pytest.mark.parametrize("mutation", PER_MODE_MUTATIONS,
                         ids=lambda m: f"{m[0]}-{m[1].replace(' ', '_')}")
def test_emulated_per_mode_mutations_are_caught(tmp_path, monkeypatch,
                                                mutation):
    name, what, edit = mutation
    lib = _compile(tmp_path, name, edit)
    if name == "fused_core":  # rank 3: K_2 != K_3, so p and pm differ;
        lib = build.load_core_library(lib)  # B=9: two sample groups
        case = CORE_CASES[1] if what == "wrong mode index" \
            else CORE_EDGES[2][:6]
        args = _per_mode_core_inputs(case, seed=2)
        outs = _launch_core(lib, args, {"cluster": 2})
        refs = engine.fused_core_plain(*args)
    else:
        spatial, modes, b, h, o = CASES[1]
        args = _per_mode_inputs(spatial, modes, b, h, o, seed=90)
        x, wr, wi, wb, bias = args
        m = {k: spectral.operand_tensors(spatial, modes, "float32", "cpu", k)
             for k in ("forward", "wgrad")}
        if name == "fused_block":
            lib = build.load_block_library(lib)
            outs = (engine._launch(lib, *args, m["forward"], spatial, modes,
                                   None),)
            refs = (engine.fused_block_plain(*args, m["forward"]),)
        else:
            lib = build.load_wgrad_library(lib)
            gz = torch.randn((b, o) + spatial,
                             generator=torch.Generator().manual_seed(3))
            outs = engine._launch_wgrad(lib, x, gz, m["wgrad"], spatial,
                                        modes, None, per_mode=True)
            refs = engine.fused_wgrad_plain(x, gz, m["wgrad"], per_mode=True)
    assert _caught(outs, refs, 2e-4)


def test_emulated_per_mode_waves_of_16_block_clusters(emulated,
                                                      emulated_wgrad):
    """72 out channels need clusters of 16 (the portable 8 would take 9
    per block); a batch of 5 is more than the emulated card holds at once
    (4), so the launch runs in waves — per-mode forward and wgrad."""
    spatial, modes, b, h, o = (12,), (4,), 5, 72, 72
    assert engine.pick_plan(emulated, 0, b, h, o, spatial, modes,
                            True)["cluster"] == 16
    assert engine.pick_wgrad_plan(emulated_wgrad, 0, b, h, o, spatial, modes,
                                  True)["cluster"] == 16
    args = _per_mode_inputs(spatial, modes, b, h, o, seed=95)
    gz = torch.randn((b, o) + spatial,
                     generator=torch.Generator().manual_seed(96))
    m = {k: spectral.operand_tensors(spatial, modes, "float32", "cpu", k)
         for k in ("forward", "wgrad")}
    y = engine._launch(emulated, *args, m["forward"], spatial, modes, None)
    assert _rel_err(y, engine.fused_block_plain(*args, m["forward"])) <= 2e-4
    dw = engine._launch_wgrad(emulated_wgrad, args[0], gz, m["wgrad"],
                              spatial, modes, None, per_mode=True)
    ref = engine.fused_wgrad_plain(args[0], gz, m["wgrad"], per_mode=True)
    for a, r in zip(dw, ref):
        assert _rel_err(a, r) <= 2e-4
