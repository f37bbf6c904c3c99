"""The fused block, wgrad, row-DFT and core CUDA kernels on the card,
against their plain PyTorch versions: ranks 1–3, the block forward and the
three backward launches (gz recompute, dx adjoint, wgrad), the bare
spectral layer (no bypass), the partial variant's rdft / cdft / irdft and
core launches (rank 3's outer transforms through the per-axis factors;
cdft across its row groups), f32 (relative 2e-4) and bf16 (2e-2 against
the f32 plain version), the launch counter, the fused model (both variants) against the
staged path, and one fused training step of each variant against the
staged one; the core at full width (fno2d-large's per-mode W at B=8 and
B=9, and 2D 512² modes 64, whose factors stream in pieces); then the
per-mode modes of the block, wgrad and core kernels
(weights [O,H,k_1..k_R]) at ranks 1–3 and at fno2d-large's width, and a
per-mode fused training step; then the spectral-only path's launches (the
bare layer's dx, the bypass-free wgrad, shared and per-mode, counted
"spectral_dx" and "spectral_wgrad"), the complex product ``cgemm`` (A
resident and K chunked), and a
spectral-only (``fuse_block`` off) training step of each variant; then
fno3d at full width (hidden 32, 64³, modes 16³: clusters of 16, the block
kernel's chains 2 s_1 rows a chunk, the wgrad kernel's 1) — every
launch of its fused designs against the
plain versions and a training step of each design against the staged one
— and the linear (TP-partial) block, counted "block_linear", with its
two backward launches; then the fused model ends (the lift, the
projection and both in one launch, counted "block_ends") at ranks 1–3
and at fno2d, fno3d and fno2d-large width, and an ends-fused fno2d
training step's launches and grads against the staged path; then the
block kernel's chains with the forward chain forced to either plan and the
inverse chain in ragged chunks and pieces, and both kernels at a shape the
wgrad's tensor-core chain cannot hold (2D 256², modes 32, hidden 64).
Every test needs an NVIDIA GPU (marker ``gpu``) and skips without one; on
the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernel_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, tree
from repro_torch.core import fno as tfno
from repro_torch.core import spectral
from repro_torch.data import pde
from repro_torch.kernels import build
from repro_torch.kernels import cgemm as cgemm_k
from repro_torch.kernels import dft, engine
from repro_torch.kernels import ops as tops
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train.train_step import (make_loss_fn, make_train_step,
                                          value_and_grad)

pytestmark = pytest.mark.gpu

_CASES = {
    1: ((64,), (17,)),
    2: ((16, 32), (5, 9)),
    3: ((8, 8, 16), (3, 3, 5)),
}


@pytest.fixture
def cuda():
    """The card, with TF32 off for the plain versions; skips without one
    (decided here, never at import, so every worker collects the same
    tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; run this file on the "
                    "card with `python -m pytest -m gpu`")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _rel_err(y, ref) -> float:
    y, ref = y.float(), ref.float()
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def _args(device, spatial, b=2, h=8, o=6, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.tensor(sc * rng.normal(size=s),
                                         dtype=torch.float32, device=device)
    return [mk(b, h, *spatial), mk(o, h, sc=1.0 / h), mk(o, h, sc=1.0 / h),
            mk(o, h, sc=1.0 / h), mk(o, 1, sc=0.3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_kernel_matches_plain(cuda, rank, dtype):
    spatial, modes = _CASES[rank]
    args = _args(cuda, spatial, seed=rank)
    ref = engine.fused_block_plain(
        *args, spectral.operand_tensors(spatial, modes, "float32", cuda))
    tdt = getattr(torch, dtype)
    y = engine.fused_block(
        *[a.to(tdt) for a in args],
        spectral.operand_tensors(spatial, modes, dtype, cuda))
    torch.cuda.synchronize()
    assert y.dtype == tdt and y.is_cuda
    assert _rel_err(y, ref) <= (2e-4 if dtype == "float32" else 2e-2)


def test_kernel_at_fno2d_full_width(cuda):
    cfg = configs.get_config("fno2d")
    args = _args(cuda, cfg.spatial, b=2, h=cfg.hidden, o=cfg.hidden, seed=5)
    mats = spectral.operand_tensors(cfg.spatial, cfg.modes, "float32", cuda)
    y = engine.fused_block(*args, mats)
    torch.cuda.synchronize()
    assert _rel_err(y, engine.fused_block_plain(*args, mats)) <= 2e-4


def test_launch_counter_counts_each_launch(cuda):
    spatial, modes = _CASES[2]
    args = _args(cuda, spatial)
    mats = spectral.operand_tensors(spatial, modes, "float32", cuda)
    key = ("block_fwd", "float32")
    before = engine.LAUNCHES[key]
    for _ in range(3):
        engine.fused_block(*args, mats)
    engine.fused_block_plain(*args, mats)
    torch.cuda.synchronize()
    assert engine.LAUNCHES[key] - before == 3


def test_forward_only_on_card(cuda):
    spatial, modes = _CASES[1]
    args = _args(cuda, spatial)
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="ops.fno_block_nd"):
        engine.fused_block(
            *args, spectral.operand_tensors(spatial, modes, "float32", cuda))


def test_fused_model_matches_staged_on_card(cuda):
    cfg = configs.with_fuse_block(configs.get_config("fno2d", reduced=True))
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    x = torch.randn((3, cfg.in_channels) + tuple(cfg.spatial),
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    key = ("block_fwd", "float32")
    before = engine.LAUNCHES[key]
    with torch.no_grad():
        y = tfno.apply_fno(params, dataclasses.replace(cfg, path="fused"), x)
        y_ref = tfno.apply_fno(params, cfg, x, path="staged")
    torch.cuda.synchronize()
    assert engine.LAUNCHES[key] - before == cfg.num_layers
    assert _rel_err(y, y_ref) <= 2e-4


def _backward_launches(device, spatial, modes, dtype, b=2, h=8, o=6,
                       seed=0):
    """(gz, dx, wgrad) from the kernels at `dtype` and from the plain
    versions in f32, on the same inputs."""
    x, wr, wi, wb, bias = _args(device, spatial, b, h, o, seed)
    gy = torch.randn((b, o) + tuple(spatial),
                     generator=torch.Generator().manual_seed(seed)).to(device)
    tdt = getattr(torch, dtype)
    mats = {k: spectral.operand_tensors(spatial, modes, dtype, device, k)
            for k in ("forward", "adjoint", "wgrad")}
    m32 = {k: spectral.operand_tensors(spatial, modes, "float32", device, k)
           for k in ("forward", "adjoint", "wgrad")}
    t = lambda a: a.to(tdt).contiguous()
    gz = engine.fused_block(t(x), t(wr), t(wi), t(wb), t(bias),
                            mats["forward"], act="gelu_vjp", gy=t(gy))
    dx = engine.fused_block(gz, t(wr).t(), t(wi).t(), t(wb.t()), None,
                            mats["adjoint"], act="linear",
                            out_dtype=torch.float32)
    dw = engine.fused_wgrad(t(x), gz, mats["wgrad"])
    gz32 = engine.fused_block_plain(x, wr, wi, wb, bias, m32["forward"],
                                    act="gelu_vjp", gy=gy)
    dx32 = engine.fused_block_plain(gz32, wr.t().contiguous(),
                                    wi.t().contiguous(), wb.t().contiguous(),
                                    None, m32["adjoint"], act="linear")
    dw32 = engine.fused_wgrad_plain(x, gz32, m32["wgrad"])
    torch.cuda.synchronize()
    return (gz, dx, *dw), (gz32, dx32, *dw32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_backward_kernels_match_plain(cuda, rank, dtype):
    spatial, modes = _CASES[rank]
    ours, plain = _backward_launches(cuda, spatial, modes, dtype, seed=rank)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for name, a, b in zip(("gz", "dx", "dwr", "dwi", "dwb", "dbias"), ours,
                          plain):
        assert a.is_cuda and bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))
    assert ours[0].dtype == getattr(torch, dtype)
    assert all(t.dtype == torch.float32 for t in ours[1:])


def test_backward_kernels_at_fno2d_full_width(cuda):
    cfg = configs.get_config("fno2d")
    ours, plain = _backward_launches(cuda, cfg.spatial, cfg.modes, "float32",
                                     b=2, h=cfg.hidden, o=cfg.hidden, seed=7)
    for a, b in zip(ours, plain):
        assert _rel_err(a, b) <= 2e-4


def test_wgrad_is_deterministic(cuda):
    """The batch reduction sums per-sample partials in sample order: two
    launches on the same inputs agree bit for bit."""
    spatial, modes = _CASES[2]
    x, _, _, _, _ = _args(cuda, spatial, b=5)
    gz = torch.randn((5, 6) + spatial, device=cuda)
    mats = spectral.operand_tensors(spatial, modes, "float32", cuda, "wgrad")
    one = engine.fused_wgrad(x, gz, mats)
    two = engine.fused_wgrad(x, gz, mats)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("spatial", [(64, 64), (63, 65)],
                         ids=["even", "ragged"])
@pytest.mark.parametrize("cluster", [8, 16])
def test_wgrad_point_split_matches_plain(cuda, monkeypatch, cluster, spatial,
                                         per_mode, dtype):
    """The dW_b product splits each sample's points over the cluster's
    blocks in chunks of plan["cols"]: at clusters of 8 and of 16, with the
    points a whole number of chunks a block (64·64) and with a ragged last
    chunk (63·65), every output against the plain version."""
    b, h, modes = 3, 32, (12, 10)
    plan = engine.wgrad_plan(h, h, spatial, modes, cluster, per_mode)
    pts = spatial[0] * spatial[1]
    assert plan["cluster"] == cluster
    assert (pts % (cluster * plan["cols"]) == 0) == (spatial == (64, 64))
    monkeypatch.setattr(engine, "pick_wgrad_plan", lambda *a, **k: plan)
    x, _, _, _, _ = _args(cuda, spatial, b=b, h=h, o=h, seed=cluster)
    gz = torch.randn((b, h) + spatial,
                     generator=torch.Generator().manual_seed(cluster)
                     ).to(cuda)
    tdt = getattr(torch, dtype)
    mats = spectral.operand_tensors(spatial, modes, dtype, cuda, "wgrad")
    m32 = spectral.operand_tensors(spatial, modes, "float32", cuda, "wgrad")
    ours = engine.fused_wgrad(x.to(tdt), gz.to(tdt), mats, per_mode=per_mode)
    ref = engine.fused_wgrad_plain(x, gz, m32, per_mode=per_mode)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == "float32" else 2e-2
    for name, a, r in zip(("dwr", "dwi", "dwb", "dbias"), ours, ref):
        assert a.shape == r.shape and _rel_err(a, r) <= tol, name


def test_fused_train_step_matches_staged_on_card(cuda):
    """One AdamW step of reduced fno2d on the fused path (four kernel
    launches per block) against the staged path's autograd, and every
    leaf's gradient against the staged one, scaled to the leaf's own
    magnitude."""
    cfg = configs.with_fuse_block(configs.get_config("fno2d", reduced=True))
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    gen = torch.Generator().manual_seed(1)
    batch = {"x": torch.randn((2, cfg.in_channels) + tuple(cfg.spatial),
                              generator=gen).to(cuda),
             "y": torch.randn((2, cfg.out_channels) + tuple(cfg.spatial),
                              generator=gen).to(cuda)}
    opt = AdamW(lr=constant(1e-3))
    engine.LAUNCHES.clear()
    fused = make_train_step(cfg, opt, fno_path="fused")(
        params, opt.init(params), batch)
    torch.cuda.synchronize()
    for kind in engine.KINDS:
        assert engine.LAUNCHES[(kind, "float32")] == cfg.num_layers, kind
    staged = make_train_step(cfg, opt, fno_path="staged")(
        params, opt.init(params), batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(fused[2][key]) - float(staged[2][key])) <= (
            2e-4 * abs(float(staged[2][key])))
    for a, b in zip(tree.leaves(fused[0]), tree.leaves(staged[0])):
        assert _rel_err(a, b) <= 2e-4
    grads = [tree.leaves(value_and_grad(make_loss_fn(cfg, fno_path=p),
                                        params, batch)[1])
             for p in ("fused", "staged")]
    for a, b in zip(*grads):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 2e-4 * scale


# (leading shape, n, k): ragged rows, chunks and column tiles, then fno2d's
# rows at B=1.
_ROWS = [((3, 5), 37, 9), ((130,), 20, 11), ((3,), 100, 45),
         ((1, 64, 128), 128, 32)]


def _row_case(device, kind, lead, n, k, dtype, seed):
    """Inputs and operands of one row kernel (f32 and `dtype`)."""
    rng = np.random.default_rng(seed)
    k = min(k, n // 2 + 1)
    width = k if kind in ("irdft", "icdft") else n
    mk = lambda: torch.tensor(rng.normal(size=lead + (width,)),
                              dtype=torch.float32, device=device)
    ins = [mk()] if kind == "rdft" else [mk(), mk()]
    ops = {d: spectral.row_operand_tensors(kind, (n,), (k,), d, device)
           for d in ("float32", dtype)}
    return ins, ops


_ROW_FNS = {"rdft": (dft.rdft, dft.rdft_plain),
            "cdft": (dft.cdft, dft.cdft_plain),
            "icdft": (dft.cdft, dft.cdft_plain),
            "irdft": (dft.irdft, dft.irdft_plain)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(_ROW_FNS))
@pytest.mark.parametrize("case", _ROWS, ids=lambda c: f"{c[0]}x{c[1]}")
def test_row_kernels_match_plain(cuda, kind, case, dtype):
    lead, n, k = case
    ins, ops = _row_case(cuda, kind, lead, n, k, dtype, seed=n + k)
    fn, plain = _ROW_FNS[kind]
    ref = plain(*ins, *ops["float32"])
    tdt = getattr(torch, dtype)
    launch = "cdft" if kind == "icdft" else kind
    before = engine.LAUNCHES[(launch, dtype)]
    y = fn(*[a.to(tdt) for a in ins], *ops[dtype])
    torch.cuda.synchronize()
    assert engine.LAUNCHES[(launch, dtype)] == before + 1
    ys = y if isinstance(y, tuple) else (y,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(ys, refs):
        assert a.dtype == tdt and a.is_cuda and a.shape == b.shape
        assert _rel_err(a, b) <= (2e-4 if dtype == "float32" else 2e-2)


# The separable outer transforms (rank 3): odd extents, then fno3d's at
# full width ((s_2, s_3), (k_2, k_3), leading shape).
_OUTER = [((6, 10), (3, 4), (2, 3, 5)), ((5, 9), (3, 5), (7,)),
          ((64, 64), (16, 16), (1, 32, 64))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _OUTER, ids=lambda c: f"{c[0]}x{c[1]}")
def test_outer_row_kernels_match_plain(cuda, case, dtype):
    """``dft.outer_rdft`` / ``outer_irdft`` (one launch each, counted
    "rdft" / "irdft") against their plain versions, the reference's
    Kronecker-combined product: f32 within 2e-4, bf16 within 2e-2 of the
    f32 plain version."""
    (n2, n3), (k2, k3), lead = case
    rng = np.random.default_rng(n2 + n3)
    mk = lambda *s: torch.tensor(rng.normal(size=lead + s),
                                 dtype=torch.float32, device=cuda)
    f = lambda kind, n, k, d: spectral.row_operand_tensors(kind, (n,), (k,),
                                                           d, cuda)
    pairs = lambda a, b, d: (f(a, n2, k2, d), f(b, n3, k3, d))
    x, zr, zi = mk(n2, n3), mk(k3, k2), mk(k3, k2)
    ref_f = dft.outer_rdft_plain(x, *pairs("cdft", "cdft", "float32"))
    ref_i = dft.outer_irdft_plain(zr, zi, *pairs("icdft", "irdft",
                                                 "float32"))
    tdt = getattr(torch, dtype)
    before = (engine.LAUNCHES[("rdft", dtype)],
              engine.LAUNCHES[("irdft", dtype)])
    got_f = dft.outer_rdft(x.to(tdt), *pairs("cdft", "cdft", dtype))
    got_i = dft.outer_irdft(zr.to(tdt), zi.to(tdt),
                            *pairs("icdft", "irdft", dtype))
    torch.cuda.synchronize()
    assert (engine.LAUNCHES[("rdft", dtype)],
            engine.LAUNCHES[("irdft", dtype)]) == (before[0] + 1,
                                                   before[1] + 1)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for a, b in zip(got_f + (got_i,), ref_f + (ref_i,)):
        assert a.dtype == tdt and a.is_cuda and a.shape == b.shape
        assert _rel_err(a, b) <= tol


def test_row_kernels_refuse_shapes_outside_their_plan(cuda):
    """On the card too a slab over the shared-memory budget raises before
    any launch, with the shape in the message."""
    f = lambda kind, n, k: spectral.row_operand_tensors(kind, (n,), (k,),
                                                        "float32", cuda)
    before = dict(engine.LAUNCHES)
    with pytest.raises(ValueError, match="256x256 points"):
        dft.outer_rdft(torch.zeros(1, 256, 256, device=cuda),
                       f("cdft", 256, 64), f("cdft", 256, 64))
    assert dict(engine.LAUNCHES) == before


def _core_case(device, b, h, o, n1, k1, spec, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.tensor(sc * rng.normal(size=s),
                                         dtype=torch.float32, device=device)
    z = [mk(b, h, n1, *spec), mk(b, h, n1, *spec)]
    w = [mk(o, h, sc=1.0 / h), mk(o, h, sc=1.0 / h)]
    f = [torch.from_numpy(m).to(device) for m in spectral.cdft_mats(n1, k1)]
    g = [torch.from_numpy(m).to(device)
         for m in spectral.cdft_mats(n1, k1, True)]
    return z + w + f + g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(2, 8, 6, 16, 5, (9,)),
                                  (1, 5, 7, 33, 4, (3, 5)),
                                  (2, 64, 64, 128, 32, (32,)),
                                  (1, 32, 32, 64, 16, (16, 16))],
                         ids=str)
def test_core_kernel_matches_plain(cuda, case, dtype):
    args = _core_case(cuda, *case, seed=case[3])
    ref = engine.fused_core_plain(*args)
    tdt = getattr(torch, dtype)
    y = engine.fused_core(*[a.to(tdt) for a in args])
    torch.cuda.synchronize()
    for a, r in zip(y, ref):
        assert a.dtype == tdt and a.shape == r.shape
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


# (B, H, O, s_1, K_1, K_R..K_2, per-mode): fno2d-large's per-mode core at
# B=8 (one sample group: W read once) and B=9 (a second group of one);
# 2D 512² modes 64 at hidden 64, whose factors (256 KB each in f32) stream
# through shared memory in pieces; and B=128 over P = 64² columns (3D
# modes 64), 131,072 tiles in f32 and 65,536 in bf16, more than one grid
# axis holds.
CORE_FULL = [(8, 128, 128, 128, 32, (32,), True),
             (9, 128, 128, 128, 32, (32,), True),
             (2, 64, 64, 512, 64, (64,), False),
             (128, 4, 4, 16, 8, (64, 64), False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CORE_FULL,
                         ids=["fno2d-large-B8", "fno2d-large-B9",
                              "512sq-m64-B2", "m64sq-B128-tiles"])
def test_core_kernel_at_full_width(cuda, case, dtype):
    b, h, o, n1, k1, spec, per_mode = case
    args = _core_case(cuda, b, h, o, n1, k1, spec, seed=n1 + b)
    if per_mode:
        gen = torch.Generator().manual_seed(b)
        args[2:4] = [(torch.randn((o, h, k1) + spec[::-1], generator=gen)
                      / h).to(cuda) for _ in range(2)]
    ref = engine.fused_core_plain(*args)
    tdt = getattr(torch, dtype)
    before = engine.LAUNCHES[("core", dtype)]
    y = engine.fused_core(*[a.to(tdt) for a in args])
    torch.cuda.synchronize()
    assert engine.LAUNCHES[("core", dtype)] == before + 1
    for a, r in zip(y, ref):
        assert a.dtype == tdt and a.shape == r.shape
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)
    p = int(np.prod(spec))
    plan = engine.core_plan(build.load_fused_core(), tdt, b, h, o, n1, k1, p,
                            per_mode, spec[-1])
    if per_mode:  # W read once a group of up to 8 samples
        assert plan["w_bytes"] == (-(-b // 8)) * 2 * o * h * k1 * p \
            * tdt.itemsize


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bare_spectral_kernel_matches_plain(cuda, dtype):
    """The block kernel without wb and bias (linear): the rank-1 partial
    variant's forward, counted as "spectral_fwd"."""
    spatial, modes = _CASES[1]
    x, wr, wi = _args(cuda, spatial, seed=11)[:3]
    ref = engine.fused_block_plain(
        x, wr, wi, None, None,
        spectral.operand_tensors(spatial, modes, "float32", cuda),
        act="linear")
    tdt = getattr(torch, dtype)
    before = engine.LAUNCHES[("spectral_fwd", dtype)]
    y = engine.fused_block(
        *[a.to(tdt) for a in (x, wr, wi)], None, None,
        spectral.operand_tensors(spatial, modes, dtype, cuda), act="linear")
    torch.cuda.synchronize()
    assert engine.LAUNCHES[("spectral_fwd", dtype)] == before + 1
    assert _rel_err(y, ref) <= (2e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_partial_block_matches_staged_on_card(cuda, rank):
    """fno_block_nd(variant="partial") against the staged oracle, with the
    launch structure: rank 1 one bare-spectral launch, ranks 2–3 one rdft,
    one core and one irdft launch, and no block_fwd."""
    spatial, modes = _CASES[rank]
    x, wr, wi, wb, bias = _args(cuda, spatial, seed=20 + rank)
    bias = bias.reshape(-1)
    engine.LAUNCHES.clear()
    y = tops.fno_block_nd(x, wr, wi, wb, bias, modes, variant="partial")
    torch.cuda.synchronize()
    want = ({("spectral_fwd", "float32"): 1} if rank == 1 else
            {(k, "float32"): 1 for k in engine.PARTIAL_KINDS})
    assert dict(engine.LAUNCHES) == want
    ref = tops.fno_block_nd(x, wr, wi, wb, bias, modes, path="staged")
    assert _rel_err(y, ref) <= 2e-4


def test_partial_train_step_matches_staged_on_card(cuda):
    """One AdamW step of reduced fno2d on the partial variant (rdft, core
    and irdft forward, the three fused launches backward) against the
    staged path, every leaf's gradient to its own magnitude."""
    cfg = configs.with_fuse_block(configs.get_config("fno2d", reduced=True))
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    gen = torch.Generator().manual_seed(2)
    batch = {"x": torch.randn((2, cfg.in_channels) + tuple(cfg.spatial),
                              generator=gen).to(cuda),
             "y": torch.randn((2, cfg.out_channels) + tuple(cfg.spatial),
                              generator=gen).to(cuda)}
    engine.LAUNCHES.clear()
    loss, grads = value_and_grad(
        make_loss_fn(cfg, fno_path="fused", fno_variant="partial"), params,
        batch)
    torch.cuda.synchronize()
    kinds = engine.PARTIAL_KINDS + engine.KINDS[1:]
    assert dict(engine.LAUNCHES) == {(k, "float32"): cfg.num_layers
                                     for k in kinds}
    loss_s, grads_s = value_and_grad(make_loss_fn(cfg, fno_path="staged"),
                                     params, batch)
    assert abs(float(loss) - float(loss_s)) <= 2e-4 * abs(float(loss_s))
    for a, b in zip(tree.leaves(grads), tree.leaves(grads_s)):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 2e-4 * scale


def _per_mode_weights(device, o, h, modes, seed):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn((o, h) + tuple(modes), generator=gen) / h).to(device)
            for _ in range(2)]


def _per_mode_launches(device, spatial, modes, dtype, b=2, h=8, o=6,
                       seed=0):
    """Per-mode forward, gz, dx (the transposed view), bare layer and wgrad
    from the kernels at `dtype`, and the plain versions in f32."""
    x, _, _, wb, bias = _args(device, spatial, b, h, o, seed)
    wr, wi = _per_mode_weights(device, o, h, modes, seed)
    gy = torch.randn((b, o) + tuple(spatial),
                     generator=torch.Generator().manual_seed(seed)).to(device)
    tdt = getattr(torch, dtype)
    t = lambda a: a.to(tdt).contiguous()
    sw = lambda a: a.transpose(0, 1)

    def chain(block, wgrad, dt, cast):
        m = {k: spectral.operand_tensors(spatial, modes, dt, device, k)
             for k in ("forward", "adjoint", "wgrad")}
        a = [cast(v) for v in (x, wr, wi, wb, bias)]
        y = block(*a, m["forward"])
        gz = block(*a, m["forward"], act="gelu_vjp", gy=cast(gy))
        dx = block(gz, sw(a[1]), sw(a[2]), a[3].t().contiguous(), None,
                   m["adjoint"], act="linear")
        bare = block(a[0], a[1], a[2], None, None, m["forward"],
                     act="linear")
        return (y, gz, dx, bare) + tuple(wgrad(a[0], gz, m["wgrad"],
                                               per_mode=True))

    ours = chain(engine.fused_block, engine.fused_wgrad, dtype, t)
    plain = chain(engine.fused_block_plain, engine.fused_wgrad_plain,
                  "float32", lambda a: a)
    torch.cuda.synchronize()
    return ours, plain


_PM_NAMES = ("y", "gz", "dx", "bare", "dwr", "dwi", "dwb", "dbias")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_per_mode_kernels_match_plain(cuda, rank, dtype):
    spatial, modes = _CASES[rank]
    ours, plain = _per_mode_launches(cuda, spatial, modes, dtype,
                                     seed=20 + rank)
    tol = 2e-4 if dtype == "float32" else 2e-2
    assert tuple(ours[4].shape) == (6, 8) + tuple(modes)
    for name, a, b in zip(_PM_NAMES, ours, plain):
        assert a.is_cuda and bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


def test_per_mode_kernels_at_fno2d_large_width(cuda):
    """Hidden 128: clusters of 16, W streamed from device memory, B=2."""
    cfg = configs.get_config("fno2d-large")
    ours, plain = _per_mode_launches(cuda, cfg.spatial, cfg.modes,
                                     "float32", b=2, h=cfg.hidden,
                                     o=cfg.hidden, seed=9)
    for name, a, b in zip(_PM_NAMES, ours, plain):
        assert _rel_err(a, b) <= 2e-4, (name, _rel_err(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(2, 8, 6, 16, 5, (9,)),
                                  (1, 5, 7, 33, 4, (3, 5))], ids=str)
def test_per_mode_core_kernel_matches_plain(cuda, case, dtype):
    b, h, o, n1, k1, spec = case
    gen = torch.Generator().manual_seed(n1)
    rnd = lambda *s: torch.randn(s, generator=gen).to(cuda)
    zr, zi = rnd(b, h, n1, *spec), rnd(b, h, n1, *spec)
    wr, wi = rnd(o, h, k1, *spec[::-1]) / h, rnd(o, h, k1, *spec[::-1]) / h
    f = [torch.from_numpy(m).to(cuda) for m in spectral.cdft_mats(n1, k1)]
    g = [torch.from_numpy(m).to(cuda)
         for m in spectral.cdft_mats(n1, k1, True)]
    args = [zr, zi, wr, wi, *f, *g]
    ref = engine.fused_core_plain(*args)
    tdt = getattr(torch, dtype)
    y = engine.fused_core(*[a.to(tdt) for a in args])
    torch.cuda.synchronize()
    for a, r in zip(y, ref):
        assert a.dtype == tdt and a.shape == r.shape
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


def test_per_mode_wgrad_is_deterministic(cuda):
    spatial, modes = _CASES[2]
    x = _args(cuda, spatial, b=5)[0]
    gz = torch.randn((5, 6) + spatial, device=cuda)
    mats = spectral.operand_tensors(spatial, modes, "float32", cuda, "wgrad")
    one = engine.fused_wgrad(x, gz, mats, per_mode=True)
    two = engine.fused_wgrad(x, gz, mats, per_mode=True)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["full", "partial"])
def test_per_mode_train_step_matches_staged_on_card(cuda, variant):
    """One AdamW step of the reduced model with per-mode weights, fused
    against staged, and every leaf's gradient to its own magnitude."""
    cfg = dataclasses.replace(
        configs.with_fuse_block(configs.get_config("fno2d-large",
                                                   reduced=True)),
        weight_mode="per_mode")
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    gen = torch.Generator().manual_seed(1)
    batch = {"x": torch.randn((2, cfg.in_channels) + tuple(cfg.spatial),
                              generator=gen).to(cuda),
             "y": torch.randn((2, cfg.out_channels) + tuple(cfg.spatial),
                              generator=gen).to(cuda)}
    grads = [tree.leaves(value_and_grad(
        make_loss_fn(cfg, fno_path=p, fno_variant=variant), params,
        batch)[1]) for p in ("fused", "staged")]
    for a, b in zip(*grads):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 2e-4 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_spectral_backward_kernels_match_plain(cuda, rank, per_mode, dtype):
    """The bare layer's backward: dx (the block kernel without wb, the
    adjoint bundle, the weights' transposed view, emitted in f32) and the
    wgrad kernel without its bypass phase, against the plain versions in
    f32, each counted once under its own kind."""
    spatial, modes = _CASES[rank]
    x, wr, wi = _args(cuda, spatial, seed=30 + rank)[:3]
    if per_mode:
        wr, wi = _per_mode_weights(cuda, 6, 8, modes, 30 + rank)
    gy = torch.randn((2, 6) + spatial,
                     generator=torch.Generator().manual_seed(rank)).to(cuda)
    tdt = getattr(torch, dtype)
    m = {d: {k: spectral.operand_tensors(spatial, modes, d, cuda, k)
             for k in ("adjoint", "wgrad")} for d in ("float32", dtype)}
    sw = lambda a: a.transpose(0, 1)
    dx32 = engine.fused_block_plain(gy, sw(wr), sw(wi), None, None,
                                    m["float32"]["adjoint"], act="linear")
    dw32 = engine.fused_wgrad_plain(x, gy, m["float32"]["wgrad"],
                                    per_mode=per_mode, with_bypass=False)
    before = dict(engine.LAUNCHES)
    w_r, w_i = wr.to(tdt), wi.to(tdt)
    dx = engine.fused_block(gy.to(tdt), sw(w_r), sw(w_i), None, None,
                            m[dtype]["adjoint"], act="linear",
                            out_dtype=torch.float32, adjoint=True)
    dw = engine.fused_wgrad(x.to(tdt), gy.to(tdt), m[dtype]["wgrad"],
                            per_mode=per_mode, with_bypass=False)
    torch.cuda.synchronize()
    for kind in ("spectral_dx", "spectral_wgrad"):
        assert engine.LAUNCHES[(kind, dtype)] == \
            before.get((kind, dtype), 0) + 1, kind
    tol = 2e-4 if dtype == "float32" else 2e-2
    assert len(dw) == 2
    for name, a, b in zip(("dx", "dwr", "dwi"), (dx, *dw), (dx32, *dw32)):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(37, 19, 23), (130, 257, 129),
                                 (64, 64, 8192)], ids=str)
def test_cgemm_kernel_matches_plain(cuda, mkn, dtype):
    m, k, n = mkn
    gen = torch.Generator().manual_seed(m + n)
    planes = [torch.randn(s, generator=gen).to(cuda)
              for s in ((m, k), (m, k), (k, n), (k, n))]
    ref = cgemm_k.cgemm_plain(*planes)
    tdt = getattr(torch, dtype)
    before = engine.LAUNCHES[("cgemm", dtype)]
    out = tops.cgemm(*[p.to(tdt) for p in planes])
    torch.cuda.synchronize()
    assert engine.LAUNCHES[("cgemm", dtype)] == before + 1
    for a, r in zip(out, ref):
        assert a.dtype == tdt and a.is_cuda and a.shape == (m, n)
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


# cdft on the row machinery, the operand resident: (kind, rows, n, k) with
# the wrapper's cap (64 rows in f32, 128 in bf16) — fno2d's s_1 rows over
# a group boundary (129 rows: the last group holds one), one row, and rows
# of odd extents over several groups a block.
_CDFT_GROUPS = [("cdft", 129, 128, 32), ("icdft", 129, 128, 32),
                ("cdft", 1, 128, 32), ("icdft", 1, 100, 45),
                ("cdft", 40_000, 100, 45), ("icdft", 40_000, 37, 9)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _CDFT_GROUPS, ids=str)
def test_cdft_groups_match_plain(cuda, case, dtype):
    """One launch counted "cdft" per call, f32 within 2e-4 of the plain
    version (3xTF32 on the tensor cores), bf16 within 2e-2 of the f32 one."""
    kind, rows, n, k = case
    width = n if kind == "cdft" else k
    gen = torch.Generator().manual_seed(rows + n)
    xr, xi = [torch.randn(rows, width, generator=gen).to(cuda)
              for _ in range(2)]
    ops = {d: spectral.row_operand_tensors(kind, (n,), (k,), d, cuda)
           for d in ("float32", dtype)}
    ref = dft.cdft_plain(xr, xi, *ops["float32"])
    tdt = getattr(torch, dtype)
    assert dft.max_group(kind, tdt, 1, False) == (
        64 if dtype == "float32" else 128)
    before = engine.LAUNCHES[("cdft", dtype)]
    got = dft.cdft(xr.to(tdt), xi.to(tdt), *ops[dtype])
    torch.cuda.synchronize()
    assert engine.LAUNCHES[("cdft", dtype)] == before + 1
    for a, b in zip(got, ref):
        assert a.dtype == tdt and a.shape == b.shape
        assert _rel_err(a, b) <= (2e-4 if dtype == "float32" else 2e-2)


# The complex product on both sides of its switch from A resident in
# shared memory to K walked in chunks (M = 128: K 144 / 152 in f32, 288 /
# 296 in bf16), N ragged against the 16-column strips.
_CGEMM_SWITCH = {"float32": ((128, 144, 4100), (128, 152, 4100)),
                 "bfloat16": ((128, 288, 4100), (128, 296, 4100))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", [0, 1], ids=["resident", "k_chunked"])
def test_cgemm_both_sides_of_the_k_chunk_switch(cuda, side, dtype):
    m, k, n = _CGEMM_SWITCH[dtype][side]
    tdt = getattr(torch, dtype)
    assert cgemm_k.plan(build.load_cgemm(), tdt, m, k)["chunks"] == side + 1
    gen = torch.Generator().manual_seed(k)
    planes = [torch.randn(s, generator=gen).to(cuda)
              for s in ((m, k), (m, k), (k, n), (k, n))]
    ref = cgemm_k.cgemm_plain(*planes)
    out = cgemm_k.cgemm(*[p.to(tdt) for p in planes])
    torch.cuda.synchronize()
    for a, r in zip(out, ref):
        assert a.dtype == tdt and a.shape == (m, n)
        assert _rel_err(a, r) <= (2e-4 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("variant", ["full", "partial"])
def test_spectral_only_train_step_matches_staged_on_card(cuda, variant):
    """Reduced fno2d with fuse_block off: the loss and every leaf's
    gradient of the fused path (the spectral-layer kernels, the bypass,
    bias and GELU in PyTorch) against the staged path, and exactly
    num_layers launches of each spectral-only kind per step."""
    cfg = configs.get_config("fno2d", reduced=True)
    assert not cfg.fuse_block
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    gen = torch.Generator().manual_seed(3)
    batch = {"x": torch.randn((2, cfg.in_channels) + tuple(cfg.spatial),
                              generator=gen).to(cuda),
             "y": torch.randn((2, cfg.out_channels) + tuple(cfg.spatial),
                              generator=gen).to(cuda)}
    engine.LAUNCHES.clear()
    loss, grads = value_and_grad(
        make_loss_fn(cfg, fno_path="fused", fno_variant=variant), params,
        batch)
    torch.cuda.synchronize()
    kinds = (engine.SPECTRAL_KINDS if variant == "full"
             else engine.PARTIAL_KINDS + engine.SPECTRAL_KINDS[1:])
    assert dict(engine.LAUNCHES) == {(k, "float32"): cfg.num_layers
                                     for k in kinds}
    loss_s, grads_s = value_and_grad(make_loss_fn(cfg, fno_path="staged"),
                                     params, batch)
    assert abs(float(loss) - float(loss_s)) <= 2e-4 * abs(float(loss_s))
    for a, b in zip(tree.leaves(grads), tree.leaves(grads_s)):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 2e-4 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_at_fno3d_full_width(cuda, dtype):
    """fno3d at full width, B=2: both kernels plan clusters of 16, the block
    kernel's tensor-core chains 2 s_1 rows a chunk, the wgrad kernel's
    tensor-core chain 1; the block forward,
    gz, dx, the bare forward and dx, and both wgrads against the plain
    versions in f32 (bf16: 2e-2 of the f32 chain)."""
    cfg = configs.get_config("fno3d")
    sp, md, h = cfg.spatial, cfg.modes, cfg.hidden
    code = 0 if dtype == "float32" else 1
    block = engine.pick_plan(build.load_fused_block(), code, 2, h, h, sp,
                             md)
    wgrad = engine.pick_wgrad_plan(build.load_fused_wgrad(), code, 2, h, h,
                                   sp, md)
    assert block["cluster"] == wgrad["cluster"] == 16
    assert block["rows_f"] == 2 and wgrad["rows_f"] == 1
    assert block["chain"] == wgrad["chain"] == "tc"
    tol = 2e-4 if dtype == "float32" else 2e-2
    ours, plain = _backward_launches(cuda, sp, md, dtype, b=2, h=h, o=h,
                                     seed=12)
    for name, a, b in zip(("gz", "dx", "dwr", "dwi", "dwb", "dbias"), ours,
                          plain):
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))
    x, wr, wi, wb, bias = _args(cuda, sp, b=2, h=h, o=h, seed=13)
    gy = torch.randn((2, h) + tuple(sp),
                     generator=torch.Generator().manual_seed(13)).to(cuda)
    tdt = getattr(torch, dtype)
    m = {d: {k: spectral.operand_tensors(sp, md, d, cuda, k)
             for k in ("forward", "adjoint", "wgrad")}
         for d in ("float32", dtype)}
    t = lambda a: a.to(tdt)
    sw = lambda a: a.transpose(0, 1)
    ours = [engine.fused_block(*map(t, (x, wr, wi, wb, bias)),
                               m[dtype]["forward"]),
            engine.fused_block(t(x), t(wr), t(wi), None, None,
                               m[dtype]["forward"], act="linear"),
            engine.fused_block(t(gy), sw(t(wr)), sw(t(wi)), None, None,
                               m[dtype]["adjoint"], act="linear",
                               adjoint=True),
            *engine.fused_wgrad(t(x), t(gy), m[dtype]["wgrad"],
                                with_bypass=False)]
    m32 = m["float32"]
    plain = [engine.fused_block_plain(x, wr, wi, wb, bias, m32["forward"]),
             engine.fused_block_plain(x, wr, wi, None, None, m32["forward"],
                                      act="linear"),
             engine.fused_block_plain(gy, sw(wr), sw(wi), None, None,
                                      m32["adjoint"], act="linear"),
             *engine.fused_wgrad_plain(x, gy, m32["wgrad"],
                                       with_bypass=False)]
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "bare", "bare_dx", "bare_dwr", "bare_dwi"),
                          ours, plain):
        assert a.is_cuda and bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


_FNO3D_DESIGNS = [(True, "full"), (True, "partial"), (False, "full"),
                  (False, "partial")]


@pytest.mark.parametrize("fuse_block,variant", _FNO3D_DESIGNS,
                         ids=[f"{'block' if f else 'spectral'}-{v}"
                              for f, v in _FNO3D_DESIGNS])
def test_fno3d_train_step_matches_staged_on_card(cuda, fuse_block, variant):
    """fno3d at full width, a diffusion batch of 2: the loss and every
    leaf's gradient of the fused design against the staged path, and
    exactly num_layers launches of each of its kinds."""
    cfg = configs.with_fuse_block(configs.get_config("fno3d"), fuse_block)
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    batch = pde.diffusion3d_batch(0, 0, 2, cfg.spatial[0], device=cuda)
    engine.LAUNCHES.clear()
    loss, grads = value_and_grad(
        make_loss_fn(cfg, fno_path="fused", fno_variant=variant), params,
        batch)
    torch.cuda.synchronize()
    kinds = engine.KINDS if fuse_block else engine.SPECTRAL_KINDS
    if variant == "partial":
        kinds = engine.PARTIAL_KINDS + kinds[1:]
    assert dict(engine.LAUNCHES) == {(k, "float32"): cfg.num_layers
                                     for k in kinds}
    loss_s, grads_s = value_and_grad(
        make_loss_fn(dataclasses.replace(cfg, fuse_block=False),
                     fno_path="staged"), params, batch)
    assert abs(float(loss) - float(loss_s)) <= 2e-4 * abs(float(loss_s))
    for a, b in zip(tree.leaves(grads), tree.leaves(grads_s)):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 2e-4 * scale


@pytest.mark.parametrize("variant", ["full", "partial"])
def test_linear_block_matches_staged_on_card(cuda, variant):
    """The linear (TP-partial) block under bf16 (f32 master leaves): y in
    f32 within 2e-2 of the staged f32 block, every grad of Σ sin(y) within
    5e-2 of the staged grads (a cotangent of ones leaves dW's imaginary
    part exactly zero); full: one block_linear launch forward, then one
    dx_adjoint and one wgrad, no gz_recompute."""
    spatial, modes = _CASES[3]
    x, wr, wi, wb, bias = _args(cuda, spatial, seed=40)
    leaves = lambda: [a.detach().clone().requires_grad_(True)
                      for a in (x, wr, wi, wb, bias.reshape(-1))]
    ref_leaves = leaves()
    y_ref = tops.fno_block_nd(*ref_leaves, modes, path="staged",
                              act="linear")
    g_ref = torch.autograd.grad(torch.sin(y_ref).sum(), ref_leaves)
    ls = leaves()
    engine.LAUNCHES.clear()
    y = tops.fno_block_nd(*ls, modes, variant=variant,
                          policy=configs.PrecisionPolicy.from_name("bf16"),
                          act="linear", out_dtype=torch.float32)
    fwd = dict(engine.LAUNCHES)
    g = torch.autograd.grad(torch.sin(y).sum(), ls)
    torch.cuda.synchronize()
    bwd = {k: v - fwd.get(k, 0) for k, v in engine.LAUNCHES.items()
           if v - fwd.get(k, 0)}
    want_fwd = ({("block_linear", "bfloat16"): 1} if variant == "full" else
                {(k, "bfloat16"): 1 for k in engine.PARTIAL_KINDS})
    assert fwd == want_fwd
    assert bwd == {("dx_adjoint", "bfloat16"): 1, ("wgrad", "bfloat16"): 1}
    assert y.dtype == torch.float32 and _rel_err(y, y_ref) <= 2e-2
    for a, b in zip(g, g_ref):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 5e-2 * scale


def _ends_args(device, b, h, spatial, cin, lw, cout, per_mode=False,
               modes=None, seed=0):
    """x (hidden), x_in (raw input), the block's operands and the two ends
    in the engine layout, f32 on the card."""
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: torch.tensor(sc * rng.normal(size=s),
                                         dtype=torch.float32, device=device)
    wshape = (h, h) + (tuple(modes) if per_mode else ())
    block = [mk(*wshape, sc=1.0 / h), mk(*wshape, sc=1.0 / h),
             mk(h, h, sc=1.0 / h), mk(h, 1, sc=0.3)]
    lift = (mk(lw, cin, sc=0.7), mk(lw, 1, sc=0.3), mk(h, lw, sc=lw ** -0.5),
            mk(h, 1, sc=0.3))
    proj = (mk(lw, h, sc=h ** -0.5), mk(lw, 1, sc=0.3),
            mk(cout, lw, sc=lw ** -0.5), mk(cout, 1, sc=0.3))
    return mk(b, h, *spatial), mk(b, cin, *spatial), block, lift, proj


def _ends_launches(x, xin, block, lift, proj, spatial, modes, dtype):
    """(kernel, f32 plain) outputs of the lift, proj and both launches."""
    tdt = getattr(torch, dtype)
    c = lambda t: t.to(tdt)
    mats = spectral.operand_tensors(spatial, modes, dtype, x.device)
    m32 = spectral.operand_tensors(spatial, modes, "float32", x.device)
    out = {}
    for which, inp, kw in (("lift", xin, {"lift": lift}),
                           ("proj", x, {"proj": proj}),
                           ("both", xin, {"lift": lift, "proj": proj})):
        kc = {k: tuple(map(c, v)) for k, v in kw.items()}
        y = engine.fused_block(c(inp), *map(c, block), mats, **kc)
        ref = engine.fused_block_plain(inp, *block, m32, **kw)
        out[which] = (y, ref)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_ends_kernel_matches_plain(cuda, rank, dtype):
    """The lift, the projection and both at odd extents (3 input channels,
    12 inner units, 2 output channels): f32 within 2e-4, bf16 within 2e-2
    of the f32 plain version; one block_ends launch each."""
    spatial, modes = _CASES[rank]
    x, xin, block, lift, proj = _ends_args(cuda, 2, 8, spatial, 3, 12, 2,
                                           seed=50 + rank)
    engine.LAUNCHES.clear()
    out = _ends_launches(x, xin, block, lift, proj, spatial, modes, dtype)
    assert dict(engine.LAUNCHES) == {("block_ends", dtype): 3}
    tol = 2e-4 if dtype == "float32" else 2e-2
    for which, (y, ref) in out.items():
        assert y.shape == ref.shape and bool(torch.isfinite(y).all()), which
        assert _rel_err(y, ref) <= tol, (which, _rel_err(y, ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["fno2d", "fno3d", "fno2d-large"])
def test_ends_kernel_at_full_width(cuda, arch, dtype):
    """The ends launches at each preset's full width (lift width and
    channels the preset's; fno2d-large's per-mode weights), B=2 against
    the f32 plain version."""
    cfg = configs.get_config(arch)
    lw = cfg.lifting_dim or 2 * cfg.hidden
    per_mode = cfg.weight_mode == "per_mode"
    x, xin, block, lift, proj = _ends_args(
        cuda, 2, cfg.hidden, cfg.spatial, cfg.in_channels, lw,
        cfg.out_channels, per_mode, cfg.modes, seed=60)
    out = _ends_launches(x, xin, block, lift, proj, cfg.spatial, cfg.modes,
                         dtype)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for which, (y, ref) in out.items():
        assert bool(torch.isfinite(y).all()), which
        assert _rel_err(y, ref) <= tol, (which, _rel_err(y, ref))


def test_ends_train_step_matches_staged_on_card(cuda):
    """fno2d at full width with fuse_ends, a Darcy batch of 2: the loss and
    every leaf's grad against the staged model without the ends; forward
    2 block_ends and L-2 block_fwd launches, backward the interior
    blocks' three each (the end blocks' backward is staged PyTorch)."""
    cfg = configs.with_fuse_ends(configs.with_fuse_block(
        configs.get_config("fno2d")))
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    batch = pde.darcy_batch(0, 0, 2, cfg.spatial[0], device=cuda)
    engine.LAUNCHES.clear()
    loss, grads = value_and_grad(make_loss_fn(cfg, fno_path="fused"),
                                 params, batch)
    torch.cuda.synchronize()
    inner = cfg.num_layers - 2
    want = {("block_ends", "float32"): 2}
    want.update({(k, "float32"): inner for k in engine.KINDS})
    assert dict(engine.LAUNCHES) == want
    loss_s, grads_s = value_and_grad(
        make_loss_fn(dataclasses.replace(cfg, fuse_block=False),
                     fno_path="staged"), params, batch)
    assert abs(float(loss) - float(loss_s)) <= 2e-4 * abs(float(loss_s))
    for a, b in zip(tree.leaves(grads), tree.leaves(grads_s)):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 2e-4 * scale


@pytest.mark.parametrize("chain", engine.CHAINS)
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_block_chains_in_pieces_match_plain(cuda, monkeypatch, rank, chain):
    """The block forward, gz recompute and dx with the forward chain forced
    to the tensor cores' or the CUDA cores' plan, the inverse chain in
    ragged chunks (3 s_1 rows; rank 1: 24 points), E_1 in pieces of 4 rows
    and the last factor in pieces of 8 columns, and the wgrad with the same
    chain, against the plain versions in f32 (2e-4)."""
    spatial, modes = {1: ((64,), (17,)), 2: ((16, 32), (5, 9)),
                      3: ((8, 8, 16), (6, 3, 5))}[rank]
    monkeypatch.setattr(engine, "FORCED", {
        "chain": chain, "rows_i": 24 if rank == 1 else 3, "dp": 4, "wl": 8})
    ours, plain = _backward_launches(cuda, spatial, modes, "float32",
                                     seed=40 + rank)
    args = _args(cuda, spatial, seed=50 + rank)
    mats = spectral.operand_tensors(spatial, modes, "float32", cuda)
    y = engine.fused_block(*args, mats)
    torch.cuda.synchronize()
    assert _rel_err(y, engine.fused_block_plain(*args, mats)) <= 2e-4
    for name, a, b in zip(("gz", "dx", "dwr", "dwi", "dwb", "dbias"), ours,
                          plain):
        assert _rel_err(a, b) <= 2e-4, (name, _rel_err(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_at_a_formerly_refused_shape(cuda, monkeypatch, dtype):
    """2D 256², modes 32, hidden 64, B=2: the wgrad's tensor-core chain
    does not fit beside its spectra, so the wgrad plans the CUDA cores'
    chain; the block plans the tensor cores' (its work area over C). The
    block forward at its plan and with the CUDA cores' chain forced, and
    the wgrad, against the plain versions (f32 2e-4; bf16 2e-2 of the f32
    plain version)."""
    spatial, modes, h, b = (256, 256), (32, 32), 64, 2
    code = 0 if dtype == "float32" else 1
    block = engine.pick_plan(build.load_fused_block(), code, b, h, h,
                             spatial, modes)
    wplan = engine.pick_wgrad_plan(build.load_fused_wgrad(), code, b, h, h,
                                   spatial, modes)
    assert block["chain"] == "tc" and wplan["chain"] == "fma"
    tdt = getattr(torch, dtype)
    tol = 2e-4 if dtype == "float32" else 2e-2
    args = _args(cuda, spatial, b=b, h=h, o=h, seed=60)
    gz = torch.randn((b, h) + spatial,
                     generator=torch.Generator().manual_seed(61)).to(cuda)
    m32 = {k: spectral.operand_tensors(spatial, modes, "float32", cuda, k)
           for k in ("forward", "wgrad")}
    mats = {k: spectral.operand_tensors(spatial, modes, dtype, cuda, k)
            for k in ("forward", "wgrad")}
    ref = engine.fused_block_plain(*args, m32["forward"])
    t = [a.to(tdt) for a in args]
    ys = [engine.fused_block(*t, mats["forward"])]
    monkeypatch.setattr(engine, "FORCED", {"chain": "fma"})
    ys.append(engine.fused_block(*t, mats["forward"]))
    dw = engine.fused_wgrad(t[0], gz.to(tdt), mats["wgrad"])
    torch.cuda.synchronize()
    for y in ys:
        assert bool(torch.isfinite(y).all()) and _rel_err(y, ref) <= tol
    wref = engine.fused_wgrad_plain(args[0], gz, m32["wgrad"])
    for name, a, r in zip(("dwr", "dwi", "dwb", "dbias"), dw, wref):
        assert a.shape == r.shape and _rel_err(a, r) <= tol, name
