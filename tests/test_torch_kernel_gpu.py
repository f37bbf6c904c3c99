"""The fused block, wgrad, row-DFT and core CUDA kernels on the card,
against their plain PyTorch versions: ranks 1–3, the block forward and the
three backward launches (gz recompute, dx adjoint, wgrad), the bare
spectral layer (no bypass), the partial variant's rdft / cdft / irdft and
core launches, f32 (relative 2e-4) and bf16 (2e-2 against the f32 plain
version), the launch counter, the fused model (both variants) against the
staged path, and one fused training step of each variant against the
staged one. Every test needs an NVIDIA GPU (marker ``gpu``) and skips without
one; on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernel_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, tree
from repro_torch.core import fno as tfno
from repro_torch.core import spectral
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
    dx = engine.fused_block(gz, t(wr.t()), t(wi.t()), t(wb.t()), None,
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
