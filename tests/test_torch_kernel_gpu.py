"""The fused block CUDA kernel on the card, against its plain PyTorch
version: ranks 1–3, f32 (relative 2e-4) and bf16 (2e-2 against the f32
plain version), the launch counter, and the fused model against the staged
path. Every test needs an NVIDIA GPU (marker ``gpu``) and skips without
one; on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernel_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import fno as tfno
from repro_torch.core import spectral
from repro_torch.kernels import engine

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
    before = engine.LAUNCHES["float32"]
    for _ in range(3):
        engine.fused_block(*args, mats)
    engine.fused_block_plain(*args, mats)
    torch.cuda.synchronize()
    assert engine.LAUNCHES["float32"] - before == 3


def test_forward_only_on_card(cuda):
    spatial, modes = _CASES[1]
    args = _args(cuda, spatial)
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        engine.fused_block(
            *args, spectral.operand_tensors(spatial, modes, "float32", cuda))


def test_fused_model_matches_staged_on_card(cuda):
    cfg = configs.with_fuse_block(configs.get_config("fno2d", reduced=True))
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, cuda)
    x = torch.randn((3, cfg.in_channels) + tuple(cfg.spatial),
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    before = engine.LAUNCHES["float32"]
    with torch.no_grad():
        y = tfno.apply_fno(params, dataclasses.replace(cfg, path="fused"), x)
        y_ref = tfno.apply_fno(params, cfg, x, path="staged")
    torch.cuda.synchronize()
    assert engine.LAUNCHES["float32"] - before == cfg.num_layers
    assert _rel_err(y, y_ref) <= 2e-4
