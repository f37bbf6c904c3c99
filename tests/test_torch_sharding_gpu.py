"""The FNO on a DP×TP mesh on the card (``repro_torch.launch.mesh``,
``distributed.sharding``): ranks spawned on this host's cards, the sharded
forward and one training step against the one-rank fused path, each
rank's launches exact. Over nccl the test needs a card a rank and skips
below that many cards; over gloo the ranks share one card, the collectives
staged through the host. Every test needs an NVIDIA GPU (marker ``gpu``)
and skips without one; on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_sharding_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import fno as tfno
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import mesh_cases as mc
from repro_torch.optim import global_norm
from repro_torch.train import serve_fno_step as sfs
from repro_torch.train import train_step as ts

pytestmark = pytest.mark.gpu

F32_TOL = 2e-4
SPAWN_S = 300.0


def _cards(n: int) -> None:
    """Skip without `n` cards (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; run this file on the "
                    "card with `python -m pytest -m gpu`")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards, the host has "
                    f"{torch.cuda.device_count()}")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


@pytest.mark.parametrize("backend,mesh,cards", [
    ("nccl", (1, 2), 2), ("nccl", (2, 1), 2), ("nccl", (2, 2), 4),
    ("nccl", (1, 4), 4), ("gloo", (2, 2), 1)],
    ids=["nccl-tp2", "nccl-dp2", "nccl-dp2xtp2", "nccl-tp4",
         "gloo-dp2xtp2-one-card"])
def test_sharded_forward_and_step_match_one_rank(backend, mesh, cards):
    _cards(cards)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.with_fuse_block(
        configs.get_config("fno2d", reduced=True)), path="fused")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, cfg.in_channels) + cfg.spatial).astype(
        np.float32)
    y = rng.normal(size=(8, cfg.out_channels) + cfg.spatial).astype(
        np.float32)
    job = {"mesh": mesh, "backend": backend, "device": "cuda", "cases": [
        {"kind": "forward", "cfg": cfg, "seed": 0, "x": x},
        {"kind": "train", "cfg": cfg, "seed": 0, "batch": {"x": x, "y": y}}]}
    ranks = tmesh.spawn(mc.run_rank, mesh[0] * mesh[1], job,
                        timeout_s=SPAWN_S)

    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg, "cuda")
    want = sfs.FNOServer(cfg, params, device="cuda", max_batch=8)(
        torch.from_numpy(x).cuda()).cpu()
    batch = {"x": torch.from_numpy(x).cuda(), "y": torch.from_numpy(y).cuda()}
    loss, g = ts.value_and_grad(ts.make_loss_fn(cfg, fno_path="fused"),
                                params, batch)
    kinds = (("block_linear", "dx_adjoint", "wgrad") if mesh[1] > 1
             else ("block_fwd", "gz_recompute", "dx_adjoint", "wgrad"))
    for fwd, step in ranks:
        assert _rel(fwd["y"], want) <= F32_TOL
        assert fwd["launches"] == {f"{kinds[0]}/float32": cfg.num_layers}
        np.testing.assert_allclose(step["loss"], float(loss), rtol=F32_TOL)
        np.testing.assert_allclose(step["grad_norm"], float(global_norm(g)),
                                   rtol=F32_TOL)
        assert step["launches"] == {f"{k}/float32": cfg.num_layers
                                    for k in kinds}


def test_nccl_refuses_more_ranks_than_cards():
    _cards(1)
    with pytest.raises(ValueError, match="gloo"):
        tmesh.check_backend("nccl", torch.device("cuda", 0),
                            torch.cuda.device_count() + 1)
