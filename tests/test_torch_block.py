"""Port parity: the fused FNO block of ``repro_torch`` against the JAX
reference's one-kernel block (``ops.fno_block_nd``, ``path="pallas"``, the
Pallas kernel in interpret mode as the reference's own tests run it), plus
the wrapper's contract: checks, launch plan, no fallback, forward-only.

On the CPU the fused wrapper runs the kernel's plain PyTorch version; the
CUDA kernel itself is checked on the card (tests/test_torch_kernel_gpu.py
and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PrecisionPolicy as JPolicy
from repro.kernels import ops as jops
from repro_torch.configs.base import PrecisionPolicy
from repro_torch.core import spectral as tspec
from repro_torch.kernels import build, engine
from repro_torch.kernels import ops as tops

_CASES = {
    1: ((64,), (17,)),
    2: ((16, 32), (5, 9)),
    3: ((8, 8, 16), (3, 3, 5)),
}


def _allclose_rel(a, b, tol):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _block_args(rank, seed, b=2, h=8, o=6):
    spatial, modes = _CASES[rank]
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: (sc * rng.normal(size=s)).astype(np.float32)
    args = (mk(b, h, *spatial), mk(o, h, sc=1.0 / h), mk(o, h, sc=1.0 / h),
            mk(o, h, sc=1.0 / h), mk(o, sc=0.3))
    return args, modes


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_fused_block_matches_reference_pallas_f32(rank):
    args, modes = _block_args(rank, rank)
    ours = tops.fno_block_nd(*(torch.from_numpy(a) for a in args), modes,
                             path="fused")
    theirs = jops.fno_block_nd(*(jnp.asarray(a) for a in args), modes,
                               path="pallas", variant="full")
    assert ours.dtype == torch.float32
    assert tuple(ours.shape) == tuple(theirs.shape)
    _allclose_rel(_np(ours), theirs, 2e-4)


@pytest.mark.parametrize("path", ["ref", "staged"])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_block_oracles_match_reference(rank, path):
    args, modes = _block_args(rank, 10 + rank)
    ours = tops.fno_block_nd(*(torch.from_numpy(a) for a in args), modes,
                             path=path)
    theirs = jops.fno_block_nd(*(jnp.asarray(a) for a in args), modes,
                               path="xla")
    _allclose_rel(_np(ours), theirs, 2e-4)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_fused_block_bf16_each_side_within_tolerance(rank):
    """bf16 policy: the port and the reference are each held to the f32
    reference within 2e-2 (never bf16 to 2e-4)."""
    args, modes = _block_args(rank, 20 + rank)
    ref32 = jops.fno_block_nd(*(jnp.asarray(a) for a in args), modes,
                              path="xla")
    ours = tops.fno_block_nd(*(torch.from_numpy(a) for a in args), modes,
                             path="fused",
                             policy=PrecisionPolicy.from_name("bf16"))
    theirs = jops.fno_block_nd(*(jnp.asarray(a) for a in args), modes,
                               path="pallas",
                               policy=JPolicy.from_name("bf16"))
    assert ours.dtype == torch.bfloat16
    _allclose_rel(_np(ours), ref32, 2e-2)
    _allclose_rel(np.asarray(theirs, np.float32), ref32, 2e-2)


def _engine_args(rank=2, dtype=torch.float32, seed=0):
    args, modes = _block_args(rank, seed)
    x, wr, wi, wb, bias = (torch.from_numpy(a).to(dtype) for a in args)
    mats = tspec.operand_tensors(x.shape[2:], modes,
                                 str(dtype).removeprefix("torch."), "cpu")
    return [x, wr, wi, wb, bias.reshape(-1, 1)], mats


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_plain_version_matches_reference_kernel(rank):
    """``fused_block_plain`` (what the card's kernel is compared against)
    computes the reference kernel's block-forward function."""
    args, mats = _engine_args(rank, seed=40 + rank)
    ours = engine.fused_block_plain(*args, mats)
    jx, jwr, jwi, jwb, jb = (jnp.asarray(a.numpy()) for a in args)
    _, modes = _CASES[rank]
    theirs = jops.fno_block_nd(jx, jwr, jwi, jwb, jb[:, 0], modes,
                               path="pallas")
    _allclose_rel(_np(ours), theirs, 2e-4)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    args, mats = _engine_args()
    before = dict(engine.LAUNCHES)
    y = engine.fused_block(*args, mats)
    torch.testing.assert_close(y, engine.fused_block_plain(*args, mats),
                               rtol=0, atol=0)
    assert dict(engine.LAUNCHES) == before


def test_wrapper_rejects_bad_operands():
    args, mats = _engine_args()
    x, wr, wi, wb, bias = args
    with pytest.raises(TypeError):
        engine.fused_block(x.double(), wr, wi, wb, bias, mats)
    with pytest.raises(TypeError):
        engine.fused_block(x, wr.to(torch.bfloat16), wi, wb, bias, mats)
    with pytest.raises(ValueError):
        engine.fused_block(x, wr[:, :-1].contiguous(), wi, wb, bias, mats)
    with pytest.raises(ValueError):
        engine.fused_block(x, wr, wi, wb, bias.reshape(-1), mats)
    with pytest.raises(ValueError):
        engine.fused_block(x.transpose(2, 3), wr, wi, wb, bias, mats)
    with pytest.raises(ValueError):
        engine.fused_block(x, wr, wi, wb, bias, mats[:-1])
    with pytest.raises(ValueError):  # operands of another grid
        other = tspec.operand_tensors((16, 30), (5, 9), "float32", "cpu")
        engine.fused_block(x, wr, wi, wb, bias, other)


def test_wrapper_is_forward_only():
    args, mats = _engine_args()
    args[1] = args[1].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        engine.fused_block(*args, mats)


def test_wrapper_raises_off_cpu_and_cuda():
    """No fallback: a tensor on neither the CPU nor a CUDA device raises."""
    args, mats = _engine_args()
    meta = [a.to("meta") for a in args]
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        engine.fused_block(*meta, [m.to("meta") for m in mats])


def test_per_mode_weights_rejected_on_fused_path():
    args, modes = _block_args(2, 0)
    x, wr, wi, wb, bias = (torch.from_numpy(a) for a in args)
    wpm = wr[..., None, None].expand(*wr.shape, *modes).contiguous()
    with pytest.raises(ValueError, match="per-mode"):
        tops.fno_block_nd(x, wpm, wpm, wb, bias, modes, path="fused")


def test_launch_plan_full_width_and_limits():
    plan = engine.launch_plan(64, 64, (128, 128), (32, 32))  # fno2d
    assert plan["cluster"] == 8 and plan["hs"] == 8 and plan["os"] == 8
    assert plan["smem"] <= 232448
    small = engine.launch_plan(8, 6, (16, 32), (5, 9))
    assert small["cluster"] == 4 and small["os"] == 2
    with pytest.raises(ValueError, match="shared memory"):
        engine.launch_plan(32, 32, (64, 64, 64), (16, 16, 16))
    with pytest.raises(ValueError, match="out channels"):
        engine.launch_plan(128, 128, (32, 32), (8, 8))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No stub: without the CUDA compiler the build raises."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("fused_block")
    assert not list(tmp_path.rglob("*.so"))
