"""Port parity: the fused FNO block of ``repro_torch`` against the JAX
reference's one-kernel block (``ops.fno_block_nd``, ``path="pallas"``, the
Pallas kernel in interpret mode as the reference's own tests run it), plus
the wrappers' contract: checks, launch plans, no fallback, and no tensor
that requires grad (``ops.fno_block_nd`` is the differentiable entry).

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
    """The raw wrappers refuse tensors that require grad and name the
    differentiable entry."""
    args, mats = _engine_args()
    args[1] = args[1].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="ops.fno_block_nd"):
        engine.fused_block(*args, mats)
    x = args[0].clone().requires_grad_(True)
    wmats = tspec.operand_tensors(x.shape[2:], _CASES[2][1], "float32",
                                  "cpu", "wgrad")
    with pytest.raises(RuntimeError, match="ops.fno_block_nd"):
        engine.fused_wgrad(x, torch.zeros(2, 6, *x.shape[2:]), wmats)


def test_wrapper_modes_check_their_operands():
    args, mats = _engine_args()
    x, wr, wi, wb, bias = args
    gy = torch.zeros((2, 6) + tuple(x.shape[2:]))
    with pytest.raises(ValueError, match="gy"):
        engine.fused_block(*args, mats, act="gelu_vjp")
    with pytest.raises(ValueError, match="gy"):
        engine.fused_block(*args, mats, gy=gy)
    with pytest.raises(ValueError, match="gy must be"):
        engine.fused_block(*args, mats, act="gelu_vjp",
                           gy=gy[:, :-1].contiguous())
    with pytest.raises(ValueError, match="act"):
        engine.fused_block(*args, mats, act="relu")
    with pytest.raises(TypeError, match="out_dtype"):
        engine.fused_block(*args, mats, out_dtype=torch.float64)
    y = engine.fused_block(x, wr, wi, wb, None, mats, act="linear",
                           out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    wmats = tspec.operand_tensors(x.shape[2:], _CASES[2][1], "float32",
                                  "cpu", "wgrad")
    with pytest.raises(ValueError, match="DFT operand"):
        engine.fused_wgrad(x, gy, mats)  # the forward bundle's [k,n] stages
    with pytest.raises(ValueError, match="gz must be"):
        engine.fused_wgrad(x, gy[:1], wmats)
    dwr, dwi, dwb, db = engine.fused_wgrad(x, gy, wmats)
    assert tuple(dwr.shape) == (6, 8) and tuple(db.shape) == (6, 1)


def test_wgrad_plan_full_width_and_limits():
    plan = engine.wgrad_plan(64, 64, (128, 128), (32, 32))  # fno2d
    assert plan["cluster"] == 8 and plan["hs"] == 8 and plan["os"] == 8
    assert plan["cols"] == 128 and plan["smem"] <= 232448
    big = engine.wgrad_plan(64, 64, (128, 128), (32, 32), 16)
    assert big["cluster"] == 16 and big["smem"] < plan["smem"]
    # fno3d at full width plans (clusters of 16, 3 s_1 rows a chunk); 64³
    # with modes 32³ does not fit even at one row a chunk.
    f3 = engine.wgrad_plan(32, 32, (64, 64, 64), (16, 16, 16))
    assert f3["cluster"] == 16 and f3["rows_f"] == 3
    assert f3["smem"] <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        engine.wgrad_plan(32, 32, (64, 64, 64), (32, 32, 32))
    with pytest.raises(ValueError, match="hidden channels"):
        engine.wgrad_plan(1024, 8, (16,), (4,))


def test_wrapper_raises_off_cpu_and_cuda():
    """No fallback: a tensor on neither the CPU nor a CUDA device raises."""
    args, mats = _engine_args()
    meta = [a.to("meta") for a in args]
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        engine.fused_block(*meta, [m.to("meta") for m in mats])


def test_per_mode_weights_rejected_on_fused_path():
    """Per-mode weights [O,H,k_1..k_R] were once refused on the fused path;
    they now run there (forward and grads, both variants) and match the
    staged path. Only weights whose modes differ from the block's are
    refused."""
    args, modes = _block_args(2, 0)
    x, wr, wi, wb, bias = (torch.from_numpy(a) for a in args)
    rng = np.random.default_rng(1)
    wpm = [torch.tensor(rng.normal(size=tuple(wr.shape) + modes) / 8,
                        dtype=torch.float32) for _ in range(2)]
    for variant in ("full", "partial"):
        leaves = {p: [t.clone().requires_grad_(True)
                      for t in (x, *wpm, wb, bias)]
                  for p in ("fused", "staged")}
        ys = {p: tops.fno_block_nd(*leaves[p], modes, path=p,
                                   variant=variant) for p in leaves}
        _allclose_rel(_np(ys["fused"]), _np(ys["staged"]), 2e-4)
        grads = {p: torch.autograd.grad(torch.sin(ys[p]).sum(), leaves[p])
                 for p in leaves}
        for a, b in zip(grads["fused"], grads["staged"]):
            assert a.shape == b.shape
            _allclose_rel(_np(a), _np(b), 2e-4)
    bad = wpm[0][..., :4]
    with pytest.raises(ValueError, match="per-mode"):
        tops.fno_block_nd(x, bad, bad, wb, bias, modes, path="fused")


def test_launch_plan_full_width_and_limits():
    plan = engine.launch_plan(64, 64, (128, 128), (32, 32))  # fno2d
    assert plan["cluster"] == 8 and plan["hs"] == 8 and plan["os"] == 8
    assert plan["smem"] <= 232448
    small = engine.launch_plan(8, 6, (16, 32), (5, 9))
    assert small["cluster"] == 4 and small["os"] == 2
    f3 = engine.launch_plan(32, 32, (64, 64, 64), (16, 16, 16))  # fno3d
    assert f3["cluster"] == 16 and f3["rows_f"] == 3
    assert f3["smem"] <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        engine.launch_plan(32, 32, (64, 64, 64), (32, 32, 32))
    # 128 out channels: clusters of 16 (8 per block), since 8 blocks cannot
    # hold them; 256 are more than a cluster of 16 holds.
    assert engine.launch_plan(128, 128, (32, 32), (8, 8))["cluster"] == 16
    with pytest.raises(ValueError, match="out channels"):
        engine.launch_plan(256, 256, (32, 32), (8, 8))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No stub: without the CUDA compiler the build raises."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("fused_block")
    assert not list(tmp_path.rglob("*.so"))
