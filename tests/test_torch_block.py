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
    assert plan["chain"] == "tc"
    big = engine.wgrad_plan(64, 64, (128, 128), (32, 32), 16)
    assert big["cluster"] == 16 and big["smem"] < plan["smem"]
    # fno3d at full width plans (clusters of 16, 1 s_1 row a chunk); 64³
    # with modes 32³ does not fit even at one row a chunk.
    f3 = engine.wgrad_plan(32, 32, (64, 64, 64), (16, 16, 16))
    assert f3["cluster"] == 16 and f3["rows_f"] == 1
    assert f3["smem"] <= 232448 and f3["chain"] == "tc"
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
    assert f3["cluster"] == 16 and f3["rows_f"] == 2 and f3["rows_i"] == 2
    assert f3["smem"] <= 232448 and f3["chain"] == "tc"
    with pytest.raises(ValueError, match="shared memory"):
        engine.launch_plan(32, 32, (64, 64, 64), (32, 32, 32))
    # 128 out channels: clusters of 16 (8 per block), since 8 blocks cannot
    # hold them; 256 are more than a cluster of 16 holds, so they take out
    # tiles (clusters of 8: four tiles of 64 channels; of 16: two of 128).
    assert engine.launch_plan(128, 128, (32, 32), (8, 8))["cluster"] == 16
    with pytest.raises(ValueError, match="out channels"):
        engine._cluster_slices(256, 256, 16)
    for cl, tiles in ((8, 4), (16, 2)):
        wide = engine.launch_plan(256, 256, (32, 32), (8, 8), cl)
        assert (wide["cluster"], wide["os"], wide["ot"]) == (cl, 8, tiles)


# Every shape of a sweep (hidden 16–128; 1D 256–8192 at modes N/8 and N/4;
# 2D 64²–512² and 3D 32³–128³ at modes 8 up to N/2 and 64) that the block
# kernel's launch_plan took at clusters of up to 8 and of 16, with shared
# and with per-mode weights, before its phases moved to the tensor cores
# (built at commit e036aba): (hidden, rank, N, modes), N^rank points and
# modes^rank modes.
PARENT_PLANNED = [
    (16, 1, 256, 32), (16, 1, 256, 64), (16, 1, 512, 64), (16, 1, 512, 128),
    (16, 1, 1024, 128), (16, 1, 1024, 256), (16, 1, 2048, 256),
    (16, 1, 2048, 512), (16, 1, 4096, 512), (16, 1, 4096, 1024),
    (16, 1, 8192, 1024), (16, 1, 8192, 2048), (16, 2, 64, 8), (16, 2, 64, 16),
    (16, 2, 64, 32), (16, 2, 128, 8), (16, 2, 128, 16), (16, 2, 128, 32),
    (16, 2, 128, 64), (16, 2, 256, 8), (16, 2, 256, 16), (16, 2, 256, 32),
    (16, 2, 256, 64), (16, 2, 512, 8), (16, 2, 512, 16), (16, 2, 512, 32),
    (16, 2, 512, 64), (16, 3, 32, 8), (16, 3, 32, 16), (16, 3, 64, 8),
    (16, 3, 64, 16), (16, 3, 128, 8), (16, 3, 128, 16), (32, 1, 256, 32),
    (32, 1, 256, 64), (32, 1, 512, 64), (32, 1, 512, 128), (32, 1, 1024, 128),
    (32, 1, 1024, 256), (32, 1, 2048, 256), (32, 1, 2048, 512),
    (32, 1, 4096, 512), (32, 1, 4096, 1024), (32, 1, 8192, 1024),
    (32, 1, 8192, 2048), (32, 2, 64, 8), (32, 2, 64, 16), (32, 2, 64, 32),
    (32, 2, 128, 8), (32, 2, 128, 16), (32, 2, 128, 32), (32, 2, 128, 64),
    (32, 2, 256, 8), (32, 2, 256, 16), (32, 2, 256, 32), (32, 2, 256, 64),
    (32, 2, 512, 8), (32, 2, 512, 16), (32, 2, 512, 32), (32, 2, 512, 64),
    (32, 3, 32, 8), (32, 3, 32, 16), (32, 3, 64, 8), (32, 3, 64, 16),
    (32, 3, 128, 8), (64, 1, 256, 32), (64, 1, 256, 64), (64, 1, 512, 64),
    (64, 1, 512, 128), (64, 1, 1024, 128), (64, 1, 1024, 256),
    (64, 1, 2048, 256), (64, 1, 2048, 512), (64, 1, 4096, 512),
    (64, 1, 4096, 1024), (64, 1, 8192, 1024), (64, 1, 8192, 2048),
    (64, 2, 64, 8), (64, 2, 64, 16), (64, 2, 64, 32), (64, 2, 128, 8),
    (64, 2, 128, 16), (64, 2, 128, 32), (64, 2, 256, 8), (64, 2, 256, 16),
    (64, 2, 256, 32), (64, 2, 512, 8), (64, 2, 512, 16), (64, 2, 512, 32),
    (64, 3, 32, 8), (64, 3, 64, 8), (128, 1, 256, 32), (128, 1, 256, 64),
    (128, 1, 512, 64), (128, 1, 512, 128), (128, 1, 1024, 128),
    (128, 1, 1024, 256), (128, 1, 2048, 256), (128, 1, 2048, 512),
    (128, 1, 4096, 512), (128, 1, 4096, 1024), (128, 1, 8192, 1024),
    (128, 2, 64, 8), (128, 2, 64, 16), (128, 2, 64, 32), (128, 2, 128, 8),
    (128, 2, 128, 16), (128, 2, 128, 32), (128, 2, 256, 8), (128, 2, 256, 16),
    (128, 2, 256, 32), (128, 2, 512, 8), (128, 2, 512, 16), (128, 2, 512, 32),
    (128, 3, 32, 8),
]


def _sweep(hidden, rank, n, m):
    return hidden, (n,) * rank, (m,) * rank


@pytest.mark.parametrize("shape", PARENT_PLANNED,
                         ids=lambda s: "h{}-{}d-{}-m{}".format(*s))
def test_every_shape_planned_before_is_planned_by_both_kernels(shape):
    """The shape range is kept: every shape the block kernel's planner took
    before the tensor-core chains, the block and the wgrad kernel plan now,
    at clusters of up to 8 and of 16, shared and per-mode W, within a
    block's shared memory; where a chain's resident factors or
    accumulator tiles do not fit, its plan says "fma" (the CUDA cores)."""
    hidden, spatial, modes = _sweep(*shape)
    for per_mode in (False, True):
        for cl in (8, 16):
            for plan_fn in (engine.launch_plan, engine.wgrad_plan):
                plan = plan_fn(hidden, hidden, spatial, modes, cl, per_mode)
                assert plan["smem"] <= engine._SMEM_LIMIT
                assert plan["chain"] in engine.CHAINS


def test_formerly_refused_shape_takes_the_second_chain():
    """2D 256² modes 32 at hidden 64 (a wgrad the tensor-core chain refused:
    its resident factors beside the spectra took 251,776 B): the wgrad
    plans the CUDA cores' chain, the block kernel the tensor cores' with
    its work area over C; either kernel takes either chain forced where it
    fits, and a forced chain that does not fit raises."""
    args = (64, 64, (256, 256), (32, 32))
    wgrad = engine.wgrad_plan(*args)
    assert wgrad["chain"] == "fma" and wgrad["smem"] <= engine._SMEM_LIMIT
    assert engine.wgrad_plan(*args, 16)["chain"] == "fma"
    with pytest.raises(ValueError, match="shared memory"):
        engine.wgrad_plan(*args, chain="tc")
    block = engine.launch_plan(*args, 16)
    assert block["chain"] == "tc" and block["smem"] <= engine._SMEM_LIMIT
    assert engine.launch_plan(*args, 16, chain="fma")["chain"] == "fma"
    # 1D 2048 modes 512: the tensor-core chain's accumulator tiles (128)
    # exceed the registers' 64.
    one = engine.wgrad_plan(16, 16, (2048,), (512,))
    assert one["chain"] == "fma"
    assert engine._chain_bytes(4, (2048,), (512,), 64, one["hs"])[1] > 64
    with pytest.raises(ValueError, match="chain must be"):
        engine.launch_plan(*args, chain="wgmma")


def test_forced_chain_forces_both_pickers_and_restores_them(monkeypatch):
    """``engine.forced_chain`` (the measurements' way to time the plan the
    planner does not pick) gives both pickers' plans the forced chain at
    the cluster they would pick, lowers the forced fields of the plans
    that have them, raises where that chain does not fit, and leaves
    ``engine.FORCED`` as it found it."""
    monkeypatch.setattr(engine, "_max_clusters", lambda *a: 8)
    args = (None, 0, 8, 64, 64, (128, 128), (32, 32))
    with engine.forced_chain("fma", rows_f=2, rows_i=3, wl=10 ** 6):
        block, wgrad = engine.pick_plan(*args), engine.pick_wgrad_plan(*args)
    with engine.forced_chain("tc"):
        with pytest.raises(ValueError, match="shared memory"):
            engine.pick_wgrad_plan(None, 0, 8, 64, 64, (256, 256), (32, 32))
    assert engine.FORCED == {}
    free = engine.pick_plan(*args), engine.pick_wgrad_plan(*args)
    assert block["chain"] == wgrad["chain"] == "fma"
    assert block["cluster"] == free[0]["cluster"]
    assert block["rows_f"] == wgrad["rows_f"] == 2 and block["rows_i"] == 3
    assert block["wl"] == engine.launch_plan(64, 64, (128, 128), (32, 32),
                                             block["cluster"],
                                             chain="fma")["wl"]
    assert "rows_i" not in wgrad
    assert free[0]["chain"] == free[1]["chain"] == "tc"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No stub: without the CUDA compiler the build raises."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("fused_block")
    assert not list(tmp_path.rglob("*.so"))
