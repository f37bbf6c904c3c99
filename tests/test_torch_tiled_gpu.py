"""The block and wgrad kernels' tiled plans on the card: at the shapes whose
spectra do not fit one cluster (``configs.TILED``: s1 fno2d at hidden 256,
its per-mode model, s2 256² modes 64², s3 fno3d at hidden 64, s4 fno3d at
128³), the block kernel in the gelu, gelu_vjp, adjoint (dx) and bare
forward modes and the wgrad kernel with and without the bypass, against
their plain PyTorch versions: f32 within 2e-4 of the output's scale, bf16
within 2e-2 of the f32 plain version. Every plan is checked to be tiled (a
hidden k-loop or out tiles). Needs an NVIDIA GPU (marker ``gpu``):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_tiled_gpu.py
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.core import spectral
from repro_torch.kernels import build, engine

pytestmark = pytest.mark.gpu

BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel_err(y, ref) -> float:
    y, ref = y.float(), ref.float()
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def _tiled(plan) -> bool:
    return plan["hc"] < plan["hs"] or plan["ot"] > 1


def _case(name, seed):
    cfg = configs.tiled_config(name)
    h, spatial, modes = cfg.hidden, cfg.spatial, cfg.modes
    gen = torch.Generator().manual_seed(seed)
    rn = lambda *s, sc=1.0: (sc * torch.randn(s, generator=gen)).cuda()
    wshape = (h, h) + (tuple(modes) if cfg.weight_mode == "per_mode"
                       else ())
    x = rn(BATCH, h, *spatial)
    args = [x, rn(*wshape, sc=1.0 / h), rn(*wshape, sc=1.0 / h),
            rn(h, h, sc=1.0 / h), rn(h, 1, sc=0.3)]
    gy = rn(BATCH, h, *spatial)
    return cfg, args, gy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(configs.TILED))
def test_tiled_block_modes_match_plain(name, dtype):
    cfg, (x, wr, wi, wb, bias), gy = _case(name, 11)
    spatial, modes, h = cfg.spatial, cfg.modes, cfg.hidden
    per_mode = cfg.weight_mode == "per_mode"
    lib = build.load_fused_block()
    code = 0 if dtype == "float32" else 1
    for kind in ("block_fwd", "gz_recompute", "dx_adjoint", "spectral_fwd"):
        plan = engine.pick_plan(lib, code, BATCH, h, h, spatial, modes,
                                per_mode, kind=kind)
        assert _tiled(plan), (kind, plan)
    tdt = getattr(torch, dtype)
    t = lambda a: a.to(tdt).contiguous()
    m = {k: spectral.operand_tensors(spatial, modes, dtype, "cuda", k)
         for k in ("forward", "adjoint")}
    m32 = {k: spectral.operand_tensors(spatial, modes, "float32", "cuda", k)
           for k in ("forward", "adjoint")}
    tw = lambda w: t(w).transpose(0, 1)  # dx's [H,O] view, as ops passes it
    runs = {
        "gelu": (lambda: engine.fused_block(
            t(x), t(wr), t(wi), t(wb), t(bias), m["forward"]),
            engine.fused_block_plain(x, wr, wi, wb, bias, m32["forward"])),
        "gelu_vjp": (lambda: engine.fused_block(
            t(x), t(wr), t(wi), t(wb), t(bias), m["forward"],
            act="gelu_vjp", gy=t(gy)),
            engine.fused_block_plain(x, wr, wi, wb, bias, m32["forward"],
                                     act="gelu_vjp", gy=gy)),
        "adjoint": (lambda: engine.fused_block(
            t(gy), tw(wr), tw(wi), t(wb.t()), None, m["adjoint"],
            act="linear", out_dtype=torch.float32, adjoint=True),
            engine.fused_block_plain(
                gy, wr.transpose(0, 1).contiguous(),
                wi.transpose(0, 1).contiguous(), wb.t().contiguous(), None,
                m32["adjoint"], act="linear")),
        "bare": (lambda: engine.fused_block(
            t(x), t(wr), t(wi), None, None, m["forward"], act="linear"),
            engine.fused_block_plain(x, wr, wi, None, None, m32["forward"],
                                     act="linear")),
    }
    tol = 2e-4 if dtype == "float32" else 2e-2
    for mode, (run, ref) in runs.items():
        y = run()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(y).all()), mode
        assert _rel_err(y, ref) <= tol, (mode, _rel_err(y, ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(configs.TILED))
def test_tiled_wgrad_matches_plain(name, dtype):
    cfg, (x, *_), gz = _case(name, 12)
    spatial, modes, h = cfg.spatial, cfg.modes, cfg.hidden
    per_mode = cfg.weight_mode == "per_mode"
    plan = engine.pick_wgrad_plan(build.load_fused_wgrad(),
                                  0 if dtype == "float32" else 1, BATCH, h,
                                  h, spatial, modes, per_mode, kind="wgrad")
    tdt = getattr(torch, dtype)
    mats = spectral.operand_tensors(spatial, modes, dtype, "cuda", "wgrad")
    m32 = spectral.operand_tensors(spatial, modes, "float32", "cuda",
                                   "wgrad")
    tol = 2e-4 if dtype == "float32" else 2e-2
    for bypass in (True, False):
        outs = engine.fused_wgrad(x.to(tdt), gz.to(tdt), mats,
                                  per_mode=per_mode, with_bypass=bypass)
        refs = engine.fused_wgrad_plain(x, gz, m32, per_mode=per_mode,
                                        with_bypass=bypass)
        torch.cuda.synchronize()
        for i, (a, r) in enumerate(zip(outs, refs)):
            assert a.shape == r.shape and bool(torch.isfinite(a).all())
            assert _rel_err(a, r) <= tol, (bypass, i, _rel_err(a, r), plan)
    # s4's wgrad fits one cluster (the parent planned it): only the block
    # is tiled there.
    assert _tiled(plan) == (name != "s4"), plan
