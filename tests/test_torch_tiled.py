"""The block and wgrad kernels' tiled plans on the CPU: the planners
(``engine.launch_plan`` / ``wgrad_plan``) and the layer around them.

* The shapes whose spectra do not fit one cluster (s1 2D 128² modes 32²
  hidden 256, s2 2D 256² modes 64² hidden 64, s3 3D 64³ modes 16³ hidden
  64, s4 3D 128³ modes 16³ hidden 32) plan, block and wgrad, shared and
  per-mode W, f32 and bf16, at clusters of 8 and of 16, within a block's
  232,448 B, tiled (a hidden k-loop, hc < hs, or out tiles, ot > 1; s4's
  wgrad fits one cluster and keeps its untiled plan), and the kernels'
  layouts mirrored in Python hold each plan's bytes;
* ``analysis.smem`` estimates each tiled launch at the plan it resolves;
* every shape the untiled planner took (the 115-shape sweep, every key of
  the committed tuned cache, phase 28's 256² modes 32) keeps its plan
  field for field (hc = hs, one out tile, the wgrad one hidden tile),
  held against the parent planner's plans as digests;
* 3D 64³ at modes 32³ still raises ``PlanRefused`` (no tiling holds it);
* pins of hc / ot (``FNOConfig.block_plan``, ``plan=`` of the resolver)
  force a tiling, and a refused pin names its field;
* ``analysis.launch_lint`` counts num_layers launches a forward and four
  (spectral-only: three) a layer a forward and backward of reduced models
  whose launches resolve to tiled plans through ``FNOConfig.block_plan``.

The kernels' tiled code is held against its plain versions under CUDA
emulation in tests/test_torch_kernel_emulated_tiled.py and on the card in
tests/test_torch_tiled_gpu.py and chip_smoke.py.
"""
import dataclasses
import hashlib
import json
from pathlib import Path

import pytest

from repro_torch import configs
from repro_torch.analysis import launch_lint, smem
from repro_torch.kernels import engine
from repro_torch.tuning import plans as P
from repro_torch.tuning import resolve

from test_torch_block import PARENT_PLANNED

LIMIT = 232448
# name -> (hidden, spatial, modes)
SHAPES = {"s1": (256, (128, 128), (32, 32)),
          "s2": (64, (256, 256), (64, 64)),
          "s3": (64, (64, 64, 64), (16, 16, 16)),
          "s4": (32, (128, 128, 128), (16, 16, 16))}
CACHE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
         "tuning" / "cache" / "plans.json")
# sha256[:16] of the parent planner's plans (launch_plan then wgrad_plan,
# shared then per-mode, clusters 8 then 16; json, sorted keys): over the
# 115-shape sweep, and over the tuned cache's probe shapes with phase 28's
# 256² modes 32.
SWEEP_DIGEST = "5c9735ae6d96c19e"
PROBE_DIGEST = "9f5285e57377503b"
PHASE_28 = (64, 64, (256, 256), (32, 32))


def _tiled(plan) -> bool:
    return plan["hc"] < plan["hs"] or plan["ot"] > 1


def _untiled_fields(shapes):
    """The plans of `shapes` (hidden, out, spatial, modes) without their
    tiling fields, each checked untiled."""
    out = []
    for h, o, sp, m in shapes:
        for per_mode in (False, True):
            for cl in (8, 16):
                for fn in (engine.launch_plan, engine.wgrad_plan):
                    p = fn(h, o, sp, m, cl, per_mode)
                    assert (p["hc"], p["ot"], p.get("ht", 1)) == (
                        p["hs"], 1, 1), (fn.__name__, h, sp, m, p)
                    rest = {k: p[k] for k in sorted(p)
                            if k not in ("hc", "ot", "ht")}
                    out.append([fn.__name__, h, o, list(sp), list(m),
                                per_mode, cl, rest])
    return hashlib.sha256(json.dumps(out, sort_keys=True).encode()
                          ).hexdigest()[:16]


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_tiled_shapes_plan_within_a_block(name, per_mode, dtype, cluster):
    h, spatial, modes = SHAPES[name]
    block = engine.launch_plan(h, h, spatial, modes, cluster, per_mode)
    wgrad = engine.wgrad_plan(h, h, spatial, modes, cluster, per_mode)
    assert _tiled(block)
    assert _tiled(wgrad) == (name != "s4")
    for kind, plan in (("block_fwd", block), ("wgrad", wgrad)):
        cl, os_ = plan["cluster"], plan["os"]
        assert plan["smem"] <= LIMIT and plan["chain"] in engine.CHAINS
        assert os_ <= engine._MAX_OUT and 1 <= plan["hc"] <= plan["hs"]
        assert plan["hs"] == -(-h // cl)
        assert (plan["ot"] - 1) * cl * os_ < h <= plan["ot"] * cl * os_
        got = resolve.resolve_plan(kind, dtype, 2, h, h, spatial, modes,
                                   per_mode, (("cluster", cl),)).plan
        assert got == plan, (kind, got, plan)
    kloop = block["hc"] < block["hs"]
    lay = engine._block_layout(
        4, h, h, spatial, modes, block["hc"], block["os"], block["rows_f"],
        block["rows_i"], block["wl"], block["dp"], block["chain"], per_mode,
        kloop=kloop)
    assert lay["bytes"] == block["smem"]
    cl = wgrad["cluster"]
    assert wgrad["ht"] == -(-h // (cl * wgrad["hc"]))
    assert engine._wgrad_bytes(
        4, min(h, cl * wgrad["hc"]), min(h, cl * wgrad["os"]), spatial,
        modes, wgrad["hc"], wgrad["os"], wgrad["rows_f"], wgrad["cols"],
        chain=wgrad["chain"])[0] == wgrad["smem"]


@pytest.mark.parametrize("name", list(configs.TILED))
def test_smem_estimates_the_tiled_launches(name):
    """``analysis.smem`` resolves each launch of a tiled config's training
    step to the planner's plan (tiled: clusters of 16), within the
    budget."""
    cfg = configs.tiled_config(name)
    per_mode = cfg.weight_mode == "per_mode"
    args = (cfg.hidden, cfg.hidden, cfg.spatial, cfg.modes, 16, per_mode)
    ests = smem.block_launch_estimates(cfg)
    assert set(ests) == {"block_fwd", "gz_recompute", "dx_adjoint",
                         "wgrad"}
    for kind, est in ests.items():
        want = (engine.wgrad_plan(*args) if kind == "wgrad"
                else engine.launch_plan(*args))
        assert est.fits and est.plan == want and est.smem_bytes == \
            want["smem"], kind
    assert smem.check_smem([cfg], variants=("full",)) == []


def test_tiled_plans_take_clusters_of_16(monkeypatch):
    """Whatever the card's occupancy, a tiled shape's launches take
    clusters of 16 (fewer tiles than 8's); an untiled one still weighs the
    waves (fno2d: 8 where 16-block clusters do not all fit at once)."""
    monkeypatch.setattr(engine, "_max_clusters", lambda *a: 1)
    for name, (h, spatial, modes) in SHAPES.items():
        for pick in (engine.pick_plan, engine.pick_wgrad_plan):
            plan = pick("lib", 0, 8, h, h, spatial, modes)
            assert plan["cluster"] == 16, (name, pick.__name__, plan)
    assert engine.pick_plan("lib", 0, 8, 64, 64, (128, 128),
                            (32, 32))["cluster"] == 8


def test_every_shape_planned_before_keeps_its_plan():
    """The 115 shapes of test_torch_block.py's sweep: untiled and, field
    for field, the parent planner's plans."""
    shapes = [(h, h, (n,) * r, (m,) * r) for h, r, n, m in PARENT_PLANNED]
    assert _untiled_fields(shapes) == SWEEP_DIGEST


def test_the_cached_and_phase_28_shapes_keep_their_plans():
    """Every key of the committed tuned cache (its probe shape) and phase
    28's 2D 256² modes 32 hidden 64: untiled and the parent's plans; every
    entry's fields pin an untiled plan."""
    cache = json.loads(CACHE.read_text())["entries"]
    probes = sorted({(e["probe"]["hidden"], e["probe"]["out"],
                      tuple(e["probe"]["spatial"]),
                      tuple(e["probe"]["modes"])) for e in cache.values()})
    assert _untiled_fields(probes + [PHASE_28]) == PROBE_DIGEST
    for key, e in cache.items():
        if P.parse_key(key)["launch"] == "core":
            continue
        p = e["probe"]
        plan = engine.plan_launch(
            P.parse_key(key)["launch"], "float32", p["batch"], p["hidden"],
            p["out"], tuple(p["spatial"]), tuple(p["modes"]),
            "/per_mode/" in key, e["fields"])
        assert not _tiled(plan), key


@pytest.mark.parametrize("per_mode", [False, True],
                         ids=["shared", "per_mode"])
def test_no_tiling_holds_64_cubed_modes_32(per_mode):
    """One channel's spectra at 32³ modes take 262,144 B: every tiling of
    either kernel refuses the shape, at either cluster size."""
    for fn in (engine.launch_plan, engine.wgrad_plan):
        for cl in (8, 16):
            with pytest.raises(engine.PlanRefused,
                               match="no tiling holds") as exc:
                fn(32, 32, (64, 64, 64), (32, 32, 32), cl, per_mode)
            assert exc.value.field is None


def test_pins_force_a_tiling_and_a_refused_pin_names_its_field():
    args = (16, 16, (32, 32), (8, 8))
    free = engine.launch_plan(*args)
    assert not _tiled(free) and (free["cluster"], free["hs"]) == (8, 2)
    # The untiled values pinned: the untiled plan.
    assert engine.launch_plan(*args, hc=2, ot=1) == free
    both = engine.launch_plan(*args, hc=1, ot=2)
    assert (both["hc"], both["ot"], both["os"]) == (1, 2, 1)
    wg = engine.wgrad_plan(*args, hc=1, ot=2)
    assert (wg["hc"], wg["ot"], wg["ht"]) == (1, 2, 2)
    for fn in (engine.launch_plan, engine.wgrad_plan):
        with pytest.raises(engine.PlanRefused, match="hc=3") as exc:
            fn(*args, 8, hc=3)
        assert exc.value.field == "hc"
        with pytest.raises(engine.PlanRefused, match="ot=3") as exc:
            fn(*args, 8, ot=3)
        assert exc.value.field == "ot"
    with pytest.raises(engine.PlanRefused) as exc:
        resolve.resolve_plan("dx_adjoint", "f32", 2, *args,
                             override=(("hc", 7),))
    assert exc.value.field == "hc"
    got = resolve.resolve_plan("wgrad", "bf16", 2, *args,
                               override=(("hc", 1), ("ot", 2)))
    assert _tiled(got.plan) and got.sources == {"hc": "override",
                                                "ot": "override"}
    # The ends take no tiled plan: pinned, or where a shape needs one.
    with pytest.raises(engine.PlanRefused, match="ends") as exc:
        engine.launch_plan(*args, ends=(3, 32, 32, 1), ot=2)
    assert exc.value.field == "ot"
    with pytest.raises(engine.PlanRefused, match="ends"):
        engine.launch_plan(64, 64, (64, 64, 64), (16, 16, 16),
                           ends=(1, 128, 128, 1))
    cfg = configs.with_block_plan(configs.get_config("fno2d"), hc=1, ot=2)
    assert cfg.block_plan == (("hc", 1), ("ot", 2))
    for bad in ({"hc": -1}, {"ot": "2"}, {"ot": True}):
        with pytest.raises(ValueError, match="positive int"):
            P.normalize_override(bad)


# Pins that force both kernels' tiled plans on the reduced models: hidden 16
# at clusters of 4 (hs 4): chunks of 3 channels (the last ragged), 2 out
# tiles; fno3d's hidden 8 (hs 2): chunks of 1, 2 out tiles.
_PINS = {"fno1d": (("cluster", 4), ("hc", 3), ("ot", 2)),
         "fno2d": (("cluster", 4), ("hc", 3), ("ot", 2)),
         "fno3d": (("cluster", 4), ("hc", 1), ("ot", 2))}


@pytest.mark.parametrize("arch", list(_PINS))
def test_lint_counts_launches_of_models_on_tiled_plans(arch):
    record = []
    found = launch_lint.lint_model(
        archs=(arch,), dtypes=("f32",),
        designs=("block", "partial", "spectral"), block_plan=_PINS[arch],
        record=record)
    assert found == []
    cfg = configs.get_config(arch, reduced=True)
    seen = set()
    for kind, override in record:
        if kind not in engine.KINDS + engine.SPECTRAL_KINDS:
            continue  # the partial variant's core and row kernels
        assert override == _PINS[arch], kind
        plan = resolve.resolve_plan(kind, "f32", 2, cfg.hidden, cfg.hidden,
                                    cfg.spatial, cfg.modes,
                                    override=override).plan
        assert _tiled(plan) and plan["ot"] == 2, (kind, plan)
        seen.add(kind)
    assert set(engine.KINDS) <= seen
    assert {"spectral_fwd", "spectral_dx", "spectral_wgrad"} <= seen
    # The launch counts the lint holds: L a forward, 4L (spectral-only:
    # 3L) a forward and backward.
    full = launch_lint.model_cfg(arch, "f32")
    fwd, grad = launch_lint.expected_model_launches(full)
    assert fwd == {"block_fwd": full.num_layers}
    assert grad == {k: full.num_layers for k in engine.KINDS}
    spec = dataclasses.replace(full, fuse_block=False)
    assert sum(launch_lint.expected_model_launches(spec)[1].values()) == \
        3 * full.num_layers
