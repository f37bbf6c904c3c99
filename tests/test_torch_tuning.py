"""The port's launch-plan tuning (``repro_torch.tuning``) on the CPU.

The key schema (the reference's six segments and a batch bucket) round
trips; the staleness lint fires on a changed kernel digest, a bad key and
an entry whose pinned fields the planner refuses, and the resolver then
plans by rule; the committed cache (``tuning/cache/plans.json``) is fresh,
covers every key the tuner generates, and every entry replans with its
fields pinned within a block's shared memory (the core's through its
library, compiled with g++ against the CUDA emulation); resolution goes
override > cache > rule, field by field, and a refused override raises
naming the field; ``autotune --smoke`` writes a clean cache; the block and
wgrad kernels' 115-shape sweep still plans with the cache in place; and
``with_block_plan`` reaches every engine call of a forward, a training
step and a served request. The card: tests/test_torch_tuning_gpu.py and
chip_smoke.py phase 34.
"""
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess

import pytest
import torch

from repro_torch import configs
from repro_torch.analysis import errors, launch_lint
from repro_torch.core import fno as tfno
from repro_torch.kernels import build, engine
from repro_torch.launch import autotune as autotune_cli
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.train import serve_fno_step as sfs
from repro_torch.train import train_step as ts
from repro_torch.tuning import autotune, plans, resolve, store

HERE = os.path.dirname(os.path.abspath(__file__))
FNO2D = ((64, 64), (128, 128), (32, 32))  # hidden/out, spatial, modes
KEY = "r2/h64-s128x128-m32x32/shared/full/f32/block_fwd/b8"


@pytest.fixture(scope="module")
def core_lib(tmp_path_factory):
    """The core kernel's library compiled with g++ against the CUDA
    emulation headers: its plan is the library's (``fused_core_plan``),
    read through ctypes as on the card."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the core's plan for the CPU")
    out = tmp_path_factory.mktemp("core_plan")
    src = (build.CSRC / "fused_core.cu").read_text()
    cpp = out / "fused_core.cpp"
    cpp.write_text(src.replace("extern __shared__ float smem[];",
                               "float* smem = g_smem[blockIdx.x].data();"))
    lib = out / "libfused_core_emulated.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-pthread",
         "-fno-strict-aliasing", "-Wno-unknown-pragmas", "-include",
         "cuda_runtime.h", f"-I{os.path.join(HERE, 'cuda_emulation')}",
         f"-I{build.CSRC}", str(cpp), "-o", str(lib)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return build.load_core_library(lib)


def _entry(fields, key=KEY, **kw):
    (h, o), spatial, modes = FNO2D
    e = {"fields": fields, "source": "tuned", "ms": 1.0, "rule_ms": 1.1,
         "probe": {"batch": int(key.rsplit("/b", 1)[1]), "hidden": h,
                   "out": o, "spatial": list(spatial),
                   "modes": list(modes)},
         "card": "NVIDIA H100 80GB HBM3, 700.00 W",
         "digest": store.tree_digests()[store.entry_kernel(key)]}
    e.update(kw)
    return e


def _cache(tmp_path, entries):
    path = str(tmp_path / "plans.json")
    store.save_cache(entries, path=path)
    return path


def _resolve(kind="block_fwd", batch=8, override=None, path=None):
    (h, o), spatial, modes = FNO2D
    return resolve.resolve_plan(kind, "float32", batch, h, o, spatial, modes,
                                False, override, cache_path=path)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch,bucket", [(1, 1), (2, 2), (3, 4), (5, 8),
                                          (8, 8)])
@pytest.mark.parametrize("launch", plans.LAUNCH_KINDS)
def test_key_round_trip(launch, batch, bucket):
    key = plans.workload_key(launch, torch.bfloat16, batch, 64, 32,
                             (128, 128), (32, 32), True)
    assert key.endswith(f"/bf16/{launch}/b{bucket}")
    got = plans.parse_key(key)
    assert (got["rank"], got["layout"], got["dtype"], got["launch"],
            got["bucket"]) == (2, "per_mode", "bf16", launch, bucket)
    assert got["shape_class"] == "h64-o32-s128x128-m32x32"
    assert plans.plan_key(2, got["shape_class"], "per_mode", "bf16", launch,
                          bucket) == key


@pytest.mark.parametrize("key", [
    "r2/h64-s128x128-m32x32/shared/full/f32/block_fwd",
    "r4/h64-s128x128-m32x32/shared/full/f32/block_fwd/b8",
    "r2/h64-s128x128-m32x32/shared/partial/f32/block_fwd/b8",
    "r2/h64-s128x128-m32x32/shared/full/f32/block_fwd/b16",
    "r2/h64-s128x128-m32x32/tiled/full/f32/block_fwd/b8",
    "r2/h64-s128x128-m32x32/shared/full/f32/spectral_fwd/b8"])
def test_parse_key_refuses_a_bad_key(key):
    with pytest.raises(ValueError):
        plans.parse_key(key)


# ---------------------------------------------------------------------------
# Staleness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("defect", ["digest", "key", "refused"])
def test_stale_entries_fire_and_are_never_used(tmp_path, defect):
    fields = {"cluster": 8, "chain": "tc", "rows_f": 32, "rows_i": 8}
    key, e = KEY, _entry(fields)
    if defect == "digest":  # the kernel's sources changed since tuning
        e["digest"] = "0" * 16
    elif defect == "key":
        key = KEY.replace("/b8", "/b16")
    else:  # rows_i beyond the inverse chunk's room at clusters of 8
        e["fields"] = dict(fields, rows_i=128)
    path = _cache(tmp_path, {key: e})
    found = errors(store.check_tuning_cache(path))
    assert len(found) == 1 and "the resolver plans this launch by rule" \
        in found[0].message, found
    r = _resolve(path=path)
    assert r.source == "rule" and r.plan == engine.plan_launch(
        "block_fwd", torch.float32, 8, 64, 64, (128, 128), (32, 32))


def test_a_moved_limit_and_a_broken_file_fire(tmp_path):
    path = _cache(tmp_path, {KEY: _entry({"cluster": 8, "chain": "tc",
                                          "rows_f": 32, "rows_i": 8})})
    data = json.load(open(path))
    data["meta"]["smem_limit"] = 16 * 2 ** 20
    json.dump(data, open(path, "w"))
    store.reload()
    assert any("shared memory a block" in f.message
               for f in errors(store.check_tuning_cache(path)))
    open(path, "w").write("{not json")
    store.reload()
    assert errors(store.check_tuning_cache(path))
    assert _resolve(path=path).source == "rule"
    missing = store.check_tuning_cache(str(tmp_path / "none.json"))
    assert [f.severity for f in missing] == ["warn"]


# ---------------------------------------------------------------------------
# The committed cache
# ---------------------------------------------------------------------------
def _committed():
    """The committed entries, read at collection (a file, the same on
    every worker)."""
    try:
        return json.load(open(store.DEFAULT_CACHE_PATH))["entries"]
    except OSError:
        return {}


def test_committed_cache_is_fresh_and_covers_every_key(core_lib):
    """Every key the tuner generates (the presets at full width, f32 and
    bf16, the five kinds, batches 1–8) has an entry tuned on the card:
    the card and its power limit, the tree's kernel digest, the tuned and
    the rule plan's times; nothing is stale."""
    assert store.check_tuning_cache(core_lib=core_lib) == []
    entries = store.load_cache()["entries"]
    assert set(entries) == {w.key for w in autotune.workloads()}
    assert len(entries) == 152
    for key, e in entries.items():
        assert e["card"].startswith("NVIDIA H100") and "W" in e["card"], key
        assert e["source"] in ("tuned", "rule"), key
        assert e["ms"] > 0 and e["rule_ms"] > 0, key
        if e["source"] == "tuned":
            assert e["fields"] != e["rule_fields"], key
        else:
            assert e["fields"] == e["rule_fields"], key


@pytest.mark.parametrize("key", sorted(_committed()))
def test_committed_entry_replans_within_a_block(core_lib, key):
    e = store.load_cache()["entries"][key]
    plan = store.replan(key, e, core_lib)
    assert {f: plan[f] for f in e["fields"]} == e["fields"]
    assert plan["smem"] <= engine._SMEM_LIMIT


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------
def test_resolution_goes_override_cache_rule_field_by_field(tmp_path):
    cached = {"cluster": 8, "chain": "tc", "rows_f": 32, "rows_i": 8}
    path = _cache(tmp_path, {KEY: _entry(cached)})
    rule = _resolve(path=str(tmp_path / "none.json"))
    assert rule.source == "rule" and rule.sources == {}
    got = _resolve(path=path)
    assert got.source == "cache"
    assert {f: got.plan[f] for f in cached} == cached
    got = _resolve(path=path, override=(("cluster", 16),))
    assert got.sources == {"cluster": "override", "chain": "cache",
                           "rows_f": "cache", "rows_i": "cache"}
    assert (got.plan["cluster"], got.plan["rows_f"], got.plan["rows_i"]) \
        == (16, 32, 8)
    # Another batch bucket, shape or kind is not served by the entry.
    assert _resolve(batch=4, path=path).source == "rule"
    assert _resolve(kind="gz_recompute", path=path).source == "rule"
    assert resolve.resolve_plan("block_fwd", "float32", 8, 64, 64, (128, 96),
                                (32, 32), cache_path=path).source == "rule"
    with store.disabled():
        assert _resolve(path=path).plan == rule.plan
    # An override field the launch's kernel lacks is ignored.
    assert _resolve(path=path, override=(("cols", 64),)).source == "cache"


def test_the_engine_launch_takes_the_resolved_plan(tmp_path, monkeypatch):
    """``pick_plan`` of a tuned kind takes the entry; untuned callers
    (kind None) and ``FORCED`` keep their meaning."""
    cached = {"cluster": 8, "chain": "tc", "rows_f": 32, "rows_i": 8}
    path = _cache(tmp_path, {KEY: _entry(cached)})
    monkeypatch.setattr(store, "DEFAULT_CACHE_PATH", path)
    args = (None, 0, 8, 64, 64, (128, 128), (32, 32))
    assert engine.pick_plan(*args, kind="block_fwd")["rows_f"] == 32
    assert engine.pick_plan(*args)["rows_f"] == 64  # untuned: the rule
    assert engine.pick_plan(*args, kind="block_fwd",
                            plan=(("rows_f", 16),))["rows_f"] == 16
    with engine.forced_chain("fma"):  # FORCED wins over cache and override
        assert engine.pick_plan(*args, kind="block_fwd",
                                plan=(("chain", "tc"),))["chain"] == "fma"


def test_the_cache_is_read_once(tmp_path):
    cached = {"cluster": 8, "chain": "tc", "rows_f": 32, "rows_i": 8}
    path = _cache(tmp_path, {KEY: _entry(cached)})
    assert _resolve(path=path).source == "cache"
    os.remove(path)
    assert _resolve(path=path).source == "cache"  # kept, not re-read
    store.reload()
    assert _resolve(path=path).source == "rule"


@pytest.mark.parametrize("kind,field,value", [
    ("block_fwd", "rows_f", 100), ("block_fwd", "rows_i", 129),
    ("block_fwd", "cluster", 2), ("gz_recompute", "chain", "wgmma"),
    ("wgrad", "cols", 48), ("wgrad", "rows_f", 65),
    ("dx_adjoint", "rows_i", 1000)])
def test_a_refused_override_raises_naming_the_field(kind, field, value):
    with pytest.raises(ValueError, match=f"'{field}'"):
        _resolve(kind=kind, override={field: value})


def test_a_refused_config_override_raises_at_the_launch():
    cfg = dataclasses.replace(
        configs.with_fuse_block(configs.get_config("fno2d", reduced=True)),
        path="fused", block_plan=(("rows_f", 1000),))
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros((1, cfg.in_channels) + tuple(cfg.spatial))
    with pytest.raises(ValueError, match="'rows_f'"):
        engine.pick_plan(None, 0, 1, 16, 16, cfg.spatial, cfg.modes,
                         kind="block_fwd", plan=cfg.block_plan)
    with launch_lint.counted_calls() as calls:  # the CPU plans nothing
        tfno.apply_fno(params, cfg, x)
    assert calls == {"block_fwd": cfg.num_layers}


@pytest.mark.parametrize("plan", [(("foo", 1),), (("cluster", 3),),
                                  (("chain", "wgmma"),), (("rows_f", -1),),
                                  (("rows_f", 8), ("cluster", 8)),
                                  (("rows_f", True),)])
def test_config_validate_refuses_a_bad_block_plan(plan):
    cfg = dataclasses.replace(configs.get_config("fno2d"), block_plan=plan)
    with pytest.raises(ValueError, match="block_plan"):
        cfg.validate()


def test_with_block_plan_keeps_zero_fields_resolved():
    cfg = configs.with_block_plan(configs.get_config("fno2d"), cluster=16,
                                  chain="tc", rows_i=0, np=4)
    assert cfg.block_plan == (("chain", "tc"), ("cluster", 16), ("np", 4))
    assert configs.with_block_plan(cfg).block_plan is None
    with pytest.raises(ValueError, match="cluster"):
        configs.with_block_plan(cfg, cluster=3)


# ---------------------------------------------------------------------------
# The tuner off the card
# ---------------------------------------------------------------------------
def test_autotune_smoke_writes_a_clean_cache(tmp_path):
    out = str(tmp_path / "smoke.json")
    assert autotune_cli.main(["--smoke", "--device", "cpu", "--out", out,
                              "--base", str(tmp_path / "none.json")]) == 0
    assert store.check_tuning_cache(out) == []
    entries = store.load_cache(out)["entries"]
    smoke = autotune.workloads(reduced=True)
    assert set(entries) == {w.key for w in smoke if w.kind != "core"}
    assert all(e["source"] == "rule" and e["ms"] is None
               for e in entries.values())
    assert autotune_cli.main(["--device", "cpu"]) == 2


def test_candidates_hold_the_rule_plan_and_the_planners_fields():
    w = autotune.workloads(("fno2d",), ("f32",), ("wgrad",), (8,))[0]
    cands = autotune.candidates(w, None)
    assert cands[0] == autotune.fields_of("wgrad", engine.plan_launch(
        "wgrad", torch.float32, 8, 64, 64, (128, 128), (32, 32)))
    assert {c["cluster"] for c in cands} == {8, 16}
    assert {c["chain"] for c in cands} == {"tc", "fma"}
    assert {16, 32, 64, 128} <= {c["cols"] for c in cands}
    kept = autotune.prune(w, cands, None, log=lambda *a: None)
    assert kept[0] == cands[0] and len(kept) == len(cands)


def _parent_planned():
    spec = importlib.util.spec_from_file_location(
        "_torch_block_shapes", os.path.join(HERE, "test_torch_block.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PARENT_PLANNED


@pytest.mark.parametrize("shape", _parent_planned(),
                         ids=lambda s: "h{}-{}d-{}-m{}".format(*s))
def test_the_shape_sweep_plans_with_the_cache_in_place(shape):
    """Every shape of tests/test_torch_block.py's sweep resolves a plan for
    each tuned block and wgrad kind, shared and per-mode, at B=1 and 8."""
    hidden, rank, n, m = shape
    for per_mode in (False, True):
        for kind in ("block_fwd", "gz_recompute", "dx_adjoint", "wgrad"):
            for b in (1, 8):
                r = resolve.resolve_plan(kind, "float32", b, hidden, hidden,
                                         (n,) * rank, (m,) * rank, per_mode)
                assert r.plan["smem"] <= engine._SMEM_LIMIT


# ---------------------------------------------------------------------------
# The override reaches every launch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("design", ["block", "partial", "spectral", "ends"])
def test_block_plan_reaches_every_engine_call(design):
    cfg = launch_lint.model_cfg("fno2d", "f32",
                                fuse_block=design != "spectral",
                                fuse_ends=design == "ends")
    cfg = configs.with_block_plan(cfg, cluster=8, chain="tc")
    variant = "partial" if design == "partial" else "full"
    params = tfno.init_fno(torch.Generator().manual_seed(0), cfg)
    batch = {"x": torch.randn((2, cfg.in_channels) + tuple(cfg.spatial)),
             "y": torch.randn((2, cfg.out_channels) + tuple(cfg.spatial))}
    seen = []
    with launch_lint.counted_calls(record=seen) as calls:
        step = ts.make_train_step(cfg, AdamW(lr=constant(1e-3)),
                                  fno_path="fused", fno_variant=variant)
        opt = AdamW(lr=constant(1e-3))
        step(params, opt.init(params), batch)
        srv = sfs.FNOServer(cfg, params, device="cpu", variant=variant,
                            max_batch=2)
        srv(batch["x"], rollout_steps=2)
    engine_calls = [p for k, p in seen if k not in ("rdft", "irdft")]
    want_fwd, want_grad = launch_lint.expected_model_launches(cfg, variant)
    assert sum(calls.values()) == sum(want_grad.values()) + 2 * sum(
        want_fwd.values())
    assert engine_calls and all(p == cfg.block_plan for p in engine_calls)
