"""The tuned launch plans on the card (marker ``gpu``; skips without one):

    python -m pytest -q -m gpu tests/test_torch_tuning_gpu.py

Every committed entry of fno2d at B=8 (f32, bf16, the five kinds) launches
at its plan against the launch's plain version (f32 within 2e-4, bf16
within 2e-2 of the f32 plain version); the resolver's precedence holds at
a real launch (an override over the cache, the cache over the rule); an
override the planner refuses raises before anything launches; the
committed cache is fresh against the card's core library.
"""
import pytest
import torch

from repro_torch.analysis import errors
from repro_torch.kernels import build, engine
from repro_torch.tuning import autotune, resolve, store

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, with TF32 off; skips without one (decided here, never at
    import, so every worker collects the same tests)."""
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


def test_the_committed_cache_is_fresh_on_the_card(cuda):
    assert errors(store.check_tuning_cache(
        core_lib=build.load_fused_core())) == []


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["block_fwd", "core", "gz_recompute",
                                  "dx_adjoint", "wgrad"])
def test_tuned_plans_hold_against_the_plain_versions(cuda, kind, dtype):
    w = autotune.workloads(("fno2d",), (dtype,), (kind,), (8,))[0]
    fields = store.lookup(w.key, w.hidden, w.hidden, w.spatial, w.modes)
    assert fields is not None, w.key
    probe = autotune.Probe(w, cuda, seed=7)
    outs = probe.run(tuple(sorted(fields.items())))
    torch.cuda.synchronize()
    for a, ref in zip(outs, probe.refs):
        assert autotune._rel_err(a, ref) <= probe.tol


def test_precedence_at_a_real_launch(cuda, tmp_path, monkeypatch):
    """A cache entry pins rows_i; an override pins the cluster over it; the
    launch runs the merged plan (the kernel's answer equals the plain
    version) and ``pick_plan`` reports it."""
    lib = build.load_fused_block()
    shape = (64, 64, (128, 128), (32, 32))
    rule = engine.plan_launch("block_fwd", torch.float32, 8, *shape,
                              lib=lib)
    fields = {"cluster": 8, "chain": rule["chain"],
              "rows_f": rule["rows_f"], "rows_i": 4}
    key = "r2/h64-s128x128-m32x32/shared/full/f32/block_fwd/b8"
    path = str(tmp_path / "plans.json")
    store.save_cache({key: {
        "fields": fields, "source": "tuned", "ms": 1.0, "rule_ms": 1.0,
        "probe": {"batch": 8, "hidden": 64, "out": 64,
                  "spatial": [128, 128], "modes": [32, 32]},
        "card": "test", "digest": store.tree_digests()["block"]}}, path=path)
    monkeypatch.setattr(store, "DEFAULT_CACHE_PATH", path)
    got = resolve.resolve_plan("block_fwd", "f32", 8, *shape, lib=lib,
                               override=(("cluster", 16),))
    assert got.plan["cluster"] == 16 and got.plan["rows_i"] == 4
    assert got.sources["rows_i"] == "cache"
    w = autotune.workloads(("fno2d",), ("f32",), ("block_fwd",), (8,))[0]
    probe = autotune.Probe(w, cuda, seed=8)
    (y,) = probe.run((("cluster", 16),))
    torch.cuda.synchronize()
    assert autotune._rel_err(y, probe.refs[0]) <= 2e-4
    picked = engine.pick_plan(lib, 0, 8, *shape, kind="block_fwd",
                              plan=(("cluster", 16),))
    assert (picked["cluster"], picked["rows_i"]) == (16, 4)
    store.reload()


def test_a_refused_override_raises_before_launching(cuda):
    w = autotune.workloads(("fno2d",), ("f32",), ("wgrad",), (8,))[0]
    probe = autotune.Probe(w, cuda, seed=9)
    before = dict(engine.LAUNCHES)
    with pytest.raises(ValueError, match="'cols'"):
        probe.run((("cols", 48),))
    assert dict(engine.LAUNCHES) == before
