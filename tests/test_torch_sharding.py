"""Port parity: the FNO on a DP×TP mesh over ``torch.distributed`` (gloo,
ranks spawned on this CPU) against the JAX reference.

The reference is reduced fno2d (hidden 16, 2 layers, 32×32) with the
fused block, params from its ``init_fno`` carried in with
``params_from_jax``, inputs from numpy with a seed. Each mesh shape is one
spawn (``launch.mesh.spawn``) whose ranks run every case of that mesh
(``launch.mesh_cases``); the tests read the results:

  * forward on (2,1), (1,2), (2,2), (1,4) and (4,1), both variants,
    against the reference's single-device ``apply_fno(path="xla")`` to
    2e-4 (f32), as ``tests/test_distributed.py`` holds the reference;
  * bf16 under TP against the port's single-device bf16 output within
    2e-2 × max(scale, 1); and the port's bf16 error against the f32
    reference at most 3× the reference's own bf16 error (reduced fno1d,
    fno2d, fno3d; one rank and TP (1,2));
  * grads at (2,2) after ``gather_params`` against ``jax.grad`` of the
    reference's loss to 2e-4 of each leaf's magnitude; the step-0 loss and
    grad norm of ``make_train_step(ctx=)`` against the one-rank step;
  * the three collective layouts agree, with the reference's collective
    counts at the blocks (psum: L all-reduces; scatter: L-1
    reduce-scatters and 1 all-reduce; the ring: (tp-1)(L-1) hops and 1
    all-reduce), and exactly L block-kernel calls a rank a forward
    (``block_linear`` under TP, ``block_fwd`` under pure DP);
  * ``FNOServer(ctx=)`` on (2,2) against the one-rank server, sizes 1–8,
    K = 1 and 3;
  * elastic restore: saved on (2,2), restored onto (4,1), in one process
    and by the reference's ``Checkpointer`` bit for bit;
  * the placement without processes: ``make_context``, ``param_specs``,
    ``guard_spec``, ``fno_collective_bytes`` and ``collective_plan``
    against the reference's, on a mesh that is a shape only;
  * what refuses: nccl with two ranks on one card, the oracle paths under
    a multi-rank context, ``serve_fno`` with dp·tp ≠ the world size.

On the CPU the kernels' plain versions run, so the block-kernel calls are
counted at the wrappers (``mesh_cases`` ``calls``); on the card
``chip_smoke.py`` phase 33 counts launches.
"""
import concurrent.futures
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.configs.fno import with_precision as jwith_precision
from repro.core import fno as jfno
from repro.distributed import sharding as jshd
from repro.optim import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.roofline.analysis import fno_collective_bytes as jbytes
from repro.train import serve_fno_step as jsfs
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import params_from_jax
from repro_torch.core import fno as tfno
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import mesh_cases as mc
from repro_torch.launch import serve_fno as tcli
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.roofline.analysis import fno_collective_bytes
from repro_torch.train import serve_fno_step as tsfs
from repro_torch.train import train_step as ts

B = 8
L = 2  # reduced fno2d's layers
F32_TOL, BF16_TOL = 2e-4, 2e-2
BF16_FACTOR = 3.0  # the port's bf16 error over the reference's own
ARCHS = ("fno1d", "fno2d", "fno3d")
FORWARD_MESHES = [(2, 1), (1, 2), (2, 2), (1, 4), (4, 1)]
LAYOUTS = {"psum": ("psum", False), "scatter": ("scatter", False),
           "ring": ("scatter", True)}
SIZES = tuple(range(1, 9))
KS = (1, 3)
SPAWN_S = 240.0


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().to(torch.float32) if
                      isinstance(t, torch.Tensor) else t, np.float32)


def _rel(a, b) -> float:
    """max |a - b| / max(max |b|, 1)."""
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def _leaf_rel(a, b) -> float:
    """max |a - b| over the reference leaf's own magnitude."""
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _tcfg(arch="fno2d", dtype="f32", **kw):
    cfg = tconfigs.with_precision(
        tconfigs.with_fuse_block(tconfigs.get_config(arch, reduced=True)),
        dtype)
    return dataclasses.replace(cfg, path="fused", **kw)


def _jcfg(arch="fno2d"):
    return dataclasses.replace(jget_config(arch, reduced=True),
                               fuse_block=True)


@functools.lru_cache(maxsize=None)
def _inputs(arch="fno2d"):
    """Reference params (and as numpy), input and target."""
    jcfg = _jcfg(arch)
    jparams = jfno.init_fno(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, jcfg.in_channels) + tuple(jcfg.spatial)
                   ).astype(np.float32)
    y = rng.normal(size=(B, jcfg.out_channels) + tuple(jcfg.spatial)
                   ).astype(np.float32)
    return types.SimpleNamespace(
        jcfg=jcfg, jparams=jparams, x=x, y=y,
        pnp=jax.tree_util.tree_map(np.asarray, jparams))


@functools.lru_cache(maxsize=None)
def _ref(arch="fno2d"):
    """``_inputs`` with the reference's f32 forward (xla) and its own bf16
    error (pallas, as it serves)."""
    r = _inputs(arch)
    y32 = np.asarray(jax.jit(lambda p, a: jfno.apply_fno(
        p, r.jcfg, a, path="xla"))(r.jparams, jnp.asarray(r.x)))
    y16 = jfno.apply_fno(r.jparams, jwith_precision(r.jcfg, "bf16"),
                         jnp.asarray(r.x), path="pallas")
    err16 = float(np.abs(np.asarray(y16.astype(jnp.float32)) - y32).max())
    return types.SimpleNamespace(**vars(r), y32=y32, err16=err16)


@functools.lru_cache(maxsize=None)
def _ref_grads():
    r = _ref()
    batch = {"x": jnp.asarray(r.x), "y": jnp.asarray(r.y)}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jfno.fno_loss(p, r.jcfg, batch, path="xla")))(r.jparams)
    return float(loss), jax.tree_util.tree_map(np.asarray, g)


def _counts(d, site):
    """``{kind: n}`` of a case's ``collectives`` ("kind/site" keys) at
    `site`."""
    out = {}
    for key, n in d.items():
        kind, where = key.split("/")
        if where == site:
            out[kind] = out.get(kind, 0) + n
    return out


def _requests():
    rng = np.random.default_rng(3)
    shape = (_inputs().jcfg.in_channels,) + tuple(_inputs().jcfg.spatial)
    return [(rng.normal(size=(n,) + shape).astype(np.float32), k)
            for k in KS for n in SIZES]


def _case(kind, arch="fno2d", dtype="f32", **kw):
    r = _inputs(arch)
    cfg_kw = {k: kw.pop(k) for k in ("tp_layout", "tp_overlap", "fuse_ends")
              if k in kw}
    case = {"kind": kind, "cfg": _tcfg(arch, dtype, **cfg_kw),
            "params": r.pnp}
    if kind == "forward":
        case["x"] = r.x
    if kind in ("grads", "train", "save"):
        case["batch"] = {"x": r.x, "y": r.y}
    case.update(kw)
    return case


def _cases(mesh, ckpt_dir):
    """Every case of a mesh, by name; each mesh runs both variants."""
    tp = mesh[1]
    cases = {"full": _case("forward"),
             "partial": _case("forward", variant="partial")}
    if tp > 1:
        for name, (layout, ring) in LAYOUTS.items():
            cases[f"layout {name}"] = _case("forward", tp_layout=layout,
                                            tp_overlap=ring)
    if mesh == (2, 1):
        cases["ends"] = _case("forward", fuse_ends=True)
    if mesh == (1, 2):
        for arch in ARCHS:
            cases[f"bf16 {arch}"] = _case("forward", arch, "bf16")
        cases["ends"] = _case("forward", fuse_ends=True)
        cases["fno3d"] = _case("forward", "fno3d")
    if mesh == (2, 2):
        cases["bf16 fno2d"] = _case("forward", "fno2d", "bf16")
        cases["grads"] = _case("grads")
        cases["train"] = _case("train")
        cases["train microbatches"] = _case("train", microbatches=2)
        cases["strategy dp"] = _case("forward", fno_strategy="dp")
        cases["serve"] = _case("serve", requests=_requests())
        cases["save"] = _case("save", dir=str(ckpt_dir), step=1)
    if mesh == (1, 4):
        cases["grads ring"] = _case("grads", tp_layout="scatter",
                                    tp_overlap=True)
    if mesh == (4, 1):
        cases["restore"] = _case("restore", dir=str(ckpt_dir), step=1)
    return cases


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_ckpt")


@pytest.fixture(scope="module")
def runs(ckpt_dir):
    """{mesh: {case name: [per-rank results]}}: one spawn a mesh, in two
    waves of at most 8 ranks side by side ((4,1) restores what (2,2)
    saved)."""
    def run(mesh):
        cases = _cases(mesh, ckpt_dir)
        job = {"mesh": mesh, "backend": "gloo", "device": "cpu",
               "cases": list(cases.values())}
        ranks = tmesh.spawn(mc.run_rank, mesh[0] * mesh[1], job,
                            timeout_s=SPAWN_S)
        return {name: [r[i] for r in ranks] for i, name in enumerate(cases)}

    out = {}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        first = ((2, 2), (2, 1), (1, 2))
        done = pool.map(run, first)
        for arch in ARCHS:  # the references, while the ranks run
            _ref(arch)
        _ref_grads()
        out.update(zip(first, done))
        wave = ((1, 4), (4, 1))
        out.update(zip(wave, pool.map(run, wave)))
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["full", "partial"])
@pytest.mark.parametrize("mesh", FORWARD_MESHES, ids=str)
def test_sharded_forward_matches_reference(runs, mesh, variant):
    r = _ref()
    for rank in runs[mesh][variant]:
        assert rank["y"].shape == r.y32.shape
        assert _rel(rank["y"], r.y32) <= F32_TOL, (mesh, variant)


@pytest.mark.parametrize("mesh", FORWARD_MESHES, ids=str)
def test_block_calls_a_rank_are_exact(runs, mesh):
    """L block-kernel calls a rank a forward: the linear block under TP,
    the whole block under pure DP; the partial variant's three a layer."""
    kind = "block_linear" if mesh[1] > 1 else "block_fwd"
    for rank in runs[mesh]["full"]:
        assert rank["calls"] == {kind: L}
    for rank in runs[mesh]["partial"]:
        assert rank["calls"] == {"rdft": L, "core": L, "irdft": L}


def test_fused_ends_fold_under_dp_and_not_under_tp(runs):
    r = _ref()
    for mesh, calls in (((2, 1), {"block_ends": 2}),
                        ((1, 2), {"block_linear": L})):
        for rank in runs[mesh]["ends"]:
            assert rank["calls"] == calls, mesh
            assert _rel(rank["y"], r.y32) <= F32_TOL, mesh


def test_fno3d_under_tp_matches_reference(runs):
    r = _ref("fno3d")
    for rank in runs[(1, 2)]["fno3d"]:
        assert _rel(rank["y"], r.y32) <= F32_TOL


def test_strategy_dp_folds_tp_into_the_batch(runs):
    for rank in runs[(2, 2)]["strategy dp"]:
        assert rank["calls"] == {"block_fwd": L}
        assert rank["collectives"] == {"all_gather/batch": 1}
        assert _rel(rank["y"], _ref().y32) <= F32_TOL


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------
def _port_bf16(arch):
    r = _ref(arch)
    y = tfno.apply_fno(params_from_jax(r.pnp), _tcfg(arch, "bf16"),
                       torch.from_numpy(r.x))
    assert y.dtype == torch.bfloat16
    return _np(y)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=str)
def test_bf16_under_tp_matches_one_rank(runs, mesh):
    single = _port_bf16("fno2d")
    scale = max(float(np.abs(single).max()), 1.0)
    for rank in runs[mesh]["bf16 fno2d"]:
        assert float(np.abs(rank["y"] - single).max()) < BF16_TOL * scale


@pytest.mark.parametrize("where", ["one rank", "tp (1,2)"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_error_within_three_times_the_references(runs, arch, where):
    r = _ref(arch)
    ys = ([_port_bf16(arch)] if where == "one rank"
          else [rank["y"] for rank in runs[(1, 2)][f"bf16 {arch}"]])
    for y in ys:
        err = float(np.abs(y - r.y32).max())
        assert err <= BF16_FACTOR * r.err16, (arch, where, err, r.err16)


# ---------------------------------------------------------------------------
# Grads and the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case,mesh", [("grads", (2, 2)),
                                       ("grads ring", (1, 4))])
def test_sharded_grads_match_jax_grad(runs, case, mesh):
    loss, g_ref = _ref_grads()
    ref_leaves = jax.tree_util.tree_leaves(g_ref)
    for rank in runs[mesh][case]:
        np.testing.assert_allclose(rank["loss"], loss, rtol=1e-5)
        ours = tree.leaves(rank["grads"])
        assert len(ours) == len(ref_leaves)
        for a, b in zip(ours, ref_leaves):
            assert a.shape == b.shape
            assert _leaf_rel(a, b) <= F32_TOL


@pytest.mark.parametrize("microbatches", [1, 2])
def test_sharded_train_step_matches_one_rank(runs, microbatches):
    """One step on (2,2) against one rank's, with and without microbatches
    (each rank splits its 4 rows)."""
    r = _ref()
    cfg = _tcfg()
    params = params_from_jax(r.pnp)
    opt = AdamW(lr=constant(1e-3))
    step = ts.make_train_step(cfg, opt, fno_path="fused",
                              microbatches=microbatches)
    batch = {"x": torch.from_numpy(r.x), "y": torch.from_numpy(r.y)}
    new, _, metrics = step(params, opt.init(params), batch)
    name = "train" if microbatches == 1 else "train microbatches"
    for rank in runs[(2, 2)][name]:
        np.testing.assert_allclose(rank["loss"], float(metrics["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(rank["grad_norm"],
                                   float(metrics["grad_norm"]), rtol=1e-5)
        for a, b in zip(tree.leaves(rank["params"]), tree.leaves(new)):
            assert _leaf_rel(a, b) <= F32_TOL
        # A forward and a backward a microbatch: 3 block-kernel calls a
        # layer each.
        assert rank["calls"] == {k: L * microbatches for k in
                                 ("block_linear", "dx_adjoint", "wgrad")}


# ---------------------------------------------------------------------------
# The collective layouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)], ids=str)
def test_collective_layouts_agree_and_count_as_the_reference(runs, mesh):
    tp = mesh[1]
    want = {"psum": {"psum": L},
            "scatter": {"reduce_scatter": L - 1, "psum": 1},
            "ring": {"p2p": (tp - 1) * (L - 1), "psum": 1}}
    psum = runs[mesh]["layout psum"]
    for name in LAYOUTS:
        for i, rank in enumerate(runs[mesh][f"layout {name}"]):
            assert _rel(rank["y"], psum[i]["y"]) <= 1e-5, name
            assert _counts(rank["collectives"], "block") == want[name]
            # The lift's row-parallel partial becomes the first block's
            # shard; proj1's partials are all-reduced.
            assert _counts(rank["collectives"], "lift") == \
                {"reduce_scatter": 1}
            assert _counts(rank["collectives"], "proj") == {"psum": 1}
            assert rank["calls"] == {"block_linear": L}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def test_sharded_server_matches_one_rank(runs):
    r = _ref()
    srv = tsfs.FNOServer(_tcfg(), params_from_jax(r.pnp), device="cpu",
                         max_batch=8)
    for rank in runs[(2, 2)]["serve"]:
        assert rank["buckets"] == [2, 4, 8]  # the quantum × dp
        assert rank["plan"]["graphed"] is False
        assert rank["plan"]["backend"] == "gloo"
        for (x, k), y in zip(_requests(), rank["ys"]):
            want = srv(torch.from_numpy(x), rollout_steps=k)
            assert y.shape == tuple(want.shape)
            assert _rel(y, want) <= 1e-5, (x.shape[0], k)


# ---------------------------------------------------------------------------
# Checkpoints across meshes
# ---------------------------------------------------------------------------
def test_elastic_restore_is_bit_equal_across_meshes(runs, ckpt_dir):
    saved = runs[(2, 2)]["save"][0]["state"]
    for rank in runs[(4, 1)]["restore"]:
        for a, b in zip(tree.leaves(rank["state"]), tree.leaves(saved)):
            np.testing.assert_array_equal(a, b)
    cfg = _tcfg()
    opt = AdamW(lr=constant(1e-3))
    params = tfno.abstract_params(cfg)
    target = {"params": tree.map(lambda t: torch.empty(0), params),
              "opt": tree.map(lambda t: torch.empty(0, dtype=t.dtype),
                              opt.init(params))}
    one = Checkpointer(str(ckpt_dir)).restore(1, target)
    for a, b in zip(tree.leaves(one), tree.leaves(saved)):
        np.testing.assert_array_equal(_np(a), b)
    r = _ref()
    jtarget = {"params": r.jparams,
               "opt": JAdamW(lr=jconstant(1e-3)).init(r.jparams)}
    theirs = JCheckpointer(str(ckpt_dir)).restore(1, jtarget)
    for a, b in zip(jax.tree_util.tree_leaves(theirs), tree.leaves(saved)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


# ---------------------------------------------------------------------------
# The placement, without processes
# ---------------------------------------------------------------------------
SHAPES = [(2, 1), (1, 2), (2, 2), (1, 4), (4, 2), (2, 3), (1, 3)]


def _jmesh(mesh):
    return types.SimpleNamespace(shape=dict(mesh.shape))


@pytest.mark.parametrize("strategy", [None, "dp"])
@pytest.mark.parametrize("arch", ARCHS + ("fno2d-large",))
@pytest.mark.parametrize("shape", SHAPES + [(2, 2, 2)], ids=str)
def test_make_context_matches_reference(shape, arch, strategy):
    mesh = tmesh.make_debug_mesh(*shape[-2:], pod=shape[0]
                                 if len(shape) == 3 else 0)
    for reduced in (True, False):
        cfg = tconfigs.get_config(arch, reduced=reduced)
        ours = shd.make_context(cfg, mesh, fno_strategy=strategy)
        theirs = jshd.make_context(jget_config(arch, reduced=reduced),
                                   _jmesh(mesh), fno_strategy=strategy)
        assert ours.batch_axes == tuple(theirs.batch_axes)
        assert ours.model_axis == theirs.model_axis


@pytest.mark.parametrize("fno_tp", [True, False])
@pytest.mark.parametrize("arch", ARCHS + ("fno2d-large",))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_param_specs_match_reference(shape, arch, fno_tp):
    mesh = tmesh.make_debug_mesh(*shape)
    for reduced in (True, False):
        tcfg = tconfigs.get_config(arch, reduced=reduced)
        jcfg = jget_config(arch, reduced=reduced)
        ours = shd.param_specs(tcfg, mesh, tfno.abstract_params(tcfg),
                               fno_tp=fno_tp)
        abstract = jax.eval_shape(
            lambda: jfno.init_fno(jax.random.PRNGKey(0), jcfg))
        theirs = jshd.param_specs(jcfg, _jmesh(mesh), abstract,
                                  fno_tp=fno_tp)
        leaves = jax.tree_util.tree_leaves(
            theirs, is_leaf=lambda s: isinstance(s, jax.sharding.
                                                 PartitionSpec))
        assert len(tree.leaves(ours)) == len(leaves)
        for a, b in zip(tree.leaves(ours), leaves):
            assert tuple(a) == tuple(b)


@pytest.mark.parametrize("spec,shape", [
    (("model", None), (16, 16)), (("model", None), (15, 16)),
    ((None, "data"), (4, 6)), ((("data", "model"), None), (8, 3)),
    ((("data", "model"), None), (6, 3)), ((), (5,)),
    (("model",), (12,))])
def test_guard_spec_matches_reference(spec, shape):
    mesh = tmesh.make_debug_mesh(2, 4)
    ours = shd.guard_spec(shd.P(*spec), shape, mesh)
    theirs = jshd.guard_spec(jax.sharding.PartitionSpec(*spec), shape,
                             _jmesh(mesh))
    assert tuple(ours) == tuple(theirs)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS + ("fno2d-large",))
def test_collective_bytes_match_reference(arch, dtype):
    tcfg = tconfigs.with_precision(tconfigs.get_config(arch), dtype)
    jcfg = jwith_precision(jget_config(arch), dtype)
    for dp, tp in ((4, 2), (2, 4), (8, 1), (2, 3), (1, 2)):
        for scattered in (True, False):
            for batch in (1, 8, 12):
                assert fno_collective_bytes(
                    tcfg, dp, tp, scattered=scattered, batch=batch) == \
                    jbytes(jcfg, dp, tp, scattered=scattered, batch=batch)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2), (1, 4), (2, 3)],
                         ids=str)
def test_collective_plan_matches_reference(shape, layout):
    r = _ref()
    lay, ring = LAYOUTS[layout]
    mesh = tmesh.make_debug_mesh(*shape)
    tcfg = _tcfg(tp_layout=lay, tp_overlap=ring)
    jcfg = dataclasses.replace(r.jcfg, path="pallas", tp_layout=lay,
                               tp_overlap=ring)
    ours = tsfs.FNOServer(tcfg, params_from_jax(r.pnp), device="cpu",
                          max_batch=8, ctx=shd.make_context(tcfg, mesh))
    jctx = jshd.make_context(jcfg, _jmesh(mesh))
    theirs = jsfs.FNOServer(jcfg, r.jparams, ctx=jctx, max_batch=8)
    plan, jplan = ours.collective_plan(), theirs.collective_plan()
    # The smallest bucket is the kernel's batch block (1 here, the tuned
    # plan's there) × the DP degree, so the modeled bytes are held at it.
    assert ours.buckets[0] == plan["dp"]
    wire = jbytes(jcfg, plan["dp"], plan["tp"], scattered=lay == "scatter"
                  and plan["tp"] > 1, batch=ours.buckets[0])
    assert plan["wire_bytes_per_fwd"] == wire["total"]
    assert plan["wire_bytes_interior_layer"] == wire["interior_per_layer"]
    for key, value in jplan.items():
        if not key.startswith("wire_bytes"):
            assert plan[key] == value, key
    assert plan["graphed"] is False and plan["backend"] is None


def test_config_layout_fields_match_reference():
    ours, theirs = tconfigs.get_config("fno2d"), jget_config("fno2d")
    assert (ours.tp_layout, ours.tp_overlap) == (theirs.tp_layout,
                                                 theirs.tp_overlap)
    cfg = tconfigs.with_tp_layout(ours, "psum", overlap=True)
    assert (cfg.tp_layout, cfg.tp_overlap) == ("psum", True)
    with pytest.raises(ValueError, match="tp_layout"):
        dataclasses.replace(ours, tp_layout="ring").validate()


def test_mesh_coordinates_and_groups_are_row_major():
    mesh = tmesh.make_debug_mesh(2, 2, pod=2)
    assert tmesh.batch_axes(mesh) == ("pod", "data")
    assert tmesh.n_chips(mesh) == 8
    mesh.rank = 6  # pod 1, data 1, model 0
    assert mesh.coords() == {"pod": 1, "data": 1, "model": 0}
    assert mesh.group_ranks(("model",)) == [6, 7]
    assert mesh.group_ranks(("data",)) == [4, 6]
    assert mesh.group_ranks(("pod", "data")) == [0, 2, 4, 6]
    assert mesh.axis_index(("pod", "data")) == 3


# ---------------------------------------------------------------------------
# What refuses
# ---------------------------------------------------------------------------
def test_nccl_refuses_two_ranks_on_one_card():
    card = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="gloo"):
        tmesh.check_backend("nccl", card, max(torch.cuda.device_count(),
                                              1) + 1)
    with pytest.raises(ValueError, match="gloo"):
        tmesh.check_backend("nccl", torch.device("cpu"), 1)
    with pytest.raises(ValueError, match="backend"):
        tmesh.check_backend("mpi", torch.device("cpu"), 1)
    tmesh.check_backend("gloo", card, 4)  # gloo stages through the host


@pytest.mark.parametrize("path", ["staged", "ref"])
def test_oracle_paths_refuse_a_multi_rank_context(path):
    r = _ref()
    cfg = _tcfg()
    ctx = shd.make_context(cfg, tmesh.make_debug_mesh(2, 2))
    with shd.sharding_context(ctx), pytest.raises(ValueError,
                                                  match="fused path"):
        tfno.apply_fno(params_from_jax(r.pnp), cfg, torch.from_numpy(r.x),
                       path=path)


def test_tp_refuses_the_spectral_only_path():
    r = _ref()
    cfg = dataclasses.replace(_tcfg(), fuse_block=False)
    ctx = shd.make_context(cfg, tmesh.make_debug_mesh(1, 2))
    with shd.sharding_context(ctx), pytest.raises(ValueError,
                                                  match="fuse_block"):
        tfno.apply_fno(params_from_jax(r.pnp), cfg, torch.from_numpy(r.x))


def test_serve_cli_refuses_a_mesh_other_than_the_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = tcli.build_parser().parse_args(
        ["--reduced", "--device", "cpu", "--dp", "2", "--tp", "2",
         "--backend", "gloo"])
    with pytest.raises(SystemExit, match="dp2xtp2 needs 4"):
        tcli.run(args)
    args = tcli.build_parser().parse_args(
        ["--reduced", "--device", "cpu", "--dp", "2", "--replay",
         "--backend", "gloo"])
    with pytest.raises(SystemExit, match="--replay"):
        tcli.run(args)


def test_pick_tp_matches_reference():
    from repro.launch.serve_fno import _pick_tp as jpick
    for n in range(1, 17):
        for hidden in (8, 16, 32, 64, 128, 12):
            assert tcli._pick_tp(n, hidden) == jpick(n, hidden)


# ---------------------------------------------------------------------------
# The kernels' plans at the TP shard shapes
# ---------------------------------------------------------------------------
def _shard_shapes():
    """(name, H/tp, O, spatial, modes, per_mode) of every TP shard the
    reference's mesh tests and phase 33 run: reduced fno1d/2d/3d at tp 2
    and 4, fno2d at tp 2 and 4, fno3d and fno2d-large at tp 2."""
    out = []
    for arch, reduced, tps in (("fno1d", True, (2, 4)),
                               ("fno2d", True, (2, 4)),
                               ("fno3d", True, (2, 4)),
                               ("fno2d", False, (2, 4)),
                               ("fno3d", False, (2,)),
                               ("fno2d-large", False, (2,))):
        c = tconfigs.get_config(arch, reduced=reduced)
        for tp in tps:
            out.append((f"{c.name}{'-reduced' if reduced else ''}-tp{tp}",
                        c.hidden // tp, c.hidden, c.spatial, c.modes,
                        c.weight_mode == "per_mode"))
    return out


@pytest.mark.parametrize("chain", [None, "fma"], ids=["by-fit", "fma"])
@pytest.mark.parametrize("shape", _shard_shapes(), ids=lambda s: s[0])
def test_shard_shapes_are_planned(shape, chain):
    """The linear block [O, H/tp], its adjoint [H/tp, O] and the wgrad at
    each shard shape: planned at the chain that fits, and on the CUDA
    cores' chain forced."""
    from repro_torch.kernels import engine
    _, h, o, spatial, modes, per_mode = shape
    for hid, out in ((h, o), (o, h)):
        plan = engine.launch_plan(hid, out, spatial, modes,
                                  per_mode=per_mode, chain=chain)
        assert plan["chain"] in engine.CHAINS
        assert chain is None or plan["chain"] == chain
    plan = engine.wgrad_plan(h, o, spatial, modes, per_mode=per_mode,
                             chain=chain)
    assert chain is None or plan["chain"] == chain


def test_a_failing_rank_fails_the_spawn_with_its_traceback():
    job = {"mesh": (1, 2), "backend": "gloo", "device": "cpu",
           "cases": [{"kind": "no such case",
                                    "cfg": _tcfg(), "params": _inputs().pnp}]}
    with pytest.raises(RuntimeError, match="unknown case kind"):
        tmesh.spawn(mc.run_rank, 2, job, timeout_s=SPAWN_S)
