"""The port's contract checks (``repro_torch.analysis``) on the CPU.

Each checker is clean on the port, and each has a mutation that makes it
fire: a doubled launch (launch counts), a stray ``.double()`` in a block's
forward (cast ownership), a doubled psum and a foreign all-gather in a
recorded ``COLLECTIVES`` counter (the collective budget; one clean case on
a real (1,2) gloo mesh), a ``torch.fft`` call, a dtype literal, a
module-level ``import triton``, a ``ctypes.CDLL`` and an ``import jax`` in
a temporary file (the source rules, whose pragma allows what it should),
and 3D 64³ at modes 32³, which the planners refuse even tiled (one
channel's spectra alone take 262,144 B; the smallest tiling 573,184 B: the
shared-memory check). The card: chip_smoke.py phase 34 runs the launch
lint at full width and the shared-memory check with the card's libraries.
"""
import dataclasses
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.analysis import ast_lint, errors, launch_lint, smem
from repro_torch.kernels import engine, ops
from repro_torch.launch import lint as lint_cli
from repro_torch.train import serve_fno_step as sfs


# ---------------------------------------------------------------------------
# Source rules
# ---------------------------------------------------------------------------
def test_the_port_is_clean_under_the_source_rules():
    assert ast_lint.run_ast_lints() == []


# (path under the package, source, the checker that must fire)
MUTATIONS = [
    ("core/spectral.py", "import torch\ny = torch.fft.rfft(x)\n",
     "no-raw-fft"),
    ("core/spectral.py", "from torch import fft\n", "no-raw-fft"),
    ("kernels/ops.py", "import torch\ndef f(x):\n    return "
     "x.to(torch.float32)\n", "dtype-literal"),
    ("train/train_step.py", "import torch\ndef g(x):\n    return "
     "x.to(torch.bfloat16)\n", "dtype-literal"),
    ("kernels/new_kernel.py", "import triton\n", "triton-import"),
    ("kernels/new_kernel.py", "from triton import language as tl\n",
     "triton-import"),
    ("kernels/engine.py", "import ctypes\nlib = ctypes.CDLL('x.so')\n",
     "ctypes-home"),
    ("kernels/engine.py", "from ctypes import CDLL\n", "ctypes-home"),
    ("core/fno.py", "import jax\n", "foreign-import"),
    ("core/fno.py", "from repro.kernels import ops\n", "foreign-import"),
    ("core/fno.py", "import torch.distributed as dist\n"
     "dist.all_reduce(t)\n", "collective-home"),
    ("checkpoint/checkpointer.py", "import torch.distributed as dist\n"
     "dist.broadcast(t, 0)\n", "collective-home"),
]


def _lint(tmp_path, rel, src):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return ast_lint.lint_file(path, tmp_path)


@pytest.mark.parametrize("rel,src,checker", MUTATIONS,
                         ids=[f"{m[2]}-{i}" for i, m in enumerate(MUTATIONS)])
def test_each_source_rule_fires(tmp_path, rel, src, checker):
    got = _lint(tmp_path, rel, src)
    assert [f.checker for f in got] == [checker], got


@pytest.mark.parametrize("rel,src", [
    ("kernels/ops.py", "import torch\ndef f(x):\n    return x.to("
     "torch.float32)  # lint: allow-dtype (an oracle's f32)\n"),
    ("kernels/ops.py", "import torch\n_F32 = torch.float32\n"),
    ("core/fno.py", "import torch\ndef relative_l2(a):\n    return "
     "a.to(torch.float32)\n"),
    ("launch/tool.py", "import torch\ny = torch.float64\n"),
    ("kernels/new_kernel.py", "def launch():\n    import triton\n"),
    ("kernels/ref.py", "import torch\ny = torch.fft.rfft(x)\n"),
    ("kernels/build.py", "import ctypes\nlib = ctypes.CDLL('x.so')\n"),
    ("core/fno.py", "from repro_torch.kernels import ops\n"),
    ("distributed/sharding.py", "import torch.distributed as dist\n"
     "dist.all_reduce(t)\n"),
    ("checkpoint/checkpointer.py", "import torch.distributed as dist\n"
     "dist.barrier()\n")])
def test_the_rules_allow_their_homes_and_the_pragma(tmp_path, rel, src):
    assert _lint(tmp_path, rel, src) == []


# ---------------------------------------------------------------------------
# Launch counts and casts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_block_launches_and_casts_are_clean(rank):
    assert launch_lint.lint_block_matrix(ranks=(rank,)) == []


@pytest.mark.parametrize("arch", ["fno1d", "fno2d", "fno3d"])
def test_model_launches_and_casts_are_clean(arch):
    assert launch_lint.lint_model(archs=(arch,)) == []


def test_rollout_and_serve_contracts_are_clean():
    assert launch_lint.lint_rollout(archs=("fno2d",), ks=(1, 3)) == []
    assert launch_lint.fused_block_contract() == []
    cfg = launch_lint.model_cfg("fno2d", "f32")
    srv = sfs.FNOServer(cfg, launch_lint._model_params(cfg, "cpu"),
                        device="cpu", max_batch=2)
    found, per = launch_lint.serve_step_contract(srv, cfg, rollout_steps=2)
    assert found == [] and per == {1: {"block_fwd": 1.0},
                                   2: {"block_fwd": 1.0}}


class _Twice:
    """The engine as the block's dispatch sees it, with every block-kernel
    call made twice."""

    def __getattr__(self, name):
        return getattr(engine, name)

    def fused_block(self, *a, **kw):
        engine.fused_block(*a, **kw)
        return engine.fused_block(*a, **kw)


def test_a_doubled_launch_fires(monkeypatch):
    monkeypatch.setattr(ops, "engine", _Twice())
    found = launch_lint.lint_block_matrix(ranks=(2,), layouts=("shared",),
                                          variants=("full",), dtypes=("f32",),
                                          spectral=(False,))
    assert found and {f.checker for f in found} == {"launch-count"}
    assert "'block_fwd': 2" in found[0].message


def test_a_stray_double_in_a_block_forward_fires(monkeypatch):
    fwd = engine.fused_block
    monkeypatch.setattr(engine, "fused_block", lambda *a, **kw: (
        lambda y: y.double().to(y.dtype))(fwd(*a, **kw)))
    found = launch_lint.lint_block_matrix(ranks=(2,), layouts=("shared",),
                                          variants=("full",),
                                          dtypes=("f32", "bf16"),
                                          spectral=(False,))
    assert found and {f.checker for f in found} == {"cast-ownership"}
    assert all("float64" in f.message for f in found)
    assert len(found) == 4  # forward and grad, each preset


def test_allowed_casts_follow_the_policy():
    f32 = launch_lint.allowed_casts(configs.PrecisionPolicy.from_name("f32"))
    bf16 = launch_lint.allowed_casts(
        configs.PrecisionPolicy.from_name("bf16"))
    assert f32 == frozenset()
    assert bf16 == {("float32", "bfloat16"), ("bfloat16", "float32")}


# ---------------------------------------------------------------------------
# The collective budget
# ---------------------------------------------------------------------------
def _cfg(layout="scatter", overlap=False):
    return dataclasses.replace(launch_lint.model_cfg("fno2d", "f32"),
                               tp_layout=layout, tp_overlap=overlap)


@pytest.mark.parametrize("layout,overlap,tp", [
    ("scatter", False, 2), ("scatter", True, 2), ("scatter", True, 4),
    ("psum", False, 2)])
def test_the_budget_of_each_layout(layout, overlap, tp):
    cfg, L = _cfg(layout, overlap), 2
    want = launch_lint.collective_budget(cfg, tp)
    block = {("psum", "block"): 1}
    if layout == "psum":
        block = {("psum", "block"): L}
    elif overlap:
        block[("p2p", "block")] = (tp - 1) * (L - 1)
    else:
        block[("reduce_scatter", "block")] = L - 1
    assert want == {**block, ("reduce_scatter", "lift"): 1,
                    ("psum", "proj"): 1}
    assert launch_lint.check_collective_budget(want, cfg, tp=tp,
                                               target="t") == []
    assert launch_lint.collective_budget(cfg, 1, dp=4) == {}
    assert launch_lint.collective_budget(cfg, 2, fno_strategy="dp") == {}


@pytest.mark.parametrize("mutation", ["doubled psum", "foreign all-gather"])
def test_the_budget_fires(mutation):
    cfg = _cfg()
    counts = {f"{k}/{s}": n for (k, s), n in
              launch_lint.collective_budget(cfg, 2).items()}
    if mutation == "doubled psum":
        counts["psum/block"] *= 2
    else:
        counts["all_gather/block"] = 1
    found = launch_lint.check_collective_budget(counts, cfg, tp=2,
                                                target="t")
    assert len(found) == 1 and found[0].checker == "collective-budget"


def test_a_sharded_forward_keeps_its_budget():
    """One (1,2) gloo mesh, reduced fno2d, both TP layouts: every rank's
    collectives are the budget's and its launches num_layers
    block_linear."""
    assert launch_lint.lint_sharded(mesh=(1, 2)) == []


# ---------------------------------------------------------------------------
# Shared memory
# ---------------------------------------------------------------------------
def test_every_preset_fits_a_block():
    found = smem.check_smem()
    assert errors(found) == []
    assert all("core launches not estimated" in f.message for f in found)


def test_an_oversized_launch_fires():
    big = dataclasses.replace(configs.get_config("fno3d"),
                              modes=(32, 32, 32), name="fno3d-m32")
    found = smem.check_smem([big], dtypes=("f32",), variants=("full",))
    assert {f.target.rsplit("/", 1)[1] for f in found} == {
        "block_fwd", "gz_recompute", "dx_adjoint", "wgrad"}
    assert "no tiling holds" in found[0].message
    assert "573184 B" in found[0].message
    est = smem.launch_estimate(big, "block_fwd")
    assert not est.fits and est.plan is None
    pinned = smem.launch_estimate(configs.get_config("fno2d"), "block_fwd",
                                  override=(("rows_i", 8),))
    assert pinned.fits and pinned.source == "override"
    assert pinned.plan["rows_i"] == 8


def test_the_ends_launches_are_estimated():
    cfg = configs.with_fuse_ends(configs.get_config("fno2d"))
    ests = smem.block_launch_estimates(cfg)
    assert {"block_ends_lift", "block_ends_proj"} <= set(ests)
    assert all(e.fits for e in ests.values())
    both = smem.ends_launch_estimate(cfg)
    assert both.fits and both.plan["ep"] > 0


def test_the_lint_cli_is_clean_on_the_cpu(capsys):
    assert lint_cli.main(["--ast", "--smem", "--tuning", "--device",
                          "cpu"]) == 0
    assert "0 errors" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        lint_cli.main(["--device", "cpu"])
    assert torch.cuda.is_available() or lint_cli.main(["--ast"]) == 2
