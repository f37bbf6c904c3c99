"""The LM zoo's serving surface in the port against the JAX reference:
``train/serve_step``'s three makers, the registry (presets field for
field, ``runnable_cells``, ``param_count``, shapes), the frontend stubs,
``convert.lm_params_from_jax``'s refusals, the single-card sharding
helpers, and the serve CLI on the CPU (an LM arch, an FNO arch handed to
``serve_fno``, and the default device refusing without a card).
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import frontend as jfrontend
from repro.models import transformer as jtf
from repro.train import serve_step as jss
from repro_torch import configs, tree
from repro_torch.configs import fno as fno_configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as cli
from repro_torch.models import frontend
from repro_torch.models import transformer as tf
from repro_torch.train import serve_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
F32_TOL = 2e-4


def _close(ours, ref, tol=F32_TOL):
    ours = ours.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(ours - ref).max()) / scale <= tol


def _compiled(fn, *args):
    """`fn` jitted and compiled for these arguments at XLA's lowest backend
    optimisation level (quick on the CPU, where it runs a few times)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(port cfg, reference cfg, reference params, port params)."""
    cfg, jcfg = configs.get_config(arch, True), jconfigs.get_config(arch,
                                                                    True)
    key = jax.random.PRNGKey(0)
    jp = _compiled(functools.partial(jtf.init_lm, cfg=jcfg,
                                     dtype=jnp.float32), key)(key)
    return cfg, jcfg, jp, lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfg)


def _tokens(cfg, shape, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# serve_step's makers
# ---------------------------------------------------------------------------
def test_prefill_step_matches_reference():
    cfg, jcfg, jp, p = _models("qwen2-1.5b")
    toks = _tokens(cfg, (2, 24))
    batch = {"tokens": jnp.asarray(toks)}
    ref, rcache = _compiled(jss.make_prefill_step(jcfg, max_len=32), jp,
                            batch)(jp, batch)
    ours, cache = serve_step.make_prefill_step(cfg, max_len=32)(
        p, {"tokens": torch.tensor(toks)})
    _close(ours, ref)
    assert int(cache["len"]) == int(rcache["len"]) == 24
    assert cache["segments"][0]["k"].shape == rcache["segments"][0]["k"].shape


def test_greedy_decode_step_matches_reference():
    """Three steps, each fed the reference's token: the same next token
    (int32) and logits."""
    cfg, jcfg, jp, p = _models("qwen2-1.5b")
    toks = _tokens(cfg, (2, 16))
    batch = {"tokens": jnp.asarray(toks)}
    _, rcache = _compiled(jss.make_prefill_step(jcfg, max_len=24), jp,
                          batch)(jp, batch)
    _, cache = tf.prefill(p, cfg, torch.tensor(toks), max_len=24)
    jstep = _compiled(jss.make_decode_step(jcfg), jp, rcache,
                      jnp.asarray(toks[:, -1]))
    step = serve_step.make_decode_step(cfg)
    tok = toks[:, -1]
    for _ in range(3):
        rnext, rlogits, rcache = jstep(jp, rcache, jnp.asarray(tok))
        nxt, logits, cache = step(p, cache, torch.tensor(tok))
        _close(logits, rlogits)
        assert nxt.dtype == torch.int32
        assert nxt.tolist() == np.asarray(rnext).tolist()
        tok = np.asarray(rnext)


def test_sampling_decode_step_draws_from_the_generator():
    cfg, _, _, p = _models("qwen2-1.5b")
    toks = torch.tensor(_tokens(cfg, (4, 8)))

    def draw(seed, temperature):
        _, cache = tf.prefill(p, cfg, toks, max_len=12)
        step = serve_step.make_decode_step(cfg, sample=True,
                                           temperature=temperature)
        gen = torch.Generator().manual_seed(seed)
        return [step(p, cache, toks[:, -1], gen)[0] for _ in range(2)]

    a, b = draw(5, 1.0), draw(5, 1.0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(x.dtype == torch.int32 and int(x.min()) >= 0
               and int(x.max()) < cfg.vocab_size for x in a)
    _, cache = tf.prefill(p, cfg, toks, max_len=12)
    greedy = serve_step.make_decode_step(cfg)(p, cache, toks[:, -1])[0]
    assert torch.equal(draw(0, 1e-4)[0], greedy)


def test_encoder_step_matches_reference():
    cfg, jcfg, jp, p = _models("hubert-xlarge")
    x = np.random.default_rng(4).normal(size=(2, 20, cfg.d_model)).astype(
        np.float32)
    batch = {"inputs_embeds": jnp.asarray(x)}
    ref = _compiled(jss.make_encoder_step(jcfg), jp, batch)(jp, batch)
    ours = serve_step.make_encoder_step(cfg)(p, {"inputs_embeds":
                                                 torch.tensor(x)})
    _close(ours, ref)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def test_registry_ids_and_cells_equal_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.FNO_IDS == jconfigs.FNO_IDS
    assert configs.ALL_IDS == jconfigs.ALL_IDS
    assert list(configs.runnable_cells()) == list(jconfigs.runnable_cells())
    assert len(list(configs.runnable_cells())) == 56


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_preset_equals_reference_field_for_field(arch, reduced):
    ours = configs.get_config(arch, reduced)
    ref = jconfigs.get_config(arch, reduced)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("d_attn", "d_kv", "d_inner", "ssm_heads", "is_decoder",
                 "has_attention", "has_ssm", "sub_quadratic"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    assert ours.param_count() == ref.param_count()
    assert (ours.param_count(active_only=True)
            == ref.param_count(active_only=True))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_full_width_tree_equals_reference(arch):
    """The full-width params tree, on the meta device, against the
    reference's ``jax.eval_shape`` of its init: path for path, shape for
    shape."""
    cfg = configs.get_config(arch)
    params = tf.init_lm(None, cfg, torch.float32, device="meta")
    ref = jax.eval_shape(functools.partial(
        jtf.init_lm, cfg=jconfigs.get_config(arch), dtype=jnp.float32),
        jax.random.PRNGKey(0))
    ref = jax.tree_util.tree_map(lambda s: str(tuple(s.shape)), ref)
    ours = tree.map(lambda t: str(tuple(t.shape)), params)
    assert list(zip(tree.paths(ours), tree.leaves(ours))) == list(
        zip(tree.paths(ref), tree.leaves(ref)))
    assert all(t.device.type == "meta" for t in tree.leaves(params))


def test_shapes_and_skips_equal_reference():
    for reduced in (False, True):
        for name in jconfigs.SHAPES:
            assert (dataclasses.asdict(configs.get_shape(name, reduced))
                    == dataclasses.asdict(jconfigs.get_shape(name, reduced)))
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")
    assert isinstance(configs.get_config("fno2d"), configs.FNOConfig)
    with pytest.raises(KeyError):  # configs.fno stays FNO-only
        fno_configs.get_config("qwen2-1.5b")


def test_validate_refuses_bad_configs():
    cfg = configs.get_config("qwen2-1.5b", reduced=True)
    for fields in ({"num_kv_heads": 3}, {"attention": "swa"},
                   {"num_experts": 4, "top_k": 5}):
        with pytest.raises(ValueError):
            dataclasses.replace(cfg, **fields).validate()


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-26b",
                                  "qwen2-1.5b"])
def test_frontend_stubs_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name in jconfigs.SHAPES:
        ours = frontend.frontend_inputs(cfg, configs.get_shape(name))
        ref = jfrontend.frontend_inputs(jcfg, jconfigs.get_shape(name))
        assert {k: tuple(t.shape) for k, t in ours.items()} == \
            {k: tuple(s.shape) for k, s in ref.items()}
        assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
                   for t in ours.values())
    red = configs.get_config(arch, reduced=True)
    a = frontend.fake_frontend_arrays(red, 2, 5,
                                      torch.Generator().manual_seed(1))
    b = frontend.fake_frontend_arrays(red, 2, 5,
                                      torch.Generator().manual_seed(1))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# convert and the single-card sharding helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fault", ["shape", "missing", "extra"])
def test_lm_params_from_jax_refuses_a_wrong_tree(fault):
    cfg, _, jp, _ = _models("mixtral-8x7b")
    bad = jax.tree_util.tree_map(np.asarray, jp)
    if fault == "shape":
        bad["layers"]["moe"]["experts"]["wi"] = \
            bad["layers"]["moe"]["experts"]["wi"][:, :3]
    elif fault == "missing":
        del bad["layers"]["ln2"]
    else:
        bad["layers"]["mlp"] = {"wi": {"w": np.zeros((2, 4, 4), np.float32)}}
    with pytest.raises(ValueError, match="does not match init_lm"):
        lm_params_from_jax(bad, cfg)


def test_lm_params_from_jax_casts():
    cfg, _, jp, _ = _models("qwen2-1.5b")
    p = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(p))
    assert tree.paths(p) == tree.paths(tf.init_lm(None, cfg,
                                                  device="meta"))


def test_lm_sharding_is_single_card():
    x = torch.ones(2, 3)
    assert sharding.shard_activation(x, "embed") is x
    cfg = configs.get_config("qwen2-1.5b")
    assert sharding.kv_rep() == 1
    assert tf.effective_kv_heads(cfg) == cfg.num_kv_heads
    ctx = sharding.ShardingContext(mesh=mesh_mod.Mesh({"data": 1,
                                                       "model": 2}),
                                   batch_axes=("data",))
    with sharding.sharding_context(ctx):
        for call in (lambda: sharding.shard_activation(x, "heads"),
                     lambda: tf.effective_kv_heads(cfg),
                     lambda: tf.init_cache(cfg, 1, 8, device="meta")):
            with pytest.raises(NotImplementedError,
                               match="Queue A item 5"):
                call()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)


def test_cli_serves_an_lm_on_the_cpu():
    proc = _run_cli("--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "16", "--new-tokens",
                    "6")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("arch=qwen2-1.5b batch=2 prefill(16 toks)=")
    assert "device=cpu" in lines[0]
    toks = eval(lines[1].split(":", 1)[1])
    assert len(toks) == 6 and all(0 <= t < 512 for t in toks)


def test_cli_hands_an_fno_arch_to_serve_fno():
    proc = _run_cli("--arch", "fno2d", "--reduced", "--device", "cpu",
                    "--requests", "2", "--max-batch", "2")
    assert proc.returncode == 0, proc.stderr
    assert "serve_fno" in proc.stdout and "all outputs finite" in \
        proc.stdout


def test_cli_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--arch", "qwen2-1.5b", "--reduced"])


def test_cli_refuses_an_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        cli.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])
