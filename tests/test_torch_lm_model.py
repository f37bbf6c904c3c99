"""Port parity of the unified transformer (``repro_torch.models.
transformer``) against the JAX reference's, for every one of the ten
archs, reduced, batch 2: ``forward``'s logits and MoE aux loss (32 tokens),
``prefill``'s logits and cache leaves (32 tokens into a cache of 48
positions), and three teacher-forced ``decode_step``s (the same tokens fed
to both packages, so an argmax tie cannot cascade) with their logits and
``len``; and a ring cache that wraps (hymba, 160 prompt tokens against
128-slot rings).

Weights are the reference's ``init_lm(PRNGKey(0), cfg, jnp.float32)``
carried through numpy and ``convert.lm_params_from_jax``; tokens and the
frontend's embeddings come from numpy seeds. The MoE archs run at
capacity_factor 8, as the reference's decode-consistency test does. f32:
within 2e-4 of the reference, scaled by max(1, max|ref|); bf16 (the same
weights cast by each package): the port's error against the reference's
f32 at most 3× the reference's own bf16 error, the convention of
``test_torch_sharding.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as jtf
from repro_torch import configs, tree
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import transformer as tf

F32_TOL = 2e-4
BF16_FACTOR = 3.0
B, S, MAX_LEN, STEPS = 2, 32, 48, 3
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
DECODERS = [a for a in configs.ARCH_IDS
            if configs.get_config(a).is_decoder]
# The reference's programs compile at XLA's lowest backend optimisation
# level: the same HLO in about half the compile time on the CPU, where each
# runs a few times.
XLA_FAST = {"xla_backend_optimization_level": 0}


def _compiled(fn, *args, **kwargs):
    """`fn` jitted, lowered for these arguments and compiled (XLA_FAST)."""
    return jax.jit(fn).lower(*args, **kwargs).compile(XLA_FAST)


def _cfgs(arch):
    cfg, jcfg = configs.get_config(arch, reduced=True), jget(arch,
                                                             reduced=True)
    if cfg.num_experts:  # no capacity drops that differ across lengths
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        jcfg = dataclasses.replace(jcfg, capacity_factor=8.0)
    return cfg, jcfg


def _inputs(cfg, seed, seq):
    """tokens [B, seq + STEPS] int32 and the frontend's embeddings."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, seq + STEPS)).astype(
        np.int32)
    extra = {}
    if cfg.frontend == "audio":
        extra["inputs_embeds"] = rng.normal(
            size=(B, seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        extra["prefix_embeds"] = rng.normal(
            size=(B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return tokens, extra


def _numpy(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cache_leaves(cache):
    """(path, f32 numpy) of a cache's leaves in key order, either package's
    (lists and dicts alike)."""
    if isinstance(cache, dict) and not torch.is_tensor(cache.get("len")):
        cache = jax.tree_util.tree_map(_numpy, cache)
    else:
        cache = tree.map(lambda t: t.float().numpy().copy(), cache)
    return list(zip(tree.paths(cache), tree.leaves(cache)))


@functools.lru_cache(maxsize=None)
def _params(arch):
    _, jcfg = _cfgs(arch)
    init = functools.partial(jtf.init_lm, cfg=jcfg, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    return _compiled(init, key)(key)


@functools.lru_cache(maxsize=None)
def _ref(arch, dt, seq=S, max_len=MAX_LEN, forward=True):
    """The reference's outputs at dtype `dt` ("f32" / "bf16") as numpy."""
    cfg, jcfg = _cfgs(arch)
    jdt = DTYPES[dt][1]
    params = jax.tree_util.tree_map(lambda a: a.astype(jdt), _params(arch))
    tokens, extra = _inputs(cfg, 17, seq)
    jextra = {k: jnp.asarray(v, jdt) for k, v in extra.items()}
    toks = None if "inputs_embeds" in extra else jnp.asarray(tokens[:, :seq])
    out = {}
    if forward:
        fwd = functools.partial(jtf.forward, cfg=jcfg)
        logits, aux = _compiled(fwd, params, tokens=toks, **jextra)(
            params, tokens=toks, **jextra)
        out["logits"], out["aux"] = _numpy(logits), float(aux)
    if not cfg.is_decoder:
        return out
    max_len = max_len + cfg.num_prefix_embeds
    pre = functools.partial(jtf.prefill, cfg=jcfg, max_len=max_len)
    last, cache = _compiled(pre, params, tokens=toks, **jextra)(
        params, tokens=toks, **jextra)
    out["prefill"], out["cache"] = _numpy(last), _cache_leaves(cache)
    tok = jnp.asarray(tokens[:, seq])
    step = _compiled(functools.partial(jtf.decode_step, cfg=jcfg), params,
                     cache=cache, token=tok)
    out["decode"] = []
    for t in range(STEPS):
        lg, cache = step(params, cache=cache,
                         token=jnp.asarray(tokens[:, seq + t]))
        out["decode"].append(_numpy(lg))
    out["len"] = int(cache["len"])
    out["decode_cache"] = _cache_leaves(cache)
    return out


@functools.lru_cache(maxsize=None)
def _port(arch, dt, seq=S, max_len=MAX_LEN, forward=True):
    """The port's outputs, in ``_ref``'s layout."""
    cfg, _ = _cfgs(arch)
    tdt = DTYPES[dt][0]
    params = lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, _params(arch)), cfg, tdt)
    tokens, extra = _inputs(cfg, 17, seq)
    textra = {k: torch.tensor(v).to(tdt) for k, v in extra.items()}
    toks = (None if "inputs_embeds" in extra
            else torch.tensor(tokens[:, :seq]))
    out = {}
    with torch.inference_mode():
        if forward:
            logits, aux = tf.forward(params, cfg, toks, **textra)
            out["logits"], out["aux"] = logits.float().numpy(), float(aux)
        if not cfg.is_decoder:
            return out
        last, cache = tf.prefill(params, cfg, toks, **textra,
                                 max_len=max_len + cfg.num_prefix_embeds)
        # decode writes the cache in place: read the prefill's leaves first
        out["prefill"], out["cache"] = (last.float().numpy(),
                                        _cache_leaves(cache))
        out["decode"] = []
        for t in range(STEPS):
            lg, cache = tf.decode_step(params, cfg, cache,
                                       torch.tensor(tokens[:, seq + t]))
            out["decode"].append(lg.float().numpy())
        out["len"] = int(cache["len"])
        out["decode_cache"] = _cache_leaves(cache)
    return out


def _scaled_err(ours, ref) -> float:
    return float(np.abs(ours - ref).max()) / max(float(np.abs(ref).max()),
                                                 1.0)


def _check(arch, dt, key):
    """The port's `key` output against the reference's at the dtype's
    rule; leaves of a cache one by one."""
    ours, ref32 = _port(arch, dt)[key], _ref(arch, "f32")[key]
    pairs = (list(zip(ours, ref32)) if isinstance(ours, list)
             else [(ours, ref32)])
    refs16 = (_ref(arch, "bf16")[key] if dt == "bf16" else None)
    for i, (o, r) in enumerate(pairs):
        if isinstance(o, tuple):  # a cache leaf: (path, array)
            assert o[0] == r[0], (o[0], r[0])
            o, r = o[1], r[1]
            r16 = refs16[i][1] if refs16 else None
        else:
            r16 = refs16[i] if isinstance(refs16, list) else refs16
        assert o.shape == r.shape, (key, o.shape, r.shape)
        err = _scaled_err(o, r)
        if dt == "f32":
            assert err <= F32_TOL, (arch, key, i, err)
        else:
            ref_err = _scaled_err(r16, r)
            assert err <= BF16_FACTOR * ref_err, (arch, key, i, err, ref_err)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_forward_matches_reference(arch, dt):
    _check(arch, dt, "logits")
    cfg, _ = _cfgs(arch)
    s = S + (cfg.num_prefix_embeds if cfg.frontend == "vision" else 0)
    assert _port(arch, dt)["logits"].shape == (B, s, cfg.vocab_size)
    ours, ref = _port(arch, dt)["aux"], _ref(arch, dt)["aux"]
    if cfg.num_experts:
        assert ours > 0
        assert abs(ours - ref) <= (1e-5 if dt == "f32" else 2e-2) * ref
    else:
        assert ours == ref == 0.0


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_matches_reference(arch, dt):
    _check(arch, dt, "prefill")
    _check(arch, dt, "cache")


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", DECODERS)
def test_teacher_forced_decode_matches_reference(arch, dt):
    _check(arch, dt, "decode")
    _check(arch, dt, "decode_cache")
    cfg, _ = _cfgs(arch)
    want = S + STEPS + (cfg.num_prefix_embeds or 0)
    assert _port(arch, dt)["len"] == _ref(arch, dt)["len"] == want


def test_ring_cache_wraps_as_the_reference():
    """hymba: 160 prompt tokens against rings of 128 slots (window 16,
    ``ring_size``): the prefill's roll and the decode's wrapped slots."""
    kw = dict(seq=160, max_len=176, forward=False)
    cfg, _ = _cfgs("hymba-1.5b")
    assert tf.ring_size(cfg, False, 176) == 128 < 160
    ours, ref = _port("hymba-1.5b", "f32", **kw), _ref("hymba-1.5b", "f32",
                                                        **kw)
    assert ours["len"] == ref["len"] == 163
    for o, r in [(ours["prefill"], ref["prefill"])] + list(
            zip(ours["decode"], ref["decode"])):
        assert _scaled_err(o, r) <= F32_TOL
    for key in ("cache", "decode_cache"):
        for (po, o), (pr, r) in zip(ours[key], ref[key]):
            assert po == pr and o.shape == r.shape
            assert _scaled_err(o, r) <= F32_TOL, (key, po)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mixtral-8x7b",
                                  "chatglm3-6b"])
def test_float64_run_is_an_oracle_of_the_reference(arch):
    """The same code on float64 params computes in float64
    (``layers.acc_dtype``) and agrees with the reference's f32 forward."""
    cfg, _ = _cfgs(arch)
    params = lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, _params(arch)), cfg,
        torch.float64)
    tokens, extra = _inputs(cfg, 17, S)
    with torch.inference_mode():
        logits, aux = tf.forward(params, cfg, torch.tensor(tokens[:, :S]),
                                 **{k: torch.tensor(v).double()
                                    for k, v in extra.items()})
    assert logits.dtype == torch.float64
    assert _scaled_err(logits.numpy(), _ref(arch, "f32")["logits"]) \
        <= F32_TOL
