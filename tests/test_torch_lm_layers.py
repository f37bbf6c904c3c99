"""Port parity of the LM zoo's layers (``repro_torch.models.{layers,
attention,moe,ssm}``) against the JAX reference's (``repro.models``): the
norms, every MLP kind, RoPE at fractions 1.0 and 0.5, blockwise attention
over the reference's five cases (``tests/test_attention.py``), decode
attention over a ring cache, the ring helpers, the MoE layer (output and
aux loss, with and without capacity drops) and the SSD forward and decode
step. Params come from the reference's inits and are carried through
numpy; inputs come from numpy seeds. f32 within 2e-4 of the reference,
scaled by max(1, max|ref|).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

F32_TOL = 2e-4


def _close(ours, ref, tol=F32_TOL):
    ours = ours.detach().float().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(ours - ref).max()) / scale
    assert err <= tol, err


def _carry(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))


def _jit(fn, **static):
    """The reference's `fn` with its static arguments bound, compiled at
    its first call at XLA's lowest backend optimisation level (one quick
    compile, where op-by-op dispatch costs seconds on the CPU)."""
    jitted, compiled = jax.jit(functools.partial(fn, **static)), []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(
                {"xla_backend_optimization_level": 0}))
        return compiled[0](*args)
    return call


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _cfg(arch, **fields):
    """The reduced config in both packages, with `fields` replaced."""
    return (dataclasses.replace(configs.get_config(arch, reduced=True),
                                **fields),
            dataclasses.replace(jget(arch, reduced=True), **fields))


# ---------------------------------------------------------------------------
# norms, MLPs, RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    d = 48
    jp = jlayers.norm_init(d, kind, jnp.float32)
    rng = np.random.default_rng(1)
    jp = {k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
          for k, v in jp.items()}
    x = 3.0 * _normal(2, 2, 5, d) + 0.5
    ref = jlayers.apply_norm(jp, jnp.asarray(x), kind)
    _close(layers.apply_norm(_carry(jp), torch.tensor(x), kind), ref)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_keeps_bf16(kind):
    p = layers.norm_init(16, kind, torch.bfloat16, "cpu")
    x = torch.tensor(_normal(3, 2, 16)).to(torch.bfloat16)
    jp = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
          for k, v in p.items()}
    ref = jlayers.apply_norm(jp, jnp.asarray(x.float().numpy(), jnp.bfloat16),
                             kind)
    y = layers.apply_norm(p, x, kind)
    assert y.dtype == torch.bfloat16
    _close(y, np.asarray(ref, np.float32), tol=1e-2)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_matches_reference(kind):
    cfg, jcfg = _cfg("qwen2-1.5b", mlp=kind)
    jp = jlayers.mlp_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    x = _normal(4, 2, 7, cfg.d_model)
    ref = _jit(jlayers.apply_mlp, kind=kind)(jp, jnp.asarray(x))
    _close(layers.apply_mlp(_carry(jp), torch.tensor(x), kind), ref)


def test_mlp_init_has_the_reference_leaves():
    for kind in ("swiglu", "gelu"):
        cfg, jcfg = _cfg("qwen2-1.5b", mlp=kind)
        jp = jlayers.mlp_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
        p = layers.mlp_init(torch.Generator().manual_seed(0), cfg,
                            torch.float32, "cpu")
        assert jax.tree_util.tree_map(np.shape, jp) == \
            {k: {kk: tuple(t.shape) for kk, t in v.items()}
             for k, v in p.items()}


@pytest.mark.parametrize("arch,fraction", [("qwen2-1.5b", 1.0),
                                           ("chatglm3-6b", 0.5),
                                           ("hubert-xlarge", 1.0)])
def test_rope_matches_reference(arch, fraction):
    cfg, jcfg = _cfg(arch, rope_fraction=fraction)
    x = _normal(5, 2, 9, cfg.num_heads, cfg.head_dim)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    ref = _jit(jlayers.apply_rope, cfg=jcfg)(jnp.asarray(x),
                                             jnp.asarray(pos))
    _close(layers.apply_rope(torch.tensor(x), torch.tensor(pos), cfg), ref)
    if cfg.rope_style != "none" and fraction < 1:  # the tail stays as is
        y = layers.apply_rope(torch.tensor(x), torch.tensor(pos), cfg)
        rot = cfg.head_dim // 2
        assert torch.equal(y[..., rot:], torch.tensor(x)[..., rot:])


def test_rope_frequencies_match_reference():
    for dim, frac, base in ((128, 1.0, 1e6), (128, 0.5, 1e4), (24, 1.0, 1e4),
                            (80, 0.3, 1e4)):
        ref = jlayers.rope_frequencies(dim, frac, base)
        _close(layers.rope_frequencies(dim, frac, base), ref, tol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
CASES = [
    # hq, hkv, causal, window, sq, sk (tests/test_attention.py)
    (8, 8, True, 0, 64, 64),
    (8, 2, True, 0, 64, 64),  # GQA
    (4, 4, False, 0, 128, 128),  # bidirectional
    (8, 2, True, 16, 128, 128),  # SWA (window-slice path)
    (6, 2, True, 24, 256, 256),  # SWA non-pow2 window
]


@pytest.mark.parametrize("hq,hkv,causal,window,sq,sk", CASES)
def test_blockwise_attention_matches_reference(hq, hkv, causal, window, sq,
                                               sk):
    d = 16
    q = _normal(hq * sq + window, 2, sq, hq, d)
    k = _normal(hq * sq + window + 1, 2, sk, hkv, d)
    v = _normal(hq * sq + window + 2, 2, sk, hkv, d)
    ref = _jit(jattn.multihead_attention, causal=causal, window=window,
               q_block=32, kv_block=32)(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    out = attn.multihead_attention(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), causal=causal,
                                   window=window, q_block=32, kv_block=32)
    _close(out, ref)


@pytest.mark.parametrize("q_offset,softcap,blocks", [
    (0, 0.0, (256, 512)),   # the model's default blocks, halved to fit
    (5, 0.0, (16, 32)),     # a query offset
    (0, 7.5, (16, 16)),     # logit soft-capping
])
def test_attention_blocks_offset_softcap(q_offset, softcap, blocks):
    q = _normal(11, 2, 48, 4, 8)
    k = _normal(12, 2, 96, 2, 8)
    v = _normal(13, 2, 96, 2, 8)
    kw = dict(causal=True, window=0, softcap=softcap, q_offset=q_offset,
              q_block=blocks[0], kv_block=blocks[1])
    ref = _jit(jattn.multihead_attention, **kw)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(attn.multihead_attention(torch.tensor(q), torch.tensor(k),
                                    torch.tensor(v), **kw), ref)


@pytest.mark.parametrize("sc,cur,window", [(16, 40, 12), (16, 9, 0),
                                           (32, 31, 0), (16, 16, 16)])
def test_decode_attention_over_a_ring(sc, cur, window):
    """The ring's slot positions and single-token attention over them."""
    pos_k = tf._ring_positions(sc, torch.tensor(cur, dtype=torch.int32))
    jpos = jtf._ring_positions(sc, jnp.asarray(cur, jnp.int32))
    assert pos_k.tolist() == np.asarray(jpos).tolist()
    q = _normal(21, 2, 1, 6, 16)
    kc = _normal(22, 2, sc, 2, 16)
    vc = _normal(23, 2, sc, 2, 16)
    ref = _jit(jattn.decode_attention_pos, window=window)(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jpos, cur)
    out = attn.decode_attention_pos(torch.tensor(q), torch.tensor(kc),
                                    torch.tensor(vc), pos_k,
                                    torch.tensor(cur), window=window)
    _close(out, ref)


@pytest.mark.parametrize("s,sc", [(10, 16), (16, 16), (40, 16), (37, 8)])
def test_to_ring_matches_reference(s, sc):
    k = _normal(31, 2, s, 3, 4)
    ref = jtf._to_ring(jnp.asarray(k), sc)
    assert np.array_equal(tf._to_ring(torch.tensor(k), sc).numpy(),
                          np.asarray(ref))


def test_repeat_kv_is_jnp_repeat():
    k = _normal(41, 2, 3, 4, 5)
    assert np.array_equal(tf._repeat_kv(torch.tensor(k), 3).numpy(),
                          np.asarray(jnp.repeat(jnp.asarray(k), 3, axis=2)))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,cf", [("mixtral-8x7b", 1.25),
                                     ("mixtral-8x7b", 0.5),  # drops
                                     ("arctic-480b", 8.0)])
def test_moe_matches_reference(arch, cf):
    cfg, jcfg = _cfg(arch, capacity_factor=cf)
    jp = jmoe.moe_init(jax.random.PRNGKey(7), jcfg, jnp.float32)
    x = _normal(8, 2, 24, cfg.d_model)
    ref_y, ref_aux = _jit(jmoe.apply_moe, cfg=jcfg)(jp, jnp.asarray(x))
    y, aux = moe.apply_moe(_carry(jp), torch.tensor(x), cfg)
    _close(y, ref_y)
    assert abs(float(aux) - float(ref_aux)) <= 1e-6 * max(1, float(ref_aux))
    if cf < 1:  # the capacity truly drops choices
        assert moe.capacity(cfg, 24) * cfg.num_experts < 24 * cfg.top_k


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal values lower index first (bf16 router logits do tie)."""
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0], [0.5, 0.5, 0.5, 0.5, 0.5],
                  [4.0, 1.0, 4.0, 4.0, 0.0]], np.float32)
    for k in (1, 2, 3):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        v, i = moe.top_k(torch.tensor(x), k)
        assert i.tolist() == np.asarray(ri).tolist()
        assert v.tolist() == np.asarray(rv).tolist()


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,seq", [("mamba2-370m", 48),
                                      ("hymba-1.5b", 40)])
def test_ssd_forward_matches_reference(arch, seq):
    cfg, jcfg = _cfg(arch)
    jp = jssm.ssm_init(jax.random.PRNGKey(9), jcfg, jnp.float32)
    x = _normal(10, 2, seq, cfg.d_model)
    ref, (rconv, rh) = _jit(jssm.ssd_forward, cfg=jcfg, return_state=True)(
        jp, jnp.asarray(x))
    y, (conv, h) = ssm.ssd_forward(_carry(jp), torch.tensor(x), cfg,
                                   return_state=True)
    _close(y, ref)
    _close(conv, rconv)
    _close(h, rh)


def test_ssd_decode_steps_match_reference():
    """Three recurrent steps from the forward's final state."""
    cfg, jcfg = _cfg("mamba2-370m")
    jp = jssm.ssm_init(jax.random.PRNGKey(11), jcfg, jnp.float32)
    p = _carry(jp)
    x = _normal(12, 2, 19, cfg.d_model)
    _, jstate = _jit(jssm.ssd_forward, cfg=jcfg, return_state=True)(
        jp, jnp.asarray(x[:, :16]))
    _, state = ssm.ssd_forward(p, torch.tensor(x[:, :16]), cfg,
                               return_state=True)
    step = _jit(jssm.ssd_decode_step, cfg=jcfg)
    for t in range(16, 19):
        ref, jstate = step(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        y, state = ssm.ssd_decode_step(p, torch.tensor(x[:, t:t + 1]), state,
                                       cfg)
        _close(y, ref)
        _close(state[1], jstate[1])
        _close(state[0], jstate[0])
