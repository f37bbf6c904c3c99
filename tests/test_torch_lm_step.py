"""Port parity of the LM zoo's train step and what feeds it, against the
JAX reference's:

  * ``make_train_step`` on an LM config: one step from the reference's
    ``init_lm`` weights at microbatches 1 and 2 (qwen2 reduced, remat on
    in the second), and nemotron-4-340b and arctic-480b reduced with a
    bf16 gradient accumulator and bf16 AdamW state (their knobs in
    ``repro/launch/cells.py``), held to the reference's step by
    ``launch.lm_train_smoke.compare_steps``, the rule phase 37 holds the
    card's step to: ``loss`` and ``grad_norm`` within 2e-4, ``step``
    equal; f32 ``m`` and ``v`` within 2e-4 of each leaf's magnitude, bf16
    ones within 2^-7 of it (a bf16 value is one of 256 steps an octave,
    and the accumulated grad and the moment are each rounded to it);
    updated params within 2e-4 of each leaf's magnitude wherever the grad
    stands above the packages' rounding. Adam's first step moves a param
    by about ±lr·sign(g), so where g is rounding noise — the key bias's
    grad is zero in exact arithmetic, the softmax being shift-invariant —
    the sign is the noise's, and those params are held within 2·lr, the
    most two steps can differ; a multi-rank context raises;
  * ``roofline.analysis.lm_model_flops`` equal to the reference's for the
    ten presets at every shape kind;
  * the token stream: ``zipf_logits`` bit-equal; ``tokens_from_gumbels``
    on ``jax.random.gumbel``'s noise of the batch's key equals the
    reference's ``token_batch`` bit for bit; ``token_batch`` is a pure
    function of (seed, index, shard) with its shards' shapes (the
    reference's ``tests/test_data.py``), and its token frequencies follow
    the Zipf law;
  * the unified train CLI: ``--arch qwen2-1.5b --reduced --device cpu
    --steps 2`` runs, and the default device raises without a card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import tokens as jtokens
from repro.optim import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.roofline.analysis import lm_model_flops as jflops
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import configs, tree
from repro_torch.data import tokens
from repro_torch.distributed import sharding as shd
from repro_torch.launch import lm_train_smoke as smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tcli
from repro_torch.optim import AdamW
from repro_torch.optim.schedule import constant
from repro_torch.roofline.analysis import lm_model_flops
from repro_torch.models import transformer as tf
from repro_torch.train.train_step import make_train_step, value_and_grad

from test_torch_lm_train import (XLA_FAST, lm_batch, one_thread,  # noqa
                                 port_batch, port_params, ref_params)

LR = 1e-3
# (arch, microbatches, remat, grad_acc_dtype and AdamW state dtype)
STEPS = {"qwen2 mb1": ("qwen2-1.5b", 1, False, None),
         "qwen2 mb2 remat": ("qwen2-1.5b", 2, True, None),
         "nemotron mb2 bf16": ("nemotron-4-340b", 2, False, "bfloat16"),
         "arctic mb2 bf16": ("arctic-480b", 2, False, "bfloat16")}


@functools.lru_cache(maxsize=None)
def _ref_step(case):
    arch, mb, remat, acc = STEPS[case]
    jcfg = jget(arch, reduced=True)
    opt = JAdamW(lr=jconstant(LR), state_dtype=acc)
    step = jmake_train_step(jcfg, opt, microbatches=mb, remat=remat,
                            grad_acc_dtype=jnp.dtype(acc) if acc else None)
    params = ref_params(arch)
    state = opt.init(params)
    batch = {k: jnp.asarray(v) for k, v in lm_batch(jcfg, 5, b=4,
                                                    s=16).items()}
    new, st, m = jax.jit(step).lower(params, state, batch).compile(
        XLA_FAST)(params, state, batch)
    f32 = lambda t: np.asarray(jnp.asarray(t, jnp.float32))
    return ([f32(x) for x in jax.tree_util.tree_leaves(new)],
            [f32(x) for x in jax.tree_util.tree_leaves(st["m"])],
            [f32(x) for x in jax.tree_util.tree_leaves(st["v"])],
            {k: float(v) for k, v in m.items()},
            str(jax.tree_util.tree_leaves(st["m"])[0].dtype))


@pytest.mark.parametrize("case", list(STEPS))
def test_train_step_matches_reference(case):
    arch, mb, remat, acc = STEPS[case]
    cfg = configs.get_config(arch, reduced=True)
    opt = AdamW(lr=constant(LR), state_dtype=acc)
    step = make_train_step(cfg, opt, microbatches=mb, remat=remat,
                           grad_acc_dtype=acc)
    params = port_params(arch)
    ours = step(params, opt.init(params),
                port_batch(lm_batch(cfg, 5, b=4, s=16)))
    rp, rm, rv, rmet, rdt = _ref_step(case)
    assert str(tree.leaves(ours[1]["m"])[0].dtype) == f"torch.{rdt}"
    state_dt = getattr(torch, rdt)
    like = lambda t, leaves, dt: tree.unflatten(t, [
        torch.tensor(x).to(dt) for x in leaves])
    ref = (like(params, rp, torch.float32),
           {"m": like(params, rm, state_dt), "v": like(params, rv, state_dt)},
           rmet)
    smoke.compare_steps(ours, ref, lr=LR)
    assert int(ours[2]["step"]) == 1


def test_value_and_grad_zeros_only_the_leaves_named_unread():
    """A leaf the loss does not read raises, as autograd does (the FNO
    path names none); named in `unread` it gets zeros, as ``jax.grad``
    gives it (hubert trains from frame embeddings, its token table
    unread)."""
    params = {"a": torch.ones(3), "b": torch.ones(2)}
    loss_fn = lambda p, batch: (p["a"] * batch).sum()
    with pytest.raises(RuntimeError):
        value_and_grad(loss_fn, params, torch.arange(3.0))
    loss, grads = value_and_grad(loss_fn, params, torch.arange(3.0),
                                 unread=[("b",)])
    assert float(loss) == 3.0
    assert torch.equal(grads["a"], torch.arange(3.0))
    assert torch.equal(grads["b"], torch.zeros(2))
    hubert = configs.get_config("hubert-xlarge", reduced=True)
    assert tf.unread_leaves(hubert, {"inputs_embeds": None}) == (("embed",),)
    qwen = configs.get_config("qwen2-1.5b", reduced=True)
    assert tf.unread_leaves(qwen, {"tokens": None}) == ()


def test_lm_step_refuses_a_multi_rank_context():
    cfg = configs.get_config("qwen2-1.5b", reduced=True)
    ctx = shd.ShardingContext(mesh=tmesh.make_debug_mesh(2, 2),
                              batch_axes=("data",))
    with pytest.raises(NotImplementedError, match="Queue A item 5c"):
        make_train_step(cfg, AdamW(lr=constant(1e-3)), ctx=ctx)


def test_lm_model_flops_match_reference():
    for arch in configs.ARCH_IDS:
        for reduced in (False, True):
            cfg, jcfg = (configs.get_config(arch, reduced=reduced),
                         jget(arch, reduced=reduced))
            for kind in ("train", "prefill", "decode"):
                for seq, batch in ((4096, 256), (32768, 32), (7, 3)):
                    assert lm_model_flops(cfg, kind, seq, batch) == \
                        jflops(jcfg, kind, seq, batch), (arch, kind)


@pytest.mark.parametrize("vocab", [1, 100, 32001, 151936])
def test_zipf_logits_bit_equal(vocab):
    ours, ref = tokens.zipf_logits(vocab), jtokens.zipf_logits(vocab)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("seed,index,shard,shards", [(0, 0, 0, 1),
                                                     (7, 5, 1, 4)])
def test_tokens_from_gumbels_is_the_references_batch(seed, index, shard,
                                                     shards):
    batch, seq, vocab = 8, 16, 100
    b = batch // shards
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), index), shard)
    noise = jax.random.gumbel(key, (b, seq + 1, vocab), jnp.float32)
    ours = tokens.tokens_from_gumbels(
        torch.from_numpy(np.array(noise)),
        torch.from_numpy(tokens.zipf_logits(vocab)))
    ref = jtokens.token_batch(seed, index, batch, seq, vocab, shard=shard,
                              num_shards=shards)
    for k in ("tokens", "labels"):
        assert ours[k].dtype == torch.int32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def test_token_batches_sharded_and_deterministic():
    full = tokens.token_batch(7, 5, batch=8, seq_len=16, vocab=100)
    s0 = tokens.token_batch(7, 5, batch=8, seq_len=16, vocab=100,
                            shard=0, num_shards=4)
    assert s0["tokens"].shape == (2, 16)
    again = tokens.token_batch(7, 5, batch=8, seq_len=16, vocab=100,
                               shard=0, num_shards=4)
    assert torch.equal(s0["tokens"], again["tokens"])
    s1 = tokens.token_batch(7, 5, batch=8, seq_len=16, vocab=100,
                            shard=1, num_shards=4)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    nxt = tokens.token_batch(7, 6, batch=8, seq_len=16, vocab=100)
    assert not torch.equal(full["tokens"], nxt["tokens"])
    assert full["labels"].shape == (8, 16)
    assert full["tokens"].dtype == full["labels"].dtype == torch.int32
    assert int(full["tokens"].min()) >= 0 and int(full["tokens"].max()) < 100
    # labels are the tokens shifted by one
    assert torch.equal(full["tokens"][:, 1:], full["labels"][:, :-1])
    with pytest.raises(ValueError):
        tokens.token_batch(0, 0, batch=6, seq_len=4, vocab=10, num_shards=4)


def test_token_frequencies_follow_the_zipf_law():
    vocab, n = 16, 200_000
    toks = tokens.token_batch(3, 0, batch=1, seq_len=n - 1, vocab=vocab)
    seen = torch.cat([toks["tokens"][0], toks["labels"][0, -1:]])
    freq = torch.bincount(seen.long(), minlength=vocab).double() / n
    p = np.exp(tokens.zipf_logits(vocab).astype(np.float64))
    p /= p.sum()
    # each frequency within 4 binomial standard deviations of its law
    sd = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq.numpy() - p) <= 4 * sd), (freq, p)


def test_cli_trains_an_lm_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --arch qwen2-1.5b --reduced
    --device cpu --steps 2``, run through its ``main``."""
    tcli.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
               "--steps", "2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if " loss " in ln]
    assert len(lines) == 2 and "on cpu" in lines[0]
    assert "done: 2 steps" in out


def test_cli_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    args = tcli.build_parser().parse_args(["--arch", "qwen2-1.5b",
                                           "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.run(args)


def test_smoke_step_check_holds_a_step_and_catches_a_wrong_one():
    """``lm_train_smoke``'s card-against-CPU rule (phase 37): on the CPU
    a reduced preset's step equals itself, remat included, and a step
    whose loss, moment or well-conditioned param is off fails."""
    out = smoke.reduced_check("arctic-480b", torch.device("cpu"))
    assert out["vs_cpu"]["params"] == out["remat"]["grad"] == 0.0
    # the float64 oracle's checks run (hymba: its SSD rule, by layer)
    hcfg = configs.get_config("hymba-1.5b", reduced=True)
    oracle = smoke.oracle_check(hcfg, torch.device("cpu"), tf.init_lm(
        torch.Generator().manual_seed(0), hcfg, torch.float32), 32)
    assert oracle["f32"]["grad_cosine"] > 1 - 1e-9
    assert len(oracle["bf16"]["grad_by_layer"]["error"]) == hcfg.num_layers
    for dt in ("f32", "bf16"):  # every SSD limit stays below the cap
        cut = oracle[dt]["first_layer"]
        assert cut["grad_vs_f64"] <= cut["grad_tol"] <= smoke.SSD_CAP
    cfg = configs.get_config("qwen2-1.5b", reduced=True)
    opt = AdamW(lr=constant(smoke.LR))
    params = port_params("qwen2-1.5b")
    batch = port_batch(lm_batch(cfg, 5, b=4, s=16))
    ref = make_train_step(cfg, opt, microbatches=2)(
        params, opt.init(params), batch)
    smoke.compare_steps(ref, ref)
    p, st, m = ref
    bad_loss = (p, st, dict(m, loss=m["loss"] * (1 + 1e-3)))
    w = p["layers"]["mlp"]["wi"]["w"]
    bad_param = (dict(p, layers=dict(p["layers"], mlp=dict(
        p["layers"]["mlp"], wi={"w": w + 1e-3 * w.abs().max()}))), st, m)
    mw = st["m"]["embed"]
    bad_m = (p, dict(st, m=dict(st["m"], embed=mw * 1.01)), m)
    for bad in (bad_loss, bad_param, bad_m):
        with pytest.raises(AssertionError):
            smoke.compare_steps(bad, ref)
