"""Port parity of the LM zoo's loss and its gradients
(``repro_torch.models.transformer.lm_loss``, ``forward(remat=)``) against
the JAX reference's, for every one of the ten archs, reduced, batch 2 of
32 tokens (hubert from frame embeddings, internvl2 behind its prefix
embeddings, whose positions carry no loss; a few labels -1, ignored).

Weights are the reference's ``init_lm(PRNGKey(0), cfg, jnp.float32)``
carried through numpy and ``convert.lm_params_from_jax``; the batch comes
from a numpy seed. f32: the loss within 2e-4 and every leaf's grad within
2e-4 of that leaf's own magnitude (max |g|) against
``jax.value_and_grad`` of the reference's ``lm_loss``. bf16 (the same
weights cast by each package): the port's error against the reference's
f32 at most 3× the reference's own bf16 error, the rule of
``test_torch_lm_model.py``, plus a floor of ``BF16_FLOOR`` of the leaf's
magnitude for a leaf the reference's bf16 happens to hit nearly exactly.
Per-layer remat (``torch.utils.checkpoint``) changes no bit of the loss
or of any grad on the CPU. The token lookup's backward sums a bf16
table's rows at f32 and rounds once (a frequent row within 2^-8 of the
float64 sum).
"""
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
from repro_torch.train.train_step import make_loss_fn, value_and_grad

F32_TOL = 2e-4
BF16_FACTOR = 3.0
BF16_FLOOR = 2e-3
B, S = 2, 32
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# The reference's programs compile at XLA's lowest backend optimisation
# level: the same HLO in about half the compile time on the CPU.
XLA_FAST = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True)
def one_thread():
    """The port's ops at these sizes on one intra-op thread: beside the
    suite's other workers, a pool of one thread a core oversubscribes the
    cores and a reduced step runs 20–200× longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(XLA_FAST)


def lm_batch(cfg, seed, b=B, s=S):
    """A numpy batch: tokens (or hubert's frame embeddings), labels with
    every seventh one -1, internvl2's prefix embeddings."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels.reshape(-1)[::7] = -1
    batch = {"labels": labels}
    if cfg.frontend == "audio":
        batch["inputs_embeds"] = rng.normal(
            size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = rng.normal(
            size=(b, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    init = functools.partial(jtf.init_lm, cfg=jget(arch, reduced=True),
                             dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    return _compiled(init, key)(key)


def port_params(arch, dtype=torch.float32):
    return lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, ref_params(arch)),
        configs.get_config(arch, reduced=True), dtype)


def port_batch(batch, dtype=torch.float32):
    """The numpy batch as tensors, embeddings at `dtype`."""
    return {k: (torch.tensor(v) if v.dtype.kind == "i"
                else torch.tensor(v).to(dtype)) for k, v in batch.items()}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _refs(arch):
    """The reference's loss and grads (numpy leaves in tree order) at f32
    and at bf16, from one compiled program."""
    jcfg = jget(arch, reduced=True)
    grad = jax.value_and_grad(lambda p, b: jtf.lm_loss(p, jcfg, b))

    def both(params, batch):
        out = {}
        for dt, (_, jdt) in DTYPES.items():
            cast = lambda a: a.astype(jdt) if a.dtype.kind == "f" else a
            out[dt] = grad(jax.tree_util.tree_map(cast, params),
                           {k: cast(v) for k, v in batch.items()})
        return out

    params = ref_params(arch)
    batch = {k: jnp.asarray(v) for k, v in lm_batch(jcfg, 11).items()}
    out = _compiled(both, params, batch)(params, batch)
    return {dt: (float(loss), [_np(g) for g in
                               jax.tree_util.tree_leaves(grads)])
            for dt, (loss, grads) in out.items()}


def _ref(arch, dt):
    return _refs(arch)[dt]


@functools.lru_cache(maxsize=None)
def _port(arch, dt, remat=False):
    cfg = configs.get_config(arch, reduced=True)
    tdt = DTYPES[dt][0]
    batch = port_batch(lm_batch(cfg, 11), tdt)
    return value_and_grad(make_loss_fn(cfg, remat=remat),
                          port_params(arch, tdt), batch,
                          tf.unread_leaves(cfg, batch))


def _leaf_err(ours, ref):
    return float(np.abs(ours - ref).max()) / max(float(np.abs(ref).max()),
                                                 1e-30)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_loss_and_grads_match_reference(arch, dt):
    loss, grads = _port(arch, dt)
    ref_loss, ref_grads = _ref(arch, "f32")
    paths = tree.paths(grads)
    grads = [g.float().numpy() for g in tree.leaves(grads)]
    assert len(grads) == len(ref_grads)
    if dt == "f32":
        assert abs(float(loss) - ref_loss) <= F32_TOL * max(abs(ref_loss), 1)
        for p, g, r in zip(paths, grads, ref_grads):
            assert g.shape == r.shape, p
            assert _leaf_err(g, r) <= F32_TOL, (p, _leaf_err(g, r))
        return
    ref16_loss, ref16 = _ref(arch, "bf16")
    assert abs(float(loss) - ref_loss) <= BF16_FACTOR * abs(
        ref16_loss - ref_loss) + BF16_FLOOR * abs(ref_loss), (
        float(loss), ref16_loss, ref_loss)
    for p, g, r, r16 in zip(paths, grads, ref_grads, ref16):
        own = _leaf_err(r16, r)
        assert _leaf_err(g, r) <= BF16_FACTOR * own + BF16_FLOOR, (
            p, _leaf_err(g, r), own)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_remat_changes_no_bit(arch):
    """Remat's recompute is the same code on the same inputs: on the CPU
    (MoE's accumulating index write runs in order there) the loss and
    every grad are bit-equal with and without it."""
    loss, grads = _port(arch, "f32")
    loss_r, grads_r = _port(arch, "f32", remat=True)
    assert torch.equal(loss, loss_r)
    for p, a, b in zip(tree.paths(grads), tree.leaves(grads),
                       tree.leaves(grads_r)):
        assert torch.equal(a, b), p


def test_loss_skips_prefix_positions_and_ignored_labels():
    """internvl2: the loss reads the positions after the prefix alone;
    ignored labels (-1) carry no loss, and a batch whose labels are all
    ignored has loss equal to the aux term (the count's floor of 1)."""
    cfg = configs.get_config("internvl2-26b", reduced=True)
    params = port_params("internvl2-26b")
    batch = port_batch(lm_batch(cfg, 3))
    with torch.no_grad():
        logits, aux = tf.forward(params, cfg, batch["tokens"],
                                 prefix_embeds=batch["prefix_embeds"])
        assert logits.shape[1] == S + cfg.num_prefix_embeds
        lg = logits[:, cfg.num_prefix_embeds:]
        lab = batch["labels"]
        mask = lab >= 0
        nll = (torch.logsumexp(lg, -1) - torch.gather(
            lg, -1, lab.clamp(min=0).long()[..., None])[..., 0])
        want = (nll * mask).sum() / mask.sum() + 0.01 * aux
        got = tf.lm_loss(params, cfg, batch)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        none = dict(batch, labels=torch.full_like(lab, -1))
        assert float(tf.lm_loss(params, cfg, none)) == float(0.01 * aux)


def test_embedding_grad_sums_a_frequent_row_once_rounded():
    """The lookup's backward sums each row's grads at f32 and rounds once:
    a bf16 row read 600 times of 4096 (a Zipf head token) gets its grad
    within 2^-8 of the float64 sum, where adding the rows in bf16 (the
    index's own backward on the CPU) lands 5e-2 off."""
    gen = torch.Generator().manual_seed(0)
    vocab, d, n = 50, 64, 4096
    idx = torch.randint(1, vocab, (1, n), generator=gen)
    idx[0, :600] = 0
    table = torch.randn(vocab, d, generator=gen)
    g = torch.randn(1, n, d, generator=gen).bfloat16()
    exact = torch.zeros(vocab, d, dtype=torch.float64).index_add_(
        0, idx[0], g[0].double())
    scale = float(exact.abs().max())
    grads = {}
    for name, fn in (("lookup", lambda t: tf._Lookup.apply(t, idx)),
                     ("index", lambda t: t[idx])):
        t = table.bfloat16().requires_grad_(True)
        fn(t).backward(g)
        grads[name] = float((t.grad.double() - exact).abs().max()) / scale
    assert grads["lookup"] <= 2.0 ** -8, grads
    assert grads["index"] > 10 * grads["lookup"], grads
