"""Port parity of the two distributed modules no LM placement rule needs
(``repro_torch.distributed.compression`` and ``.pipeline``) against the
JAX reference's.

``compress`` / ``decompress`` equal the reference's bit for bit on the
same f32 input (int8 ``q`` and its scale, rounding half to even, ties
included). The rest runs on one spawn of 4 gloo ranks on this CPU
(``launch.mesh.spawn`` of ``launch.mesh_cases.run_rank`` over a ("pod",)
mesh, each rank 1 thread; every collective waits at most 120 s and the
spawn 240 s, as in ``test_torch_sharding.py``):

  * ``ef_psum`` of each rank's gradient against the sum of the
    reference's per-rank ``decompress(compress(g + r))`` (1e-6 relative),
    the residual against the reference's, and ``tree_ef_psum`` carried
    over 20 sums against the same loop of the reference's functions; the
    reference test's error-feedback convergence (``err_T < err1 / 2``);
  * ``gpipe_forward`` with S = 4 stages and M = 6 microbatches against
    the sequential ``tanh(x @ w_s)`` chain computed by JAX (1e-5), and
    the grads of Σ out·ct against ``jax.grad`` of that chain; M + S − 1
    ring shifts a rank a forward (("p2p", "gpipe") in
    ``sharding.COLLECTIVES``), M + S − 2 more backward, and one psum.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro_torch.distributed import compression as comp
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import mesh_cases as mc

SPAWN_S = 240.0
N = 4                      # ranks
S, M, MB, D = 4, 6, 2, 16  # stages, microbatches, their rows, width
T = 20                     # carried error-feedback sums


def test_compress_is_bit_equal_to_the_reference():
    rng = np.random.default_rng(0)
    cases = [rng.normal(size=(64, 64)).astype(np.float32),
             (rng.normal(size=(300,)) * 1e-3).astype(np.float32),
             np.zeros((5,), np.float32)]
    # exact halves of the scale: round-half-to-even on both sides
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5], np.float32)
    cases.append(ties)
    for g in cases:
        q, scale = comp.compress(torch.from_numpy(g))
        jq, jscale = jcomp.compress(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert scale.numpy().tobytes() == np.asarray(jscale).tobytes()
        deq = comp.decompress(q, scale)
        np.testing.assert_array_equal(
            deq.numpy(), np.asarray(jcomp.decompress(jq, jscale)))


def _ref_ef(g, steps):
    """The reference's functions, rank by rank: the first sum and
    residuals from zero, then the total of `steps` carried sums."""
    deq = [jcomp.decompress(*jcomp.compress(jnp.asarray(r))) for r in g]
    first = np.asarray(sum(deq))
    res1 = [np.asarray(jnp.asarray(r) - d) for r, d in zip(g, deq)]
    res = [jnp.zeros_like(jnp.asarray(r)) for r in g]
    acc = np.zeros_like(first)
    for _ in range(steps):
        parts = []
        for i, r in enumerate(g):
            g32 = jnp.asarray(r) + res[i]
            d = jcomp.decompress(*jcomp.compress(g32))
            res[i] = g32 - d
            parts.append(d)
        acc = acc + np.asarray(sum(parts))
    return first, res1, acc


def _chain(ws, x):
    for s in range(ws.shape[0]):
        x = jnp.tanh(x @ ws[s])
    return x


@functools.lru_cache(maxsize=None)
def _inputs():
    key = jax.random.PRNGKey(0)
    g = np.asarray(jax.random.normal(key, (N, 64, 64)))
    ws = np.asarray(jax.random.normal(key, (S, D, D)) / D ** 0.5)
    x = np.asarray(jax.random.normal(key, (M, MB, D)))
    ct = np.random.default_rng(1).normal(size=(M, MB, D)).astype(np.float32)
    return g, ws, x, ct


@pytest.fixture(scope="module")
def ranks():
    """One spawn: every rank's results of the three cases."""
    g, ws, x, ct = _inputs()
    job = {"mesh": (N,), "axes": ("pod",), "backend": "gloo",
           "device": "cpu",
           "cases": [{"kind": "ef_psum", "axis": "pod", "g": g,
                      "steps": T},
                     {"kind": "gpipe", "axis": "pod", "ws": ws, "x": x},
                     {"kind": "gpipe", "axis": "pod", "ws": ws, "x": x,
                      "ct": ct}]}
    return tmesh.spawn(mc.run_rank, N, job, timeout_s=SPAWN_S)


def _rel(a, b):
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


def test_ef_psum_matches_the_references_per_rank_sum(ranks):
    g = _inputs()[0]
    first, res1, acc = _ref_ef(g, T)
    for r, out in enumerate(ranks):
        ef = out[0]
        assert _rel(ef["summed"], first) <= 1e-6
        np.testing.assert_array_equal(ef["residual"], res1[r])
        assert _rel(ef["acc"], acc) <= 1e-6
        assert ef["collectives"] == {"psum/ef": 1 + T}
    # the reference test's bounds: int8 error, then error feedback
    exact = g.sum(0)
    err1 = _rel(ranks[0][0]["summed"], exact)
    err_t = _rel(ranks[0][0]["acc"] / T, exact)
    assert err1 < 0.05, err1
    assert err_t < err1 / 2, (err1, err_t)


def test_gpipe_matches_the_sequential_chain(ranks):
    _, ws, x, _ = _inputs()
    ref = np.asarray(_chain(jnp.asarray(ws), jnp.asarray(x)))
    for out in ranks:
        fwd = out[1]
        np.testing.assert_allclose(fwd["out"], ref, rtol=1e-5, atol=1e-5)
        assert fwd["collectives"] == {"p2p/gpipe": M + S - 1,
                                      "psum/gpipe": 1}


def test_gpipe_grads_match_jax_grad(ranks):
    _, ws, x, ct = _inputs()
    loss = lambda w, xx: jnp.sum(_chain(w, xx) * ct)
    gw, gx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(ws), jnp.asarray(x))
    gw, gx = np.asarray(gw), np.asarray(gx)
    for r, out in enumerate(ranks):
        res = out[2]
        np.testing.assert_allclose(res["out"], np.asarray(
            _chain(jnp.asarray(ws), jnp.asarray(x))), rtol=1e-5, atol=1e-5)
        # each rank holds its stage's chunk of the stacked weights' grad
        np.testing.assert_allclose(res["ws_grad"][r], gw[r], rtol=1e-5,
                                   atol=1e-5)
        others = np.delete(res["ws_grad"], r, axis=0)
        assert not others.any()
        assert res["collectives"] == {"p2p/gpipe": 2 * (M + S - 1) - 1,
                                      "psum/gpipe": 1}
    # stage 0 reads the microbatches: its rank holds their grad
    np.testing.assert_allclose(ranks[0][2]["x_grad"], gx, rtol=1e-5,
                               atol=1e-5)
    for out in ranks[1:]:
        assert not out[2]["x_grad"].any()
