"""How far bf16 takes hymba-1.5b's forward from exact, in the JAX
reference and in the port, on the same weights: a witness that the port's
bf16 error at full width is the model's rounding, not a fault of the port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_precision_witness.py

On the CPU, at hymba-1.5b's full width and train_4k's 4096 tokens (one
row of the Zipf stream, seed 0), with the depth cut to each of
``LAYERS`` (the first layer global, the rest sliding-window, as the full
model's first two): the reference's ``init_lm(PRNGKey(0))`` of the cut
config, cast to bf16, carried to the port through
``convert.lm_params_from_jax``. Each package runs its ``forward`` on the
bf16 weights at bf16 and on the same weights widened (the reference at
f32, the port at f32 and float64), and prints one JSON line a depth:

  * ``ref_bf16_vs_f32``: the reference's own bf16 error, max |bf16 − f32|
    over max |f32| of the logits;
  * ``port_bf16_vs_f64``: the port's, against its float64 (what
    ``launch/lm_train_smoke.py`` reports on the card at 32 layers);
  * ``port_bf16_vs_ref_f32``: the port's bf16 against the reference's
    f32, the quantity the CPU parity tests hold to 3× ``ref_bf16_vs_f32``;
  * ``port_f32_vs_ref_f32``: the two f32 forwards.

Not a test: a forward at this size takes minutes on the CPU. It needs
about 10 GB of memory at 4 layers.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import transformer as jtf
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import tokens as tokens_mod
from repro_torch.models import transformer as tf

ARCH, SEQ = "hymba-1.5b", 4096
LAYERS = (1, 2, 4)


def _rel(a: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def witness(layers: int) -> dict:
    cut = dict(num_layers=layers, global_layers=(0,))
    cfg = dataclasses.replace(get_config(ARCH), **cut)
    jcfg = dataclasses.replace(jget(ARCH), **cut)
    toks = tokens_mod.token_batch(0, 0, 1, SEQ, cfg.vocab_size)["tokens"]
    t0 = time.perf_counter()
    init = jax.jit(functools.partial(jtf.init_lm, cfg=jcfg,
                                     dtype=jnp.float32))
    jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                  init(jax.random.PRNGKey(0)))
    jfwd = jax.jit(lambda p, t: jtf.forward(p, jcfg, t)[0])
    jt = jnp.asarray(toks.numpy())
    ref = {}
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        p = jax.tree_util.tree_map(lambda a: a.astype(dt), jp16)
        ref[name] = np.asarray(jfwd(p, jt).astype(jnp.float32))
    p16 = lm_params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                               jp16), cfg, torch.bfloat16)
    del jp16
    port = {}
    with torch.no_grad():
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32),
                         ("f64", torch.float64)):
            p = tree.map(lambda t: t.to(dt), p16)
            port[name] = tf.forward(p, cfg, toks)[0][0].double().numpy()
    f64 = port["f64"]
    return {"arch": ARCH, "layers": layers, "seq": SEQ,
            "ref_bf16_vs_f32": _rel(ref["bf16"][0], ref["f32"][0]),
            "port_bf16_vs_f64": _rel(port["bf16"], f64),
            "port_bf16_vs_ref_f32": _rel(port["bf16"], ref["f32"][0]),
            "port_f32_vs_ref_f32": _rel(port["f32"], ref["f32"][0]),
            "ref_f32_vs_port_f64": _rel(ref["f32"][0], f64),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    layers = [int(v) for v in (argv if argv is not None else sys.argv[1:])]
    for n in layers or LAYERS:
        print(json.dumps(witness(n)), flush=True)


if __name__ == "__main__":
    main()
