"""Carry a JAX param tree into the port.

``params_from_jax(tree)`` takes the reference's param pytree with its leaves
already converted to numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``) and returns the same nested dict/list layout with torch tensors,
so the reference and the port compute the same function. The layouts are
identical leaf for leaf: dense weights ``[din, dout]``, spectral weights
``[O, H]`` (or ``[O, H, k…]``), biases ``[dout]``; the LM's layer leaves
are stacked ``[L, …]`` in both (``lm_params_from_jax`` checks them).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_mod


def params_from_jax(tree: Any, device="cpu") -> Any:
    """numpy-leaved param tree -> torch-leaved tree on `device`.

    Leaves keep their float32 values; a bfloat16 leaf (numpy's ml_dtypes
    type) widens to float32 exactly.
    """
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.kind != "f" or arr.dtype.itemsize < 4:
        arr = arr.astype(np.float32)
    return torch.tensor(arr, device=device)  # a copy: JAX buffers are read-only


def lm_params_from_jax(tree: Any, cfg, dtype=torch.float32,
                       device="cpu") -> Any:
    """The reference's LM params (numpy leaves) as the port's tree at
    `dtype` on `device`. Every leaf's key path and shape must be those of
    the port's own ``init_lm(cfg)`` (built on the "meta" device); any
    missing, extra or misshapen leaf raises ValueError."""
    from repro_torch.models.transformer import init_lm

    want = init_lm(None, cfg, dtype, device="meta")
    got = params_from_jax(tree, device)
    shapes = lambda t: dict(zip(tree_mod.paths(t),
                                (tuple(x.shape) for x in tree_mod.leaves(t))))
    w, g = shapes(want), shapes(got)
    bad = [f"{p}: missing" for p in w if p not in g]
    bad += [f"{p}: not in the port's tree" for p in g if p not in w]
    bad += [f"{p}: shape {g[p]}, the port's is {w[p]}" for p in w
            if p in g and g[p] != w[p]]
    if bad:
        raise ValueError(f"{cfg.name}: the carried tree does not match "
                         f"init_lm's: " + "; ".join(bad))
    return tree_mod.map(lambda t: t.to(dtype), got)
