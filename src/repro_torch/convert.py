"""Carry a JAX FNO param tree into the port.

``params_from_jax(tree)`` takes the reference's param pytree with its leaves
already converted to numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``) and returns the same nested dict/list layout with torch tensors,
so the reference and the port compute the same function. The layouts are
identical leaf for leaf: dense weights ``[din, dout]``, spectral weights
``[O, H]`` (or ``[O, H, k…]``), biases ``[dout]``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


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
