"""The collective side of the DP×TP roofline (counterpart of
``fno_collective_bytes`` in ``repro/roofline/analysis.py``)."""
from __future__ import annotations

import math
from typing import Dict

_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def dtype_bytes(name: str) -> int:
    """Bytes per element of a policy dtype name ("float32", "bfloat16")."""
    return _DTYPE_BYTES[name]


def fno_collective_bytes(cfg, dp: int, tp: int, *, scattered: bool = True,
                         batch: int = 8) -> Dict[str, float]:
    """Per-rank wire bytes of the TP collectives in one sharded FNO forward
    on a ring of tp ranks, as the reference models them.

    Each fused block's sharded hidden contraction leaves every rank a
    partial of the full hidden activation, T = (batch/dp)·hidden·∏spatial
    ·compute bytes. An all-reduce ("psum") moves 2·(tp-1)/tp·T per rank;
    the scattered layout's reduce-scatter moves (tp-1)/tp·T and emits the
    next layer's shard (the ring of ``tp_overlap`` moves the same bytes in
    tp-1 hops). scattered=True: num_layers-1 interior reduce-scatters and
    the last layer's psum; scattered=False: num_layers psums. TP folds
    away (no bytes) where tp <= 1 or hidden % tp != 0, as ``make_context``
    folds it. The lift and projection MLPs' collectives are not counted,
    as the reference does not count them."""
    if tp <= 1 or cfg.hidden % tp != 0:
        return {"interior_per_layer": 0.0, "final": 0.0, "total": 0.0}
    cb = dtype_bytes(cfg.precision.compute_dtype)
    t = (batch / max(dp, 1)) * cfg.hidden * math.prod(cfg.spatial) * cb
    psum = 2.0 * (tp - 1) / tp * t
    interior = ((tp - 1) / tp * t) if scattered else psum
    n_interior = max(cfg.num_layers - 1, 0)
    final = psum if cfg.num_layers > 0 else 0.0
    return {"interior_per_layer": interior, "final": final,
            "total": n_interior * interior + final}
