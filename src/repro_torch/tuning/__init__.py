"""The port's launch plans, tuned on the card (counterpart of
``repro/tuning``).

The kernels take their plans from Python (the block and wgrad kernels'
cluster, chain and chunk sizes; the core's, from its library). This
package owns that choice:

* ``plans``    — the key schema (the reference's six segments and a batch
  bucket) and the override's fields;
* ``resolve``  — ``resolve_plan``: override → fresh tuned entry → the rule
  planner, field by field;
* ``store``    — the committed cache (``tuning/cache/plans.json``) and its
  staleness check (``check_tuning_cache``);
* ``autotune`` — generate → prune → measure on the card → persist
  (``python -m repro_torch.launch.autotune``).
"""
from repro_torch.tuning.plans import (LAUNCH_KINDS, normalize_override,
                                      plan_key, shape_class, workload_key)
from repro_torch.tuning.resolve import Resolved, resolve_plan
from repro_torch.tuning.store import (DEFAULT_CACHE_PATH, check_tuning_cache,
                                      load_cache, save_cache)

__all__ = ["LAUNCH_KINDS", "normalize_override", "plan_key", "shape_class",
           "workload_key", "Resolved", "resolve_plan",
           "DEFAULT_CACHE_PATH", "check_tuning_cache", "load_cache",
           "save_cache"]
