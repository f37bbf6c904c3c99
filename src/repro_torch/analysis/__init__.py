"""Contract checks of the port (counterpart of ``repro/analysis``), with
one currency, the ``Finding``:

  * ``analysis.launch_lint`` — launch counts of the fused entry points
    (one launch a block forward, four a block forward and backward,
    num_layers a model forward), cast ownership (float casts only between
    the dtypes the ``PrecisionPolicy`` names) and the collective budget of
    a sharded forward, counted by wrapping the kernels' entry points and
    under a ``TorchDispatchMode``: the port's counterpart of the
    reference's jaxpr lints;
  * ``analysis.smem`` — every launch's plan and shared memory against the
    H100's 232,448 B a block, before a launch: the counterpart of the
    reference's VMEM estimator;
  * ``analysis.ast_lint`` — source rules over ``src/repro_torch``.

``python -m repro_torch.launch.lint --all`` runs them all. This module
imports nothing but the standard library.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation (or, at severity="warn", a flagged risk).

    checker: short rule id (e.g. "launch-count", "cast-ownership");
    target: what was checked (an entry point, a file:line, a config id);
    message: the violation, said so that it can be acted on.
    """

    checker: str
    target: str
    message: str
    severity: str = "error"  # "error" fails the lint; "warn" is reported

    def __str__(self) -> str:
        tag = "WARN" if self.severity == "warn" else "FAIL"
        return f"[{tag} {self.checker}] {self.target}: {self.message}"


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == "error"]


def format_findings(findings: Iterable[Finding]) -> str:
    return "\n".join(str(f) for f in findings)
