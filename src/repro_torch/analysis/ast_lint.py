"""Source rules over ``src/repro_torch`` (counterpart of
``repro/analysis/ast_lint.py``, its four rules translated to the port):

  * **foreign-import** — no ``jax``, ``jaxlib`` or ``repro`` (the
    reference; ``repro_torch`` is the port itself): the port stands alone,
    and only the tests import both;
  * **ctypes-home** — ``ctypes.CDLL`` only in ``kernels/build.py``, where
    every library is built from its source and its C signatures declared
    (in place of the reference's ``pallas_call`` through
    ``_compiler_params``);
  * **collective-home** — ``torch.distributed`` collectives only where
    ``COLLECTIVE_HOMES`` says (in place of the reference's shard_map home):
    ``distributed/sharding.py`` counts each in ``COLLECTIVES``;
  * **no-raw-fft** — ``torch.fft`` only in the oracles, the data
    generators and the yardsticks (``FFT_ALLOWED``); the production paths
    run the truncated-DFT kernels;
  * **triton-import** — ``import triton`` never at module level (the
    CPU, which has none, imports every module);
  * **dtype-literal** — in the files under the ``PrecisionPolicy``, float
    dtype literals (``torch.float32`` & co) only in the owners of
    ``DTYPE_SCOPE`` (the reference's cast boundaries) or on a line marked
    ``# lint: allow-dtype`` with its reason.

This module imports nothing but the standard library.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis import Finding

FOREIGN = ("jax", "jaxlib", "repro")
CTYPES_HOME = "kernels/build.py"

# torch.distributed's collectives, and where each may be called (paths
# relative to src/repro_torch), with the reason.
COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_single", "reduce_scatter", "reduce_scatter_tensor",
    "reduce_scatter_single", "all_to_all", "all_to_all_single",
    "broadcast", "reduce", "gather", "scatter", "send", "recv", "isend",
    "irecv", "batch_isend_irecv", "barrier", "all_gather_object",
    "broadcast_object_list"})
COLLECTIVE_HOMES: Dict[str, Tuple[str, ...]] = {
    # Every collective of the model and the train step, counted by (kind,
    # site) in COLLECTIVES.
    "distributed/sharding.py": tuple(sorted(COLLECTIVES)),
    # The mesh's own set-up: process groups and their teardown.
    "launch/mesh.py": tuple(sorted(COLLECTIVES)),
    # Ranks wait for rank 0's checkpoint write: a barrier, no data.
    "checkpoint/checkpointer.py": ("barrier",),
}

# Where torch.fft may appear, and why.
FFT_ALLOWED: Dict[str, str] = {
    "kernels/ref.py": "the torch.fft oracle the kernels are tested against",
    "data/pde.py": "the PDE data generators (spectral solvers)",
    "launch/row_groups.py": "the one-call torch.fft yardstick timed beside "
                            "the row kernels",
}

# Files under the PrecisionPolicy, with the owners (functions, or
# "<module>") allowed to hold float dtype literals: the reference's cast
# boundaries (its DTYPE_SCOPE) in the port's names.
DTYPE_SCOPE: Dict[str, Tuple[str, ...]] = {
    "kernels/engine.py": ("<module>",),        # _F32 accumulator default
    "kernels/cgemm.py": ("<module>",),         # _F32 accumulator default
    "kernels/dft.py": ("<module>",),           # _F32 accumulator default
    "kernels/ops.py": ("<module>",),           # _F32: the oracle and the
                                               # block tail's f32 epilogue
    "core/fno.py": ("_dense_init",             # f32 master-param init
                    "relative_l2"),            # f32 metric reduction
    "core/spectral_conv.py": ("init_spectral_nd",),
    "train/train_step.py": ("make_train_step",  # f32 grad-acc fallback
                            "train_step",
                            "_local_grads"),    # f32 loss accumulator
}
DTYPE_ATTRS = frozenset({"float32", "float64", "float16", "bfloat16"})
DTYPE_PRAGMA = "lint: allow-dtype"


def repo_src_root() -> Path:
    """``src/repro_torch``."""
    return Path(__file__).resolve().parents[1]


def _dotted(node) -> str:
    """"a.b.c" of a Name / Attribute chain, "" otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, lines: Sequence[str]):
        self.rel = rel
        self.lines = lines
        self.owners = ["<module>"]
        self.dist_names = {"torch.distributed"}  # names bound to it
        self.findings: List[Finding] = []

    def _add(self, checker, node, msg):
        self.findings.append(Finding(checker, f"{self.rel}:{node.lineno}",
                                     msg))

    # -- owners ----------------------------------------------------------
    def visit_FunctionDef(self, node):
        self.owners.append(node.name)
        self.generic_visit(node)
        self.owners.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- imports ---------------------------------------------------------
    def _check_module(self, node, mod: str):
        top = mod.split(".")[0]
        if top in FOREIGN:
            self._add("foreign-import", node,
                      f"imports {mod!r}: the port imports neither jax nor "
                      f"the reference package; only the tests import both")
        if top == "triton" and self.owners[-1] == "<module>":
            self._add("triton-import", node,
                      "imports triton at module level: import it inside "
                      "the function that launches the kernel (the CPU has "
                      "no triton and imports every module)")
        if (mod == "torch.fft" or mod.startswith("torch.fft.")) \
                and self.rel not in FFT_ALLOWED:
            self._add("no-raw-fft", node, _FFT_MSG)

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self._check_module(node, a.name)
            if a.name == "torch.distributed" and a.asname:
                self.dist_names.add(a.asname)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        mod = node.module or ""
        if node.level == 0:
            self._check_module(node, mod)
        names = [a.name for a in node.names]
        if mod == "torch" and "fft" in names and self.rel not in FFT_ALLOWED:
            self._add("no-raw-fft", node, _FFT_MSG)
        if mod == "torch" and "distributed" in names:
            self.dist_names.add(next(a.asname or a.name for a in node.names
                                     if a.name == "distributed"))
        if mod == "torch.distributed":
            for a in node.names:
                self._collective(node, a.name)
        if mod == "ctypes" and "CDLL" in names and self.rel != CTYPES_HOME:
            self._add("ctypes-home", node, _CDLL_MSG)
        self.generic_visit(node)

    # -- calls and attributes ---------------------------------------------
    def _collective(self, node, name: str):
        if name in COLLECTIVES and name not in COLLECTIVE_HOMES.get(
                self.rel, ()):
            self._add("collective-home", node,
                      f"torch.distributed.{name} outside its homes "
                      f"({sorted(COLLECTIVE_HOMES)}): issue collectives "
                      f"through distributed/sharding.py, which counts "
                      f"them in COLLECTIVES")

    def visit_Attribute(self, node: ast.Attribute):
        base = _dotted(node.value)
        if base in self.dist_names:
            self._collective(node, node.attr)
        if node.attr == "CDLL" and base == "ctypes" \
                and self.rel != CTYPES_HOME:
            self._add("ctypes-home", node, _CDLL_MSG)
        if node.attr == "fft" and base == "torch" \
                and self.rel not in FFT_ALLOWED:
            self._add("no-raw-fft", node, _FFT_MSG)
        if (node.attr in DTYPE_ATTRS and base in ("torch", "np", "numpy")
                and self.rel in DTYPE_SCOPE
                and self.owners[-1] not in DTYPE_SCOPE[self.rel]
                and DTYPE_PRAGMA not in self.lines[node.lineno - 1]):
            self._add("dtype-literal", node,
                      f"dtype literal {base}.{node.attr} outside the cast "
                      f"boundaries of {self.rel} (owner "
                      f"{self.owners[-1]!r}): take the dtype from the "
                      f"PrecisionPolicy, or mark a boundary with "
                      f"'# {DTYPE_PRAGMA}' and its reason")
        self.generic_visit(node)


_FFT_MSG = ("torch.fft on a production path: the kernels run the "
            "truncated-DFT formulation; torch.fft belongs to the oracle, "
            f"the data generators and the yardsticks ({sorted(FFT_ALLOWED)})")
_CDLL_MSG = (f"ctypes.CDLL outside {CTYPES_HOME}: load a kernel library "
             f"through its build and loader there")


def lint_file(path: Path, root: Optional[Path] = None) -> List[Finding]:
    root = root or repo_src_root()
    rel = path.resolve().relative_to(root.resolve()).as_posix()
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [Finding("ast-parse", f"{rel}:{e.lineno}",
                        f"file does not parse: {e.msg}")]
    v = _Visitor(rel, src.splitlines())
    v.visit(tree)
    return v.findings


def run_ast_lints(root: Optional[Path] = None,
                  files: Optional[Iterable[Path]] = None) -> List[Finding]:
    """Lint every .py file under `root` (default: src/repro_torch)."""
    root = root or repo_src_root()
    if files is None:
        files = sorted(p for p in root.rglob("*.py")
                       if "__pycache__" not in p.parts)
    findings: List[Finding] = []
    for path in files:
        findings += lint_file(path, root)
    return findings
