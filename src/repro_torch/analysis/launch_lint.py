"""Launch counts, cast ownership and the collective budget of the port's
entry points (counterpart of ``repro/analysis/jaxpr_lint.py``'s three
checkers and drivers).

  * **launch-count** — the fusion contract: one ``block_fwd`` a block
    forward, four (``block_fwd``, ``gz_recompute``, ``dx_adjoint``,
    ``wgrad``) a block forward and backward, ``num_layers`` a model
    forward or serve step; rdft + core + irdft a layer under
    ``variant="partial"`` (rank 1: the bare layer); one a layer
    spectral-only, plus two backward; ``2 block_ends + (L−2) block_fwd``
    with ``fuse_ends``; K × a step for a K-step rollout. Launches are
    counted by wrapping the kernels' entry points (``counted_calls``): on
    the CPU the plain versions run and ``engine.LAUNCHES`` counts nothing,
    and a call is a launch on the card. A graphed server's replays pass
    through no wrapper, so its steps are read from ``engine.LAUNCHES``.
  * **cast-ownership** — every float→float dtype conversion a forward and
    its ``torch.autograd.grad`` dispatch (``aten._to_copy`` /
    ``aten.copy_`` across dtypes, recorded under a ``TorchDispatchMode``)
    moves between the dtypes the ``PrecisionPolicy`` names (with f32):
    none under the f32 preset, only f32↔bf16 under bf16.
  * **collective-budget** — a pure function of a recorded
    ``sharding.COLLECTIVES`` counter (one sharded forward) and the config,
    per site: the scattered TP layout ``num_layers − 1`` reduce-scatters
    and one psum ("block"; a ring of tp − 1 hops a reduce-scatter with
    ``tp_overlap``), the psum layout one psum a layer, pure DP none; the
    lift one reduce-scatter and the projection one psum under TP.

The drivers run at the reference's reduced shapes (``jaxpr_lint.py:184``)
on the CPU, or a config at full width on the card.
``fused_block_contract`` and ``serve_step_contract`` are the thin wrappers
(the serve CLI's fusion contract calls the latter).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import Finding
from repro_torch.configs.base import PrecisionPolicy, torch_dtype

DTYPES = ("f32", "bf16")
LAYOUTS = ("shared", "per_mode")
VARIANTS = ("full", "partial")
BACKWARD = ("gz_recompute", "dx_adjoint", "wgrad")
PARTIAL = ("rdft", "core", "irdft")

_SPATIAL = {1: (16,), 2: (8, 8), 3: (8, 6, 6)}
_MODES = {1: (5,), 2: (3, 4), 3: (2, 3, 2)}


# ---------------------------------------------------------------------------
# Counting launches off the card
# ---------------------------------------------------------------------------
def _entry_points():
    """(module, name, kind of a call) of every kernel entry point, the
    kind as ``engine.launch_kind`` names it."""
    from repro_torch.kernels import dft, engine
    return [(engine, "fused_block", lambda a, kw: engine.launch_kind(
                a[3], kw.get("act", "gelu"), kw.get("adjoint", False),
                kw.get("lift") is not None or kw.get("proj") is not None)),
            (engine, "fused_wgrad", lambda a, kw: (
                "wgrad" if kw.get("with_bypass", True)
                else "spectral_wgrad")),
            (engine, "fused_core", lambda a, kw: "core"),
            (dft, "rdft", lambda a, kw: "rdft"),
            (dft, "irdft", lambda a, kw: "irdft"),
            (dft, "outer_rdft", lambda a, kw: "rdft"),
            (dft, "outer_irdft", lambda a, kw: "irdft")]


@contextlib.contextmanager
def counted_calls(record: Optional[list] = None):
    """Within the block every call of a kernel entry point adds its kind
    to the yielded Counter (and, with `record`, appends (kind, its
    ``plan=`` override)); the entry points are restored after."""
    calls: collections.Counter = collections.Counter()
    saved = []
    for mod, name, kind in _entry_points():
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapped(*a, _fn=fn, _kind=kind, **kw):
            k = _kind(a, kw)
            calls[k] += 1
            if record is not None:
                record.append((k, kw.get("plan")))
            return _fn(*a, **kw)
        setattr(mod, name, wrapped)
    try:
        yield calls
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def launch_counts(fn: Callable, *args, record: Optional[list] = None,
                  **kwargs) -> Dict[str, int]:
    """{kind: calls} of the kernel entry points while fn runs (`record` as
    ``counted_calls``')."""
    with counted_calls(record) as calls:
        fn(*args, **kwargs)
    return dict(calls)


def check_launch_count(fn: Callable, args: Sequence, want: Dict[str, int],
                       *, target: str, kwargs: Optional[dict] = None,
                       record: Optional[list] = None) -> List[Finding]:
    got = launch_counts(fn, *args, record=record, **(kwargs or {}))
    return _compare_launches(got, want, target)


def _compare_launches(got, want, target) -> List[Finding]:
    got = {k: v for k, v in got.items() if v}
    want = {k: v for k, v in want.items() if v}
    if got == want:
        return []
    return [Finding(
        "launch-count", target,
        f"launched {dict(sorted(got.items()))}, want exactly "
        f"{dict(sorted(want.items()))}: the fusion contract (one launch a "
        f"block forward, four a forward and backward, num_layers a model "
        f"forward) is broken")]


# ---------------------------------------------------------------------------
# Cast ownership
# ---------------------------------------------------------------------------
_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


class _CastRecorder(TorchDispatchMode):
    """Records (src, dst) dtype names of every float→float conversion
    dispatched: ``aten._to_copy`` and ``aten.copy_`` across dtypes."""

    def __init__(self):
        super().__init__()
        self.casts: List[Tuple[str, str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pair = None
        if func is torch.ops.aten._to_copy.default:
            pair = (args[0].dtype, out.dtype)
        elif func is torch.ops.aten.copy_.default:
            pair = (args[1].dtype, args[0].dtype)
        if pair and pair[0] != pair[1] and all(d in _FLOATS for d in pair):
            self.casts.append(tuple(str(d).removeprefix("torch.")
                                    for d in pair))
        return out


def float_casts(fn: Callable, *args, **kwargs) -> List[Tuple[str, str]]:
    """The float→float (src, dst) dtype names fn's dispatched ops
    convert."""
    rec = _CastRecorder()
    with rec:
        fn(*args, **kwargs)
    return rec.casts


def allowed_casts(policy: PrecisionPolicy) -> frozenset:
    """The float↔float pairs a policy owns: any move between the dtypes it
    names, and f32 (master weights, the loss). f32: none; bf16: f32↔bf16."""
    ds = {policy.param_dtype, policy.compute_dtype, policy.spectral_dtype,
          policy.accum_dtype, policy.grad_acc_dtype, "float32"}
    return frozenset((a, b) for a in ds for b in ds if a != b)


def check_cast_ownership(fn: Callable, args: Sequence,
                         policy: PrecisionPolicy, *, target: str,
                         kwargs: Optional[dict] = None) -> List[Finding]:
    allowed = allowed_casts(policy)
    bad = [c for c in float_casts(fn, *args, **(kwargs or {}))
           if c not in allowed]
    if not bad:
        return []
    shown = ", ".join(f"{s}->{d}" for s, d in sorted(set(bad)))
    return [Finding(
        "cast-ownership", target,
        f"{len(bad)} float cast(s) outside the PrecisionPolicy's dtypes: "
        f"{shown} (the policy allows "
        f"{sorted(set(a for a, _ in allowed)) or ['no float casts']})")]


# ---------------------------------------------------------------------------
# The collective budget
# ---------------------------------------------------------------------------
def collective_budget(cfg, tp: int, *, dp: int = 1,
                      fno_strategy: Optional[str] = None
                      ) -> Dict[Tuple[str, str], int]:
    """{(kind, site): n} of one sharded forward of `cfg` on a dp×tp mesh,
    as ``sharding.COLLECTIVES`` counts them (TP folds away as
    ``make_context`` folds it)."""
    L = cfg.num_layers
    if (fno_strategy or "auto") == "dp" or tp <= 1 or cfg.hidden % tp:
        return {}
    if cfg.tp_layout == "scatter" and cfg.hidden % tp == 0:
        if cfg.tp_overlap:
            want = {("p2p", "block"): (tp - 1) * (L - 1)}
        else:
            want = {("reduce_scatter", "block"): L - 1}
        want[("psum", "block")] = 1
    else:
        want = {("psum", "block"): L}
    if (cfg.lifting_dim or 2 * cfg.hidden) % tp == 0:
        want[("reduce_scatter", "lift")] = 1
    want[("psum", "proj")] = 1
    return {k: v for k, v in want.items() if v}


def check_collective_budget(counts, cfg, *, tp: int, dp: int = 1,
                            target: str,
                            fno_strategy: Optional[str] = None
                            ) -> List[Finding]:
    """Hold a recorded counter of one sharded forward ({(kind, site): n},
    or "kind/site" keys as the mesh's cases report them) to
    ``collective_budget``."""
    got = {}
    for k, n in dict(counts).items():
        key = tuple(k.split("/")) if isinstance(k, str) else tuple(k)
        if n:
            got[key] = got.get(key, 0) + n
    want = collective_budget(cfg, tp, dp=dp, fno_strategy=fno_strategy)
    findings = []
    for key in sorted(set(got) | set(want)):
        g, w = got.get(key, 0), want.get(key, 0)
        if g == w:
            continue
        what = ("unexpected collective" if key not in want
                else f"want exactly {w}")
        findings.append(Finding(
            "collective-budget", f"{target} {key[0]}@{key[1]}",
            f"issued {g}, {what} (dp{dp}×tp{tp}, tp_layout="
            f"{cfg.tp_layout!r}, {cfg.num_layers} layers: scattered, L−1 "
            f"reduce-scatters and one psum; psum, one a layer; pure DP, "
            f"none)"))
    return findings


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------
def _policy(dtype: str) -> PrecisionPolicy:
    return PrecisionPolicy.from_name(dtype)


def block_args(rank: int, layout: str, dtype: str):
    """(x, wr, wi, wb, bias) for one block at the reference's reduced
    shapes (hidden 4) and boundary dtypes: x at the compute dtype, the
    weights at the param dtype (master weights)."""
    pol = _policy(dtype)
    cp, pp = torch_dtype(pol.compute_dtype), torch_dtype(pol.param_dtype)
    h, spatial, modes = 4, _SPATIAL[rank], _MODES[rank]
    g = torch.Generator().manual_seed(0)
    mk = lambda s, dt, sc=1.0: (sc * torch.randn(s, generator=g)).to(dt)
    wshape = (h, h) + (modes if layout == "per_mode" else ())
    return (mk((2, h) + spatial, cp), mk(wshape, pp, 1 / h),
            mk(wshape, pp, 1 / h), mk((h, h), pp, 1 / h), mk((h,), pp, 0.1))


def expected_block_launches(rank: int, variant: str, spectral: bool = False
                            ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """({kind: n} forward, forward and backward) of one block (spectral:
    the bare layer, ``fuse_block`` off)."""
    if variant == "full":
        fwd = {"spectral_fwd" if spectral else "block_fwd": 1}
    elif rank == 1:
        fwd = {"spectral_fwd": 1}
    else:
        fwd = dict.fromkeys(PARTIAL, 1)
    back = (("spectral_dx", "spectral_wgrad") if spectral else BACKWARD)
    return fwd, {**fwd, **dict.fromkeys(back, 1)}


def _grad_fn(f: Callable):
    """fn(*leaves) -> the grads of sum(f(*leaves)²) over every leaf."""
    def run(*leaves):
        xs = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            y = f(*xs)
            return torch.autograd.grad((y.float() ** 2).sum(), xs)
    return run


def lint_block_matrix(ranks: Sequence[int] = (1, 2, 3),
                      layouts: Sequence[str] = LAYOUTS,
                      variants: Sequence[str] = VARIANTS,
                      dtypes: Sequence[str] = DTYPES,
                      spectral: Sequence[bool] = (False, True)
                      ) -> List[Finding]:
    """Forward and grad of ``ops.fno_block_nd`` (and, spectral=True, of
    ``ops.spectral_layer_nd``) on the fused path across the single-device
    matrix: launch counts and cast ownership."""
    from repro_torch.kernels import ops

    findings: List[Finding] = []
    for rank, layout, variant, dtype, bare in itertools.product(
            ranks, layouts, variants, dtypes, spectral):
        name = "spectral_layer_nd" if bare else "fno_block_nd"
        target = f"{name} r{rank}/{layout}/{variant}/{dtype}"
        pol, modes = _policy(dtype), _MODES[rank]
        args = block_args(rank, layout, dtype)
        if bare:
            args = args[:3]
            fwd = lambda *a: ops.spectral_layer_nd(  # noqa: E731
                *a, modes, path="fused", variant=variant, policy=pol)
        else:
            fwd = lambda *a: ops.fno_block_nd(  # noqa: E731
                *a, modes, path="fused", variant=variant, policy=pol)
        want_fwd, want_grad = expected_block_launches(rank, variant, bare)
        findings += check_launch_count(fwd, args, want_fwd,
                                       target=f"{target} fwd")
        findings += check_launch_count(_grad_fn(fwd), args, want_grad,
                                       target=f"{target} grad")
        findings += check_cast_ownership(fwd, args, pol,
                                         target=f"{target} fwd")
        findings += check_cast_ownership(_grad_fn(fwd), args, pol,
                                         target=f"{target} grad")
    return findings


def model_cfg(arch: str, dtype: str, *, reduced: bool = True,
              fuse_block: bool = True, fuse_ends: bool = False):
    """The fused-path config a model lint runs."""
    from repro_torch.configs import get_config, with_precision
    cfg = with_precision(get_config(arch, reduced=reduced), dtype)
    return dataclasses.replace(cfg, path="fused", fuse_block=fuse_block,
                               fuse_ends=fuse_ends)


def expected_model_launches(cfg, variant: str = "full"
                            ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """({kind: n} a forward, a forward and backward) of a fused model."""
    L = cfg.num_layers
    if cfg.fuse_block and cfg.fuse_ends and variant == "full":
        ends = min(L, 2)
        fwd = {"block_ends": ends, "block_fwd": L - ends}
        # The end blocks' backward is staged PyTorch: no launch.
        return fwd, {**fwd, **dict.fromkeys(BACKWARD, L - ends)}
    one_fwd, one_grad = expected_block_launches(cfg.ndim, variant,
                                                not cfg.fuse_block)
    return ({k: L * n for k, n in one_fwd.items()},
            {k: L * n for k, n in one_grad.items()})


def _model_params(cfg, device):
    from repro_torch.core import fno as fno_mod
    return fno_mod.init_fno(torch.Generator().manual_seed(0), cfg,
                            device=device)


def lint_model(archs: Sequence[str] = ("fno1d", "fno2d", "fno3d"),
               dtypes: Sequence[str] = DTYPES, *,
               designs: Sequence[str] = ("block", "partial", "spectral",
                                         "ends"),
               reduced: bool = True, device="cpu",
               batch: int = 2, block_plan=None,
               record: Optional[list] = None) -> List[Finding]:
    """``apply_fno`` forward and the loss's grad on the fused path, in the
    fused designs ("block": whole-block full; "partial"; "spectral":
    ``fuse_block`` off; "ends": ``fuse_ends``): exact launches and
    policy-clean casts. block_plan: the configs' ``FNOConfig.block_plan``
    (e.g. pins of hc / ot that force tiled plans); `record` collects each
    launch's (kind, plan override) as ``counted_calls``'."""
    from repro_torch.core import fno as fno_mod

    findings: List[Finding] = []
    for arch, dtype, design in itertools.product(archs, dtypes, designs):
        cfg = dataclasses.replace(
            model_cfg(arch, dtype, reduced=reduced,
                      fuse_block=design != "spectral",
                      fuse_ends=design == "ends"), block_plan=block_plan)
        variant = "partial" if design == "partial" else "full"
        target = f"apply_fno {arch}/{design}/{dtype}"
        params = _model_params(cfg, device)
        x = torch.randn((batch, cfg.in_channels) + tuple(cfg.spatial),
                        generator=torch.Generator().manual_seed(1)
                        ).to(device)
        leaves, tree_of = _flatten(params)
        fwd = lambda *lv: fno_mod.apply_fno(  # noqa: E731
            tree_of(lv), cfg, x, variant=variant)
        want_fwd, want_grad = expected_model_launches(cfg, variant)
        with torch.no_grad():
            findings += check_launch_count(fwd, leaves, want_fwd,
                                           target=f"{target} fwd",
                                           record=record)
            findings += check_cast_ownership(fwd, leaves, cfg.precision,
                                             target=f"{target} fwd")
        findings += check_launch_count(_grad_fn(fwd), leaves, want_grad,
                                       target=f"{target} grad", record=record)
        findings += check_cast_ownership(_grad_fn(fwd), leaves,
                                         cfg.precision,
                                         target=f"{target} grad")
    return findings


def _flatten(params):
    from repro_torch import tree
    leaves = tree.leaves(params)
    return leaves, lambda lv: tree.unflatten(params, list(lv))


def _served(server, x, k: int) -> Dict[str, int]:
    """{kind: launches} one request runs: ``engine.LAUNCHES`` across it on
    a graphed server (its replays pass through no wrapper), the wrapper
    calls otherwise."""
    from repro_torch.kernels import engine

    if server.graphed:
        before = collections.Counter(engine.LAUNCHES)
        y = server(x, rollout_steps=k)
        if y.device.type == "cuda":
            torch.cuda.synchronize(y.device)
        got = collections.Counter(engine.LAUNCHES) - before
        out: Dict[str, int] = {}
        for (kind, _), n in got.items():
            out[kind] = out.get(kind, 0) + n
        return out
    return launch_counts(server, x, rollout_steps=k)


def lint_rollout(archs: Sequence[str] = ("fno1d", "fno2d", "fno3d"),
                 dtypes: Sequence[str] = DTYPES,
                 ks: Sequence[int] = (1, 4), *, reduced: bool = True,
                 device="cpu") -> List[Finding]:
    """A K-step rollout through ``FNOServer`` issues the forward's
    launches K times (one replay of num_layers × K on the card), and its
    casts stay the policy's."""
    from repro_torch.train import serve_fno_step as sfs

    findings: List[Finding] = []
    for arch, dtype in itertools.product(archs, dtypes):
        cfg = model_cfg(arch, dtype, reduced=reduced)
        server = sfs.FNOServer(cfg, _model_params(cfg, device),
                               device=device, max_batch=2)
        x = torch.zeros((server.buckets[0], cfg.in_channels)
                        + tuple(cfg.spatial), device=server.device)
        want, _ = expected_model_launches(cfg)
        for k in ks:
            target = f"FNOServer rollout {arch}/{dtype} K={k}"
            server.warm((k,))  # build, and capture the graphs on the card
            findings += _compare_launches(
                _served(server, x, k), {n: v * k for n, v in want.items()},
                target)
            findings += check_cast_ownership(server, (x,), cfg.precision,
                                             target=target,
                                             kwargs={"rollout_steps": k})
    return findings


def lint_sharded(arch: str = "fno2d", mesh: Tuple[int, int] = (1, 2),
                 layouts: Sequence[str] = ("scatter", "psum"),
                 dtype: str = "f32", *, device="cpu",
                 backend: str = "gloo") -> List[Finding]:
    """A sharded forward of the reduced config on spawned ranks
    (``launch.mesh.spawn``, ``mesh_cases``): every rank's collectives held
    to ``collective_budget`` and its launches to num_layers of the TP
    block's kind."""
    import numpy as np

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import mesh_cases

    dp, tp = mesh
    cfgs = [dataclasses.replace(model_cfg(arch, dtype), tp_layout=lay)
            for lay in layouts]
    x = np.random.default_rng(0).normal(
        size=(2 * dp, cfgs[0].in_channels) + tuple(cfgs[0].spatial)
    ).astype(np.float32)
    job = {"mesh": mesh, "backend": backend, "device": device,
           "cases": [{"kind": "forward", "cfg": c, "seed": 0, "x": x}
                     for c in cfgs]}
    ranks = mesh_mod.spawn(mesh_cases.run_rank, dp * tp, job)
    findings: List[Finding] = []
    for r, results in enumerate(ranks):
        for cfg, res in zip(cfgs, results):
            target = f"sharded forward {arch} dp{dp}xtp{tp}/{cfg.tp_layout}"
            coll = {k: v for k, v in res["collectives"].items()
                    if not k.endswith("/batch")}  # the rows' gather
            findings += check_collective_budget(coll, cfg, tp=tp, dp=dp,
                                                target=f"{target} rank {r}")
            kind = "block_linear" if tp > 1 else "block_fwd"
            findings += _compare_launches(res["calls"],
                                          {kind: cfg.num_layers},
                                          f"{target} rank {r}")
    return findings


# ---------------------------------------------------------------------------
# Thin wrappers
# ---------------------------------------------------------------------------
def fused_block_contract() -> List[Finding]:
    """Block forward == 1 launch, grad == 4, the reduced fno2d fused model
    == num_layers (the reference's fused-block guard)."""
    findings = lint_block_matrix(ranks=(2,), layouts=("shared",),
                                 variants=("full",), dtypes=("f32",),
                                 spectral=(False,))
    findings += lint_model(archs=("fno2d",), dtypes=("f32",),
                           designs=("block",))
    return findings


def serve_step_contract(server, cfg, *, variant: str = "full",
                        rollout_steps: int = 1, kind: str = "block_fwd",
                        held: bool = True
                        ) -> Tuple[List[Finding], Dict[int, Dict[str, float]]]:
    """One request of each bucket through `server`: its launches a layer
    and step ({bucket: {kind: n}}) and, with whole-block fusion, the full
    variant and no ends (and `held`), a finding for any bucket that ran
    other than one `kind` a layer and step."""
    steps = cfg.num_layers * rollout_steps
    shape = (cfg.in_channels,) + tuple(cfg.spatial)
    out: Dict[int, Dict[str, float]] = {}
    for b in server.buckets:
        x = torch.zeros((b,) + shape, device=server.device)
        got = _served(server, x, rollout_steps)
        out[b] = {k: n / steps for k, n in sorted(got.items())}
    findings: List[Finding] = []
    if held and cfg.fuse_block and not cfg.fuse_ends and variant == "full":
        for b, got in out.items():
            if got != {kind: 1}:
                findings.append(Finding(
                    "launch-count", f"{cfg.name} serve bucket {b} "
                    f"K={rollout_steps}",
                    f"ran {got} a layer and step, want one {kind}"))
    return findings, out
