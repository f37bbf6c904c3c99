"""FNO configurations — counterpart of ``repro/configs/fno.py``.

``fno1d``/``fno2d`` match the paper's evaluated sizes; ``fno2d-large`` is
the reference's end-to-end training target (per-mode weights, hidden 128);
``fno3d`` is the rank-3 workload; ``reduced_*`` are the small test sizes
(shared weights, as the reference reduces ``fno2d-large`` too).
"""
import dataclasses
from typing import Optional

from repro_torch.configs.base import FNOConfig, PrecisionPolicy
from repro_torch.tuning.plans import normalize_override


def with_precision(cfg: FNOConfig, dtype: str) -> FNOConfig:
    """Apply a ``--dtype`` preset ("f32"/"bf16") to an FNO config."""
    pol = PrecisionPolicy.from_name(dtype)
    return dataclasses.replace(cfg, dtype=pol.compute_dtype, policy=pol)


def with_fuse_block(cfg: FNOConfig, on: bool = True) -> FNOConfig:
    """Toggle whole-block fusion (one kernel launch per FNO layer on the
    fused path)."""
    return dataclasses.replace(cfg, fuse_block=on)


def with_tp_layout(cfg: FNOConfig, layout: str,
                   overlap: bool = False) -> FNOConfig:
    """Pick the TP inter-layer collective layout: "scatter" (the default:
    each interior layer's reduce-scatter emits the next layer's hidden
    shard) or "psum" (an all-reduce every layer). overlap=True runs the
    interior reduce-scatter as a ring of tp-1 point-to-point hops
    (scattered layout only)."""
    return dataclasses.replace(cfg, tp_layout=layout, tp_overlap=overlap)


def with_fuse_ends(cfg: FNOConfig, on: bool = True) -> FNOConfig:
    """Fold the lifting MLP into the first fused block launch and the
    projection MLP into the last one (fused path with fuse_block; ignored
    otherwise)."""
    return dataclasses.replace(cfg, fuse_ends=on)


def with_block_plan(cfg: FNOConfig, *, cluster: int = 0,
                    chain: Optional[str] = None, rows_f: int = 0,
                    rows_i: int = 0, cols: int = 0, np: int = 0,
                    nb: int = 0, kc: int = 0, ri: int = 0,
                    wj: int = 0) -> FNOConfig:
    """Pin fields of the fused launches' plans, over the tuned cache
    (``repro_torch.tuning``): 0 or None keeps the resolved value. Each
    launch takes the fields its kernel has: the block kernel's cluster,
    chain ("tc" / "fma"), rows_f and rows_i (s_1 rows of a forward and an
    inverse chunk); the wgrad's cluster, chain, rows_f and cols (points of
    a dW_b chunk); the core's cluster, np, nb, kc, ri and wj. A field the
    planner refuses raises at the launch (ValueError naming it). Composes
    with :func:`with_precision` / :func:`with_fuse_block`."""
    pins = dict(cluster=cluster, chain=chain, rows_f=rows_f, rows_i=rows_i,
                cols=cols, np=np, nb=nb, kc=kc, ri=ri, wj=wj)
    out = dataclasses.replace(cfg, block_plan=normalize_override(pins))
    out.validate()
    return out


def fno1d() -> FNOConfig:
    return FNOConfig(
        name="fno1d", ndim=1, hidden=64, num_layers=4,
        in_channels=1, out_channels=1,
        spatial=(256,), modes=(64,), weight_mode="shared")


def fno2d() -> FNOConfig:
    return FNOConfig(
        name="fno2d", ndim=2, hidden=64, num_layers=4,
        in_channels=3, out_channels=1,  # (a(x,y), x, y) -> u(x,y)
        spatial=(128, 128), modes=(32, 32), weight_mode="shared")


def fno2d_large() -> FNOConfig:
    """~134M-param per-mode FNO, the end-to-end training target."""
    return FNOConfig(
        name="fno2d-large", ndim=2, hidden=128, num_layers=4,
        in_channels=3, out_channels=1,
        spatial=(128, 128), modes=(32, 32), weight_mode="per_mode")


def fno3d() -> FNOConfig:
    return FNOConfig(
        name="fno3d", ndim=3, hidden=32, num_layers=4,
        in_channels=1, out_channels=1,
        spatial=(64, 64, 64), modes=(16, 16, 16), weight_mode="shared")


def reduced_1d() -> FNOConfig:
    return dataclasses.replace(
        fno1d(), hidden=16, num_layers=2, spatial=(64,), modes=(16,))


def reduced_2d() -> FNOConfig:
    return dataclasses.replace(
        fno2d(), hidden=16, num_layers=2, spatial=(32, 32), modes=(8, 8))


def reduced_3d() -> FNOConfig:
    return dataclasses.replace(
        fno3d(), hidden=8, num_layers=2, spatial=(16, 16, 16),
        modes=(4, 4, 4))


_FACTORIES = {
    "fno1d": (fno1d, reduced_1d),
    "fno2d": (fno2d, reduced_2d),
    "fno2d-large": (fno2d_large, reduced_2d),
    "fno3d": (fno3d, reduced_3d),
}
FNO_IDS = tuple(_FACTORIES)


def get_config(arch: str, reduced: bool = False) -> FNOConfig:
    """The named FNO configuration, full width or reduced."""
    if arch not in _FACTORIES:
        raise KeyError(f"unknown arch {arch!r}; known: {FNO_IDS}")
    full, red = _FACTORIES[arch]
    cfg = red() if reduced else full()
    cfg.validate()
    return cfg
