"""Architecture and shape registry (counterpart of
``repro/configs/__init__.py``).

``get_config("qwen2-1.5b")`` → the full ``ModelConfig``;
``get_config(id, reduced=True)`` → the CPU-sized variant of the same
family; an FNO id gives its ``FNOConfig`` (``configs.fno.get_config`` is
the FNO-only form). ``runnable_cells()`` enumerates the (arch × shape)
cells with their skip reasons.
"""
from typing import Iterator, Optional, Tuple, Union

from repro_torch.configs import (arctic_480b, chatglm3_6b, fno, gemma3_27b,
                                 hubert_xlarge, hymba_1_5b, internvl2_26b,
                                 mamba2_370m, mixtral_8x7b, nemotron_4_340b,
                                 qwen2_1_5b)
from repro_torch.configs.base import (SHAPES, SMOKE_SHAPES, FNOConfig,
                                      ModelConfig, PrecisionPolicy,
                                      ShapeSpec)
from repro_torch.configs.fno import (FNO_IDS, TILED, tiled_config,
                                     with_block_plan, with_fuse_block,
                                     with_fuse_ends, with_precision,
                                     with_tp_layout)

_ARCH_MODULES = {
    "qwen2-1.5b": qwen2_1_5b,
    "gemma3-27b": gemma3_27b,
    "nemotron-4-340b": nemotron_4_340b,
    "chatglm3-6b": chatglm3_6b,
    "mamba2-370m": mamba2_370m,
    "hubert-xlarge": hubert_xlarge,
    "internvl2-26b": internvl2_26b,
    "mixtral-8x7b": mixtral_8x7b,
    "arctic-480b": arctic_480b,
    "hymba-1.5b": hymba_1_5b,
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)
ALL_IDS: Tuple[str, ...] = ARCH_IDS + FNO_IDS


def get_config(arch: str, reduced: bool = False
               ) -> Union[ModelConfig, FNOConfig]:
    """The named LM or FNO configuration, full width or reduced."""
    if arch in _ARCH_MODULES:
        mod = _ARCH_MODULES[arch]
        cfg = mod.reduced() if reduced else mod.config()
        cfg.validate()
        return cfg
    if arch in FNO_IDS:
        return fno.get_config(arch, reduced)
    raise KeyError(f"unknown arch {arch!r}; known: {ALL_IDS}")


def get_shape(name: str, reduced: bool = False) -> ShapeSpec:
    return (SMOKE_SHAPES if reduced else SHAPES)[name]


def skip_reason(arch: str, shape: str) -> Optional[str]:
    """Why an (arch × shape) cell is skipped, or None if runnable."""
    cfg = get_config(arch)
    if isinstance(cfg, FNOConfig):
        if shape in ("train_4k", "prefill_32k"):
            return None  # train cell / batched serving cell
        return "FNO is a batch workload: no autoregressive decode shapes"
    if shape in ("decode_32k", "long_500k") and not cfg.is_decoder:
        return "encoder-only: no autoregressive decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention: 500k context needs sub-quadratic "
                "attention")
    return None


def runnable_cells() -> Iterator[Tuple[str, str, Optional[str]]]:
    """(arch, shape, skip_reason) for every (arch × shape) cell: the ten
    LM archs and the FNO archs, each at every shape of ``SHAPES``."""
    for arch in ALL_IDS:
        for shape in SHAPES:
            yield arch, shape, skip_reason(arch, shape)


__all__ = ["ALL_IDS", "ARCH_IDS", "FNOConfig", "FNO_IDS", "ModelConfig",
           "PrecisionPolicy", "SHAPES", "SMOKE_SHAPES", "ShapeSpec", "TILED",
           "get_config", "get_shape", "runnable_cells", "skip_reason",
           "tiled_config", "with_block_plan", "with_fuse_block",
           "with_fuse_ends", "with_precision", "with_tp_layout"]
