"""Nemotron-4-340B — dense GQA decoder, squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "nemotron-4-340b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=96,
        d_model=18432,
        num_heads=96,
        num_kv_heads=8,
        head_dim=192,
        d_ff=73728,
        vocab_size=256000,
        attention="full",
        rope_style="full",
        rope_base=10000.0,
        mlp="relu2",
        norm="layernorm",
    )


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        config(), num_layers=2, d_model=96, num_heads=4, num_kv_heads=2,
        head_dim=24, d_ff=256, vocab_size=512)
