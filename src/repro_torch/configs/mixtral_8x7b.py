"""Mixtral-8x7B — MoE decoder: 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "mixtral-8x7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        attention="swa",
        window_size=4096,
        rope_style="full",
        rope_base=1_000_000.0,
        mlp="swiglu",
        norm="rmsnorm",
        num_experts=8,
        top_k=2,
    )


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, num_experts=4, top_k=2,
        window_size=16)
