"""Snowflake Arctic-480B — Dense-MoE hybrid: 128 experts top-2 with a dense
residual FFN in parallel. [hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "arctic-480b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        attention="full",
        rope_style="full",
        rope_base=10000.0,
        mlp="swiglu",
        norm="rmsnorm",
        num_experts=128,
        top_k=2,
        dense_residual=True,
    )


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, num_experts=4, top_k=2)
