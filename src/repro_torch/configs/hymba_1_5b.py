"""Hymba-1.5B — hybrid-head decoder: attention and SSM heads in parallel
within every layer; SWA on most layers, 3 full-attention layers.

[arXiv:2411.13676; hf]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        attention="swa",
        window_size=1024,
        global_layers=(0, 15, 31),  # first / middle / last use full attention
        rope_style="full",
        rope_base=10000.0,
        mlp="swiglu",
        norm="rmsnorm",
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=128,
        hybrid_parallel=True,
    )


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        config(), num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, window_size=16,
        global_layers=(0, 3), ssm_state=8, ssm_head_dim=16, ssm_chunk=16)
