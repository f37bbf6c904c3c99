"""ChatGLM3-6B — dense GQA (multi-query groups=2), 2d/partial RoPE, QKV bias.

[arXiv:2406.12793; hf]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "chatglm3-6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65024,
        attention="full",
        qkv_bias=True,
        rope_style="partial",  # ChatGLM rotates half of head_dim (2d RoPE)
        rope_fraction=0.5,
        rope_base=10000.0,
        mlp="swiglu",
        norm="rmsnorm",
    )


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512)
