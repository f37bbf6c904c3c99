"""Qwen2-1.5B — dense GQA decoder with QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        attention="full",
        qkv_bias=True,
        rope_style="full",
        rope_base=1_000_000.0,
        mlp="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512)
