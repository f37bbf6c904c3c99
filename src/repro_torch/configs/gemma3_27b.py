"""Gemma3-27B — dense GQA, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-*-pt; unverified]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "gemma3-27b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        attention="local_global",
        window_size=1024,
        local_per_global=5,
        rope_style="full",
        rope_base=1_000_000.0,
        mlp="geglu",
        norm="rmsnorm",
        tie_embeddings=True,
        logit_softcap=0.0,
    )


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        config(), num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, window_size=16)
