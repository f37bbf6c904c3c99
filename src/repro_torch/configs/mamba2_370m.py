"""Mamba2-370M — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "mamba2-370m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,  # Mamba2 blocks have no separate MLP
        vocab_size=50280,
        attention="none",
        rope_style="none",
        norm="rmsnorm",
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=128,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=16, vocab_size=512)
