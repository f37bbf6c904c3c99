"""HuBERT-XLarge — encoder-only audio transformer (w2v2 backbone).

The convolutional waveform frontend is a STUB: the caller provides
precomputed frame embeddings of shape [B, T, d_model]. [arXiv:2106.07447]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "hubert-xlarge"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="encoder",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,  # masked-prediction codebook classes
        attention="bidirectional",
        rope_style="none",  # conv positional embedding folded into frontend stub
        mlp="gelu",
        norm="layernorm",
        frontend="audio",
    )


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=64)
