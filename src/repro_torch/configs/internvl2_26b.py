"""InternVL2-26B — VLM: InternViT frontend (STUB) + InternLM2-20B backbone.

The caller provides precomputed patch embeddings [B, P, d_model]
prepended to the token sequence. [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "internvl2-26b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        attention="full",
        rope_style="full",
        rope_base=1_000_000.0,
        mlp="swiglu",
        norm="rmsnorm",
        frontend="vision",
        num_prefix_embeds=256,  # IMG_CONTEXT tokens per tile
    )


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        config(), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, num_prefix_embeds=8)
