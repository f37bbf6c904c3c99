"""NVIDIA H100 SXM constants for the port's roofline (counterpart of
``repro/roofline/hw.py``, which holds the TPU v5e's).

Every rate is NVIDIA's published figure for the SXM part at its full
700 W power limit, dense (no structured sparsity). A card set below 700 W
runs slower under load, so a time held against these rates is stated
beside the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
"""

POWER_LIMIT_W = 700.0        # the rates below assume this limit

PEAK_FFMA_FLOPS = 67e12      # f32 on the CUDA cores (H100 SXM data sheet)
PEAK_TF32_FLOPS = 495e12     # dense TF32 on the tensor cores (data sheet)
# f32-accurate products as three TF32 passes on the tensor cores (3xTF32,
# csrc/tc_common.cuh): 165 TFLOP/s, 2.5x the CUDA cores.
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
# The least time of f32 work: the faster of the two routes.
PEAK_F32_FLOPS = max(PEAK_FFMA_FLOPS, PEAK_3XTF32_FLOPS)
PEAK_BF16_FLOPS = 989e12     # dense bf16 on the tensor cores (data sheet)

HBM_BW = 3.35e12             # HBM3, B/s (data sheet)
HBM_BYTES = 80 * 2 ** 30     # 80 GiB of device memory
# NVLink 4: 18 links, 900 GB/s a card in both directions together (data
# sheet), so 450 GB/s each way: the rate a ring collective's bytes leave at.
NVLINK_BW = 450e9            # B/s a direction

SMEM_PER_BLOCK = 232448      # dynamic shared memory one block can use (B)


def peak_flops(dtype: str) -> float:
    """The peak rate of products at a policy dtype name ("float32" /
    "bfloat16", or "f32" / "bf16")."""
    if dtype in ("float32", "f32"):
        return PEAK_F32_FLOPS
    if dtype in ("bfloat16", "bf16"):
        return PEAK_BF16_FLOPS
    raise ValueError(f"no peak rate for dtype {dtype!r}")
