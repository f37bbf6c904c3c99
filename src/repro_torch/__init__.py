"""PyTorch / CUDA port of the TurboFNO system for NVIDIA Hopper (sm_90a).

A sibling of the JAX reference package ``repro``: it imports ``torch`` and
numpy only, never ``jax`` and nothing of ``repro``. Module names and the
public layouts (channel-first ``[B, C, *spatial]``; bypass weight stored
``[C_in, C_out]``) mirror the reference so each counterpart is easy to find.

Execution paths (``path=``), with their counterparts in the reference:

  ``"ref"``    — ``torch.fft`` staged oracle           (reference ``"ref"``)
  ``"staged"`` — truncated-DFT matmuls, one per stage  (reference ``"xla"``)
  ``"fused"``  — the hand-written CUDA block kernel    (reference ``"pallas"``)
"""
