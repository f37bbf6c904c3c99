"""Path dispatch, the torch.fft oracle, and the fused CUDA block kernel."""
