"""FNO model, spectral layers and DFT operand algebra."""
