"""Training step, serving steps and the request-batched FNO server."""
