"""Serving steps and the request-batched FNO server."""
