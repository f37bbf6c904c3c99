"""Atomic, checksummed checkpoints in the reference's on-disk format."""
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
