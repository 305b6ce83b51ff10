"""Checkpoints of the global params in the JAX package's format (see
``checkpoint.py``)."""
from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "AsyncCheckpointer",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
