"""Crash-atomic checkpoints of the port's state (``ckpt/io.py``) and their
manager: async saves, retention, restore past corrupt steps."""

from repro_torch.ckpt.io import (
    latest_step,
    load_pytree,
    save_pytree,
    valid_steps,
    verify_checkpoint,
)
from repro_torch.ckpt.manager import CheckpointManager

__all__ = [
    "save_pytree",
    "load_pytree",
    "latest_step",
    "valid_steps",
    "verify_checkpoint",
    "CheckpointManager",
]
