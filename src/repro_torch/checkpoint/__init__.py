"""Atomic, manifest-based numpy checkpoints (a port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, all_steps,
                                                 latest_step, restore, save)

__all__ = ["Checkpointer", "all_steps", "latest_step", "restore", "save"]
