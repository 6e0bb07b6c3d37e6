"""Checkpoints of the port's training state (see `checkpoint`)."""
from .checkpoint import (CheckpointManager, latest_step,  # noqa: F401
                         restore_checkpoint, save_checkpoint, tree_items,
                         tree_replace)
