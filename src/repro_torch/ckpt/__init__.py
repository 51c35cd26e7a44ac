"""Checkpoints: the memory tier (host snapshots) and the disk tier (the
JAX package's npz-v1 format, written in the background at the Eq.-1
interval). The PyTorch counterpart of ``repro.ckpt``."""
from .checkpoint import (CheckpointManager, restore_checkpoint,
                         save_checkpoint, sweep_stale_tmp)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "sweep_stale_tmp"]
