"""Checkpointing: atomic, async, shard-per-process tensor store in the
reference's shard format, with restore onto a new placement."""

from repro_torch.checkpoint.manager import (CheckpointManager, load_pytree,
                                            read_meta, save_pytree)
from repro_torch.checkpoint.elastic import restore_with_sharding

__all__ = [
    "CheckpointManager",
    "save_pytree",
    "load_pytree",
    "read_meta",
    "restore_with_sharding",
]
