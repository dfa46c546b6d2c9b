"""Elastic restore (port of ``repro.checkpoint.elastic``): load a
checkpoint and place each leaf where a new placement tree says.

The store keeps each leaf's full value, so a restore can lay the tree out
anew: here ``placement`` is a tree of ``torch.device``, one per leaf, as
the reference's sharding tree holds one sharding per leaf.  Re-meshing
onto several devices (a leaf split across ranks, the reference's
save-under-(2, 4), restore-under-(8, 1) test) comes with the distributed
slice of the port.
"""

from __future__ import annotations

from typing import Any

from repro_torch.checkpoint.manager import CheckpointManager


def restore_with_sharding(
    manager: CheckpointManager,
    template: Any,
    placement: Any,
    step: int | None = None,
) -> tuple[Any, int]:
    """Restore and place each leaf on its device in ``placement`` (the
    template's dtypes; its devices are ignored, so a ``meta`` template
    allocates nothing before the load)."""
    return manager.restore(template, step, placement=placement)
