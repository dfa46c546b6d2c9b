"""Elastic restore (port of ``repro.checkpoint.elastic``): load a
checkpoint saved under mesh A onto mesh B.

The store keeps each leaf's full value (a sharded tree is saved whole by
rank 0: ``CheckpointManager.save(..., shardings=, mesh=)``), so a restore
can lay the tree out anew.  With ``mesh`` (a ``launch.mesh.Mesh``),
``sharding_tree`` is a spec tree on it and every rank reads the full
values from shard 0 and keeps its pieces: after losing or gaining
devices, training resumes from the same step with re-laid-out
parameters — tested by saving under a (2, 2) mesh and restoring under
(4, 1).  Without a mesh, ``sharding_tree`` is a tree of ``torch.device``,
one per leaf.
"""

from __future__ import annotations

from typing import Any

from repro_torch.checkpoint.manager import CheckpointManager


def restore_with_sharding(
    manager: CheckpointManager,
    template: Any,
    sharding_tree: Any,
    step: int | None = None,
    mesh=None,
) -> tuple[Any, int]:
    """Restore and place each leaf: on its device in ``sharding_tree``
    (the template's dtypes; its devices are ignored, so a ``meta``
    template allocates nothing before the load), or, with ``mesh``, as
    this rank's piece under its spec (the template holds the full
    shapes; the pieces land on the mesh's device)."""
    if mesh is None:
        return manager.restore(template, step, placement=sharding_tree)
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel.sharding import tree_shard

    placement = tree_map(lambda _, leaf: mesh.device, template)
    full, step = manager.restore(template, step, placement=placement,
                                 index=0)
    return tree_shard(full, sharding_tree, mesh), step
