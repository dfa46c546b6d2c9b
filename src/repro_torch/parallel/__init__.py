"""Parallelism (port of ``repro.parallel``): the PartitionSpec rule engine
mapping parameter/cache/batch trees to mesh specs (TP + DP/FSDP + EP +
sequence sharding for decode), the specs' placements and slices on a live
mesh, and the counted collectives (:mod:`repro_torch.parallel.comm`)."""

from repro_torch.parallel.sharding import (
    P,
    PartitionSpec,
    batch_shardings,
    cache_shardings,
    fit_spec,
    gather,
    local_slices,
    param_shardings,
    placements,
    shard,
)

__all__ = ["param_shardings", "batch_shardings", "cache_shardings",
           "fit_spec", "P", "PartitionSpec", "placements", "local_slices",
           "shard", "gather"]
