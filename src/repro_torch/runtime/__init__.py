"""Runtime: fault tolerance (heartbeat, straggler detection, the
resilient step loop).  The reference's compute/communication overlap
helpers (``ag_matmul_overlapped``, ``compressed_psum``) need a mesh and
collectives and come with the distributed slice of the port."""

from repro_torch.runtime.fault_tolerance import (
    Heartbeat,
    StragglerMonitor,
    run_resilient,
    RetryPolicy,
)

__all__ = [
    "Heartbeat",
    "StragglerMonitor",
    "run_resilient",
    "RetryPolicy",
]
