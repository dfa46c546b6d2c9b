"""Runtime: fault tolerance (heartbeat, straggler detection, the
resilient step loop) and the compute/communication overlap helpers
(:mod:`repro_torch.runtime.overlap`)."""

from repro_torch.runtime.fault_tolerance import (
    Heartbeat,
    StragglerMonitor,
    run_resilient,
    RetryPolicy,
)
from repro_torch.runtime.overlap import (ag_matmul_overlapped,
                                         compressed_psum,
                                         rs_matmul_overlapped)

__all__ = [
    "Heartbeat",
    "StragglerMonitor",
    "run_resilient",
    "RetryPolicy",
    "ag_matmul_overlapped",
    "rs_matmul_overlapped",
    "compressed_psum",
]
