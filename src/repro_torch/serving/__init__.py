"""Continuous-batching serving for approximate-multiplier inference
(port of ``repro.serving``, plain path): request admission, the slot pool,
the fixed-shape scheduler and the engine."""

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_pool import SlotPool
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.request import (AdmissionController, Request,
                                         RequestQueue, RequestState)
from repro_torch.serving.scheduler import ScheduledBatch, SlotScheduler

__all__ = ["ServingEngine", "SlotPool", "EngineMetrics",
           "AdmissionController", "Request", "RequestQueue", "RequestState",
           "ScheduledBatch", "SlotScheduler"]
