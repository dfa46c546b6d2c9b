"""Continuous-batching serving for approximate-multiplier inference
(port of ``repro.serving``): request admission with deadlines, the slot
pool and the paged KV pool with prefix reuse, the fixed-shape scheduler,
self-verifying speculative decode, the engine, and its robustness layer
(the accuracy-SLO governor, fault quarantine, power attribution)."""

from repro_torch.serving.engine import ServingEngine, power_profile_from_params
from repro_torch.serving.governor import (GovernorConfig, GovernorDecision,
                                          NumericsGovernor)
from repro_torch.serving.kv_pool import SlotPool
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.paged import PagedKVPool
from repro_torch.serving.request import (AdmissionController, Request,
                                         RequestQueue, RequestState)
from repro_torch.serving.scheduler import ScheduledBatch, SlotScheduler

__all__ = ["ServingEngine", "power_profile_from_params", "GovernorConfig",
           "GovernorDecision", "NumericsGovernor", "SlotPool", "PagedKVPool",
           "EngineMetrics", "AdmissionController", "Request", "RequestQueue",
           "RequestState", "ScheduledBatch", "SlotScheduler"]
