"""Continuous-batching serving for approximate-multiplier inference
(port of ``repro.serving``): request admission with deadlines, the slot
pool and the paged KV pool with prefix reuse, the fixed-shape scheduler,
self-verifying speculative decode, the engine, its robustness layer (the
accuracy-SLO governor, fault quarantine, power attribution), its
observability (span tracing, windowed metrics and their merge, OpenMetrics
export, A/B shadow replay) and the fleet (numerics tiers behind a
spec-aware router, cross-replica prefix sharing)."""

from repro_torch.serving.engine import ServingEngine, power_profile_from_params
from repro_torch.serving.fleet import (FleetReplica, FleetRouter, TierConfig,
                                       build_fleet)
from repro_torch.serving.governor import (GovernorConfig, GovernorDecision,
                                          NumericsGovernor)
from repro_torch.serving.kv_pool import SlotPool
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.paged import (BlockAllocator, BlockTable,
                                       PagedKVPool, PrefixCache)
from repro_torch.serving.request import (AdmissionController, Request,
                                         RequestQueue, RequestState)
from repro_torch.serving.scheduler import ScheduledBatch, SlotScheduler
from repro_torch.serving.shadow import ShadowRunner
from repro_torch.serving.telemetry import SPAN_KINDS, SpanEvent, SpanTracer

__all__ = ["ServingEngine", "power_profile_from_params", "FleetReplica",
           "FleetRouter", "TierConfig", "build_fleet", "GovernorConfig",
           "GovernorDecision", "NumericsGovernor", "SlotPool",
           "BlockAllocator", "BlockTable", "PagedKVPool", "PrefixCache",
           "EngineMetrics", "AdmissionController", "Request", "RequestQueue",
           "RequestState", "ScheduledBatch", "SlotScheduler", "ShadowRunner",
           "SPAN_KINDS", "SpanEvent", "SpanTracer"]
