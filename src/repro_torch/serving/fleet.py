"""Fleet serving: spec-aware routing over heterogeneous-numerics replicas
(port of ``repro.serving.fleet``).

The paper's deployment argument is per *tier*: different approximate-
multiplier configurations serve different accuracy/power operating
points.  This module makes an engine a **replica behind a router**, so one
deployment runs several at once:

* a **tier** (:class:`TierConfig`) is N replicas packing the SAME float
  parameters under one ``NumericsSpec``: one pack a tier, shared by the
  tier's replicas (no copy), so memory scales with tiers, not replicas;
* the :class:`FleetRouter` places requests through the engine's replica
  handle (submit / step / drain / load / snapshot / prefix sharing /
  tracer): latency traffic on *exact* tiers, bulk traffic on
  *approximate* tiers, the least-loaded candidate each time (queue depth,
  then mean TTFT), with optional overflow **spill** from a saturated
  approximate tier into the exact ones (never the reverse);
* replicas of a tier share their **prefix caches** by content
  (:meth:`FleetRouter.share_prefixes`): the sha256 chain hash commits to
  the whole token prefix, so exported (hash, block content) pairs are
  adoptable sight unseen;
* observability merges along ``EngineMetrics.merge``: per-tier merges,
  then a fleet merge of them (associative; mixed numerics labels collapse
  to ``"mixed"``), and one trace file a replica whose events carry its
  ``engine_id``.

The reference gives every replica a single-device JAX mesh; here every
replica of a tier runs on the tier's device (``build_fleet(device=)``)
and reads the tier's packed tensors.

Token identity: generation is greedy and numerics live in the pack, so a
request's tokens depend only on the tier that served it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

from repro_torch.serving.metrics import EngineMetrics

__all__ = ["TierConfig", "FleetReplica", "FleetRouter", "build_fleet",
           "REQUEST_CLASSES", "ROUTING_POLICIES"]

#: routing classes a request may declare (or derive from priority)
REQUEST_CLASSES = ("latency", "bulk")

#: ``spec-aware`` — class -> tier exactness + least-loaded + spill (the
#: default); ``least-loaded`` — ignore class, min
#: pending everywhere; ``round-robin`` — ignore class and load, cycle
ROUTING_POLICIES = ("spec-aware", "least-loaded", "round-robin")


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """One numerics tier of the fleet.

    ``spec`` is a ladder-style spec name (preset, ``"float"``, or a JSON
    spec path — whatever the deployment's pack function resolves).
    :func:`build_fleet` classifies the tier exact or approximate from the
    resolved spec itself (``NumericsSpec.is_exact``; ``"float"`` is
    exact), so no label can mislabel it.
    """

    name: str
    spec: str
    count: int = 1

    def __post_init__(self) -> None:
        if self.count < 1:
            raise ValueError(f"tier {self.name!r} needs count >= 1, "
                             f"got {self.count}")


class FleetReplica:
    """One engine behind the replica-handle boundary, with its fleet
    identity (tier, index, exactness).  The router only ever touches the
    handle surface of ``engine`` — nothing model- or device-shaped
    crosses this object."""

    def __init__(self, engine, tier: TierConfig, index: int,
                 exact: bool) -> None:
        self.engine = engine
        self.tier = tier
        self.index = index
        self.exact = exact
        self.replica_id = f"{tier.name}:{index}"
        self.routed = 0

    @property
    def idle(self) -> bool:
        return self.engine.idle


class FleetRouter:
    """Spec-aware request router over heterogeneous-numerics replicas.

    ``submit`` places one request: its class ("latency" | "bulk",
    derived from ``priority`` when not given — 0 is latency-sensitive,
    anything later is bulk) selects the candidate tier set, the
    least-loaded candidate wins (queue-depth first, observed mean TTFT
    as tie-break), and a saturated bulk side spills into the exact tiers
    when ``spill_threshold`` is set.  Latency traffic NEVER spills to
    approximate tiers: degrading a latency request's numerics silently
    is the one thing a spec-aware fleet exists to prevent.

    The placed engine ``Request`` is returned annotated with
    ``fleet_replica`` / ``fleet_tier`` / ``fleet_class`` / ``fleet_spill``
    so callers can audit placement (and tests can assert it).
    """

    def __init__(self, replicas: list[FleetReplica],
                 policy: str = "spec-aware",
                 spill_threshold: int | None = None) -> None:
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; valid: "
                             f"{list(ROUTING_POLICIES)}")
        if spill_threshold is not None and spill_threshold < 1:
            raise ValueError("spill_threshold must be >= 1 (or None)")
        self.replicas = list(replicas)
        self.policy = policy
        self.spill_threshold = spill_threshold
        self._exact = [r for r in self.replicas if r.exact]
        self._approx = [r for r in self.replicas if not r.exact]
        self._rr = itertools.cycle(self.replicas)
        self.spills = 0
        self.routed_by_class = {k: 0 for k in REQUEST_CLASSES}
        #: fleet iterations run by :meth:`step` (and so by :meth:`drain`)
        self.steps = 0

    # -- placement -----------------------------------------------------------

    @staticmethod
    def _least_loaded(cands: list[FleetReplica]) -> FleetReplica:
        """Min pending work; TTFT mean breaks ties (a replica that has
        been answering faster absorbs the marginal request better).
        ``min`` is stable, so equal scores keep tier declaration order —
        placement stays deterministic for the identity tests."""
        def score(rep: FleetReplica):
            ld = rep.engine.load()
            ttft = ld["ttft_mean_s"]
            return (ld["pending"], ttft if ttft is not None else 0.0)

        return min(cands, key=score)

    def _route(self, klass: str) -> tuple[FleetReplica, bool]:
        """(replica, spilled) for one request of ``klass``."""
        if self.policy == "round-robin":
            return next(self._rr), False
        if self.policy == "least-loaded":
            return self._least_loaded(self.replicas), False
        home = self._exact if klass == "latency" else self._approx
        if klass == "latency" and not home:
            raise ValueError(
                "no exact tier in the fleet: latency-sensitive traffic "
                "requires one (it never spills to approximate tiers)")
        if not home:
            # no approximate tier configured: bulk runs on the exact side
            return self._least_loaded(self._exact), False
        pick = self._least_loaded(home)
        if (klass == "bulk" and self._exact
                and self.spill_threshold is not None
                and pick.engine.load()["pending"] >= self.spill_threshold):
            spill = self._least_loaded(self._exact)
            if spill.engine.load()["pending"] < self.spill_threshold:
                return spill, True
        return pick, False

    def submit(self, prompt, max_new_tokens: int, priority: int = 0,
               klass: str | None = None, **kw):
        """Route one request; returns the placed engine ``Request``
        (annotated with its fleet placement)."""
        if klass is None:
            klass = "latency" if priority <= 0 else "bulk"
        if klass not in REQUEST_CLASSES:
            raise ValueError(f"unknown request class {klass!r}; valid: "
                             f"{list(REQUEST_CLASSES)}")
        rep, spilled = self._route(klass)
        req = rep.engine.submit(prompt, max_new_tokens, priority=priority,
                                **kw)
        req.fleet_replica = rep.replica_id
        req.fleet_tier = rep.tier.name
        req.fleet_class = klass
        req.fleet_spill = spilled
        rep.routed += 1
        self.routed_by_class[klass] += 1
        if spilled:
            self.spills += 1
        tr = rep.engine.tracer
        if tr is not None:
            tr.record("routed", rid=req.rid, klass=klass,
                      tier=rep.tier.name, replica=rep.replica_id,
                      spill=spilled)
        return req

    # -- serving loop --------------------------------------------------------

    @property
    def idle(self) -> bool:
        return all(r.idle for r in self.replicas)

    def step(self) -> list:
        """One fleet iteration: every non-idle replica advances one engine
        step.  Returns the requests that finished across the fleet."""
        finished = []
        for rep in self.replicas:
            if not rep.idle:
                finished.extend(rep.engine.step())
        self.steps += 1
        return finished

    def drain(self, max_steps: int | None = None,
              share_every: int | None = None) -> list:
        """Serve until the whole fleet is idle (or ``max_steps`` fleet
        iterations).  ``share_every`` runs :meth:`share_prefixes` every N
        iterations, so prompt blocks finished on a warm replica reach
        cold ones while traffic is still arriving via ``submit``."""
        finished = []
        steps = 0
        while not self.idle:
            finished.extend(self.step())
            steps += 1
            if share_every and steps % share_every == 0:
                self.share_prefixes()
            if max_steps is not None and steps >= max_steps:
                break
        return finished

    # -- cross-replica prefix sharing ----------------------------------------

    def share_prefixes(self) -> int:
        """Propagate prefix-cache entries across the fleet; returns the
        total blocks imported.

        Exports from every (paged) replica are pooled by chain hash —
        content-addressed, so two replicas publishing the same prompt
        contribute one entry — then every replica imports its pool
        (importers skip hashes they already hold, so a steady-state fleet
        converges to zero imports).  Sharing is scoped WITHIN a tier:
        the chain hash commits to the tokens, but the KV *content* was
        written by prefill under the exporter's pack, so an exact tier
        adopting blocks prefilled by an approximate pack would leak
        approximate prefill state into exact-tier generations and break
        the tier's token-identity contract.  Same tier = same pack =
        bit-identical prefill state, hence adoptable sight unseen."""
        total = 0
        by_tier: dict[str, dict[bytes, dict]] = {}
        for rep in self.replicas:
            pool = by_tier.setdefault(rep.tier.name, {})
            for h, content in rep.engine.export_prefix():
                pool.setdefault(h, content)
        for rep in self.replicas:
            pool = by_tier.get(rep.tier.name)
            if pool:
                total += rep.engine.import_prefix(list(pool.items()))
        return total

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        """Fleet-level metrics: per-tier ``EngineMetrics.merge`` of the
        tier's replica snapshots, a fleet-wide merge of the tier merges
        (merge is associative, so this equals merging every replica at
        once), and the router's own placement counters."""
        tier_snaps: dict[str, dict] = {}
        tier_order: list[str] = []
        for rep in self.replicas:
            if rep.tier.name not in tier_order:
                tier_order.append(rep.tier.name)
        for tname in tier_order:
            snaps = [r.engine.snapshot() for r in self.replicas
                     if r.tier.name == tname]
            tier_snaps[tname] = EngineMetrics.merge(snaps)
        return {
            "fleet": EngineMetrics.merge(list(tier_snaps.values())),
            "tiers": tier_snaps,
            "replicas": {r.replica_id: {
                "tier": r.tier.name, "exact": r.exact,
                "numerics": r.engine.numerics, "routed": r.routed,
            } for r in self.replicas},
            "routing": {"policy": self.policy,
                        "spill_threshold": self.spill_threshold,
                        "routed_by_class": dict(self.routed_by_class),
                        "spills": self.spills},
        }

    def write_traces(self, directory) -> list[str]:
        """One JSONL trace file per traced replica (named by replica id);
        returns the written paths.  tools/trace_report.py consumes them
        together (``--trace`` per file) and prefixes every request id
        with the replica's engine id."""
        import os

        paths = []
        os.makedirs(directory, exist_ok=True)
        for rep in self.replicas:
            if rep.engine.tracer is None:
                continue
            path = os.path.join(
                directory, f"trace-{rep.replica_id.replace(':', '-')}.jsonl")
            rep.engine.tracer.write(path)
            paths.append(path)
        return paths

    def compile_count(self) -> int:
        """Sum of per-replica jit cache sizes; each replica individually
        keeps the two-compiled-shapes invariant."""
        return sum(r.engine.compile_count() for r in self.replicas)


def build_fleet(cfg, float_params, tiers: list[TierConfig],
                ecfg, pack: Callable, api=None,
                policy: str = "spec-aware",
                spill_threshold: int | None = None,
                device=None) -> FleetRouter:
    """Assemble a router over in-process replicas from ONE checkpoint.

    ``pack(spec_name) -> (params, numerics_label, spec_or_none)`` builds a
    tier's serving parameters from the shared ``float_params`` (normally a
    ``build_serving_params`` closure, see ``repro_torch.launch.serve``).
    Packing happens once a tier and the tier's replicas share the packed
    tensors.  Each replica gets its own engine on ``device`` (default
    ``cuda``; or ``api``'s) and an ``engine_id`` of ``"<tier>:<i>"`` that
    its trace events carry.
    """
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    if not tiers:
        raise ValueError("build_fleet needs at least one TierConfig")
    names = [t.name for t in tiers]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tier names: {names}")
    api = api or build_model(cfg, device)
    replicas: list[FleetReplica] = []
    for tier in tiers:
        params, label, spec = pack(tier.spec)
        exact = spec is None or spec.is_exact  # "float" resolves None
        for i in range(tier.count):
            engine = ServingEngine(cfg, params, ecfg, api=api,
                                   numerics=label,
                                   engine_id=f"{tier.name}:{i}")
            replicas.append(FleetReplica(engine, tier, i, exact))
    return FleetRouter(replicas, policy=policy,
                       spill_threshold=spill_threshold)
