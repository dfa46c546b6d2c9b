"""Request-span tracing for the serving engine (port of
``repro.serving.telemetry``, pure Python: the same kinds, the same JSONL
and Chrome ``trace_event`` exports, so ``tools/trace_report.py`` and
``tools/obs_dashboard.py`` read the port's traces as they are).

The engine and scheduler record typed :class:`SpanEvent`\\ s at the points
that already touch a request — submission, admission, every batch row it
rides, COW copies, prefix hits, eviction, finish — into a per-engine ring
buffer (:class:`SpanTracer`).  One end-of-run ``snapshot()`` says *what* a
trace averaged to; the span buffer says *when* each thing happened and
*which* request paid for it.

Span taxonomy (:data:`SPAN_KINDS`):

  * ``queued``        — request entered the queue (instant, at submit)
  * ``admitted``      — placed into a slot; ``queue_wait_s`` rides in args
  * ``prefill_chunk`` — one chunk-shaped batch row advanced its prompt
    (duration = that engine iteration's wall time)
  * ``decode_step``   — one generated-token batch row (duration likewise)
  * ``cow_copy``      — copy-on-write block copies flushed before a step
  * ``prefix_hit``    — admission attached to cached prefix blocks
  * ``capacity_stall``— queued work could not be placed this iteration
  * ``evicted``       — re-rejected from a full queue by higher priority
  * ``rejected``      — admission control refused the request
  * ``finished``      — terminal; ``reason``/``generated`` ride in args
  * ``draft``         — one speculative round's draft phase for a
    participating slot: ``k`` approximate-spec tokens proposed
    (:mod:`repro_torch.serving.speculative`)
  * ``verify``        — the exact-spec verification of those drafts:
    ``drafted``/``accepted``/``emitted`` ride in args, so per-request
    acceptance is reconstructable from the trace alone
  * ``probe``         — one approximation-error probe result
    (:mod:`repro_torch.quant.error_probe`); carries the eager probe forward's
    wall time as its duration, so stall attribution can classify the
    decode gap it created as probe cost rather than scheduler idle
  * ``shadow``        — one A/B shadow replay of a finished sampled
    request through the second pack (:mod:`repro_torch.serving.shadow`);
    ``tokens``/``matches``/``logits_err_var`` ride in args and the
    replay's wall time is the duration
  * ``metrics_window``— one windowed time-series sample
    (:class:`~repro_torch.serving.metrics.EngineMetrics`); exported as Chrome
    *counter* events so Perfetto plots the series
  * ``governor_switch`` — the accuracy-SLO governor hot-swapped the live
    numerics pack (:mod:`repro_torch.serving.governor`); ``from``/``to``/
    ``reason``/``power_delta_pct`` ride in args
  * ``fault_detected`` — engine-side NaN/divergence detection flagged a
    batch row before emission (:mod:`repro_torch.quant.faults`)
  * ``quarantine``    — a flagged row's KV cursor was rolled back and the
    step replayed on the exact pack; ``replayed`` tokens ride in args
  * ``routed``        — the fleet router assigned a request to a replica
    (:mod:`repro_torch.serving.fleet`); ``klass``/``tier``/``replica``/``spill``
    ride in args, so tier placement is auditable from the trace alone
  * ``prefix_import`` — this replica adopted prefix-cache blocks exported
    by another replica (cross-replica sharing); ``blocks`` rides in args

Timestamps are ``time.perf_counter()`` (monotonic); exports rebase them to
the tracer's construction time.  Two export formats:

  * **JSONL** (``write("x.jsonl")``) — one event object per line; trivially
    greppable and the format ``tools/trace_report.py`` consumes natively;
  * **Chrome ``trace_event`` JSON** (``write("x.json")``) — opens directly
    in Perfetto / ``chrome://tracing``: the engine is a process, every
    request is a track (tid), batch rows are duration events, the windowed
    metrics are counter tracks.

The ring buffer drops the OLDEST events once ``capacity`` is reached
(``dropped`` counts them) so a long-running engine's tracing cost is a
bounded append, never an unbounded list.
"""

from __future__ import annotations

import collections
import json
import time
import typing

SPAN_KINDS: tuple[str, ...] = (
    "queued",
    "admitted",
    "prefill_chunk",
    "decode_step",
    "cow_copy",
    "prefix_hit",
    "capacity_stall",
    "evicted",
    "rejected",
    "finished",
    "draft",
    "verify",
    "probe",
    "shadow",
    "metrics_window",
    "governor_switch",
    "fault_detected",
    "quarantine",
    "routed",
    "prefix_import",
)

#: request-lifecycle stages every served-to-completion request passes
#: through (the CI smoke asserts >= 1 span of each in a traced run)
LIFECYCLE_KINDS: tuple[str, ...] = (
    "queued", "admitted", "prefill_chunk", "decode_step", "finished")

_SPAN_KIND_SET = frozenset(SPAN_KINDS)  # O(1) hot-path validation


class SpanEvent(typing.NamedTuple):
    """One typed telemetry event.  ``rid`` None = engine-scoped.

    A NamedTuple, not a (frozen) dataclass: events are constructed on the
    engine's hot step loop, and frozen-dataclass ``__init__`` goes through
    ``object.__setattr__`` per field."""

    kind: str
    rid: int | None
    t: float  # time.perf_counter() seconds (monotonic)
    dur: float = 0.0  # seconds; 0 = instant event
    data: dict | None = None


class SpanTracer:
    """Bounded per-engine span ring buffer with JSONL / Chrome export."""

    def __init__(self, capacity: int = 65536, engine: str = "engine",
                 pid: int = 0) -> None:
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.engine = engine
        self.pid = pid
        self.dropped = 0  # events evicted by the ring (oldest first)
        self.t0 = time.perf_counter()  # trace epoch; exports rebase to it
        self._buf: collections.deque[SpanEvent] = collections.deque(
            maxlen=capacity)

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, rid: int | None = None, t: float | None = None,
               dur: float = 0.0, **data) -> None:
        if kind not in _SPAN_KIND_SET:
            raise ValueError(f"unknown span kind {kind!r}; "
                             f"valid: {list(SPAN_KINDS)}")
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append(SpanEvent(
            kind, rid, time.perf_counter() if t is None else t, dur,
            data or None))

    def __len__(self) -> int:
        return len(self._buf)

    def events(self) -> list[SpanEvent]:
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0

    # -- export --------------------------------------------------------------

    def to_jsonl(self) -> str:
        """One JSON object per line; times in seconds from the trace epoch."""
        lines = []
        for e in self._buf:
            d = {"engine": self.engine, "kind": e.kind, "rid": e.rid,
                 "t": round(e.t - self.t0, 9), "dur": round(e.dur, 9)}
            if e.data:
                d.update(e.data)
            lines.append(json.dumps(d))
        return "\n".join(lines) + ("\n" if lines else "")

    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON (the Perfetto-compatible subset).

        ts/dur are microseconds from the trace epoch.  Events with a
        duration become ``"X"`` (complete) events, instants ``"i"``,
        windowed metrics samples ``"C"`` (counter) events.  Each request
        gets its own thread track (``tid = rid + 1``; tid 0 is the
        engine-scoped track), named via metadata events.
        """
        evs: list[dict] = []
        evs.append({"ph": "M", "pid": self.pid, "tid": 0,
                    "name": "process_name", "args": {"name": self.engine}})
        named_tids = {0}
        evs.append({"ph": "M", "pid": self.pid, "tid": 0,
                    "name": "thread_name", "args": {"name": "engine"}})
        for e in self._buf:
            tid = 0 if e.rid is None else e.rid + 1
            if tid not in named_tids:
                named_tids.add(tid)
                evs.append({"ph": "M", "pid": self.pid, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": f"request {e.rid}"}})
            args = dict(e.data or {})
            if e.rid is not None:
                args["rid"] = e.rid
            base = {"name": e.kind, "cat": "serving", "pid": self.pid,
                    "tid": tid, "ts": round((e.t - self.t0) * 1e6, 3),
                    "args": args}
            if e.kind == "metrics_window":
                # counter track: numeric args only (Perfetto plots them)
                base["ph"] = "C"
                base["tid"] = 0
                base["args"] = {k: v for k, v in args.items()
                                if isinstance(v, (int, float))
                                and not isinstance(v, bool)}
            elif e.dur > 0:
                base["ph"] = "X"
                base["dur"] = round(e.dur * 1e6, 3)
            else:
                base["ph"] = "i"
                base["s"] = "t"  # thread-scoped instant
            evs.append(base)
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"engine": self.engine,
                              "dropped_events": self.dropped}}

    def write(self, path: str) -> None:
        """``*.jsonl`` -> JSONL, anything else -> Chrome trace JSON."""
        with open(path, "w") as f:
            if str(path).endswith(".jsonl"):
                f.write(self.to_jsonl())
            else:
                json.dump(self.chrome_trace(), f)
                f.write("\n")
