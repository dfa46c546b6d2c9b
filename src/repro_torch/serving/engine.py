"""The continuous-batching serving engine (port of
``repro.serving.engine``).

``submit()`` runs admission control (with priority eviction from a full
queue) and enqueues; ``step()`` purges queued requests whose deadline
passed, admits into free slots (``kv_layout="paged"`` also needs every
block a request can need, and may skip a cached shared prefix's prefill),
asks the scheduler for one fixed-shape batch — chunk-shaped with mixed
prefill+decode rows when both kinds pend, thin ``(slots, 1)`` otherwise —
runs the model's slot step (which updates the KV cache in place), and
advances every participating request through one per-row postprocess.

Numerics live in the parameters (``repro_torch.launch.serve.
build_serving_params``): the same engine serves float, exact-int8 and
approximate+CV packs.  Generation is greedy (argmax).  With
``EngineConfig.speculative_k > 0`` and ``draft_params`` (the same weights
packed under an approximate spec) the engine runs self-verifying
speculative decode (``repro_torch.serving.speculative``): the draft
parameters propose on the thin step, one chunk-shaped call of the exact
parameters verifies, and only verifier tokens are emitted.

The robustness layer rides the same loop:

  * the error probe (``EngineConfig.error_probe_every``,
    :mod:`repro_torch.quant.error_probe`) re-runs one served row every N
    steps, approximate and exact-int8, on a private copy of its KV;
  * the governor (``governor=``, :mod:`repro_torch.serving.governor`)
    turns the probe's reports into an accuracy SLO and hot-swaps the live
    pack along its ladder, building each rung's pack once through
    ``pack_fn``;
  * fault detection (``EngineConfig.detect_faults``, or a
    ``fault_injector``, :mod:`repro_torch.quant.faults`) checks every
    step's consumed logits and replays a corrupted row on the exact pack
    (``exact_params``) before it emits;
  * every served token is priced with the cost model's modeled power
    saving of the pack that served it (``power_profile_from_params``).

Observability rides it too: with ``EngineConfig.trace`` every point that
touches a request records a typed span (:mod:`repro_torch.serving.
telemetry`) into a per-engine ring, ``metrics_window_s`` rolls the
metrics' windowed time series (bridged into the trace as counter events),
and ``shadow_fraction`` with ``shadow_params`` replays a deterministic
sample of finished requests teacher-forced through a second pack
(:mod:`repro_torch.serving.shadow`) for an A/B verdict.  The replica
handle a fleet router drives (:mod:`repro_torch.serving.fleet`) is
``submit`` / ``step`` / ``drain`` / ``load`` / ``snapshot`` /
``export_prefix`` / ``import_prefix`` / ``tracer``, with plain data
across it.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, EngineConfig
from repro_torch.models.registry import ModelApi, build_model
from repro_torch.quant import faults
from repro_torch.quant.error_probe import ErrorProbe
from repro_torch.serving import speculative
from repro_torch.serving.kv_pool import SlotPool
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.request import (AdmissionController, Request,
                                         RequestQueue, RequestState)
from repro_torch.serving.scheduler import ScheduledBatch, SlotScheduler
from repro_torch.serving.telemetry import SpanTracer


def _has_blocked_packs(params) -> bool:
    """True iff a packed leaf carries the kernel's blocked layout (only
    ``backend: "pallas"`` packs do; the decode-specialized flag is gated
    on it)."""
    from repro_torch.core.approx_linear import (LayerStack, QuantizedDense,
                                                QuantizedDenseGroup)

    def walk(node) -> bool:
        if isinstance(node, (QuantizedDense, QuantizedDenseGroup)):
            return node.blocked is not None
        if isinstance(node, LayerStack):
            return any(walk(node[i]) for i in range(len(node)))
        if isinstance(node, dict):
            return any(walk(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return any(walk(v) for v in node)
        return False

    return walk(params)


def power_profile_from_params(params, n_array: int = 64) -> dict:
    """Per-layer modeled MAC cost/saving profile of a (packed) parameter
    tree: ``{path: {mac_per_token, saving_pct}}``.

    ``mac_per_token`` is the layer's MAC count a served token (its weight
    shape's product, every layer of a stack counted); ``saving_pct`` the
    cost model's modeled array-power saving for its policy (0 for exact
    and float layers).  Only linear layers are profiled: they are where
    the approximate multipliers live.  This is the PackPlan x cost-model
    join on the LIVE pack, so a governor hot-swap re-derives it from what
    actually serves."""
    from repro_torch.core.approx_linear import (LayerStack, QuantizedDense,
                                                is_linear_params)
    from repro_torch.core.cost_model import power_saving

    prof: dict[str, dict] = {}

    def add(path, shape, policy):
        saving = (power_saving(policy.mode, policy.m, n_array)
                  if policy is not None and policy.is_approx else 0.0)
        prof[path] = {"mac_per_token": float(np.prod(shape)),
                      "saving_pct": round(float(saving), 3)}

    def walk(node, path):
        if isinstance(node, LayerStack):
            # the reference's stacked pack: (layers, k, n) codes
            add(path, (len(node),) + tuple(node[0].w_q.shape), node[0].policy)
        elif isinstance(node, QuantizedDense):
            add(path, node.w_q.shape, node.policy)
        elif isinstance(node, dict):
            if is_linear_params(node):
                add(path, node["w"].shape, None)
                return
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i))

    walk(params, "")
    return prof


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig = EngineConfig(),
                 api: ModelApi | None = None, numerics: str | None = None,
                 device=None, draft_params=None,
                 draft_numerics: str | None = None, governor=None,
                 pack_fn: Callable | None = None, fault_injector=None,
                 exact_params=None, engine_id: str | None = None,
                 shadow_params=None,
                 shadow_numerics: str | None = None, mesh=None) -> None:
        """``device`` defaults to ``cuda`` and raises without a card; pass
        ``device="cpu"`` (or an ``api`` built for it) to serve on the CPU.
        ``params`` serve (and, under speculation, verify); ``draft_params``
        draft when ``ecfg.speculative_k > 0``.  ``governor`` (a
        :class:`~repro_torch.serving.governor.NumericsGovernor`) walks its
        ladder on the probe's reports, ``pack_fn(spec_or_None)`` building
        each rung's pack on first use (None: float); ``fault_injector``
        corrupts deterministically for testing; ``exact_params`` is the
        pack quarantine replays run on (default: the live pack, right when
        that is exact, e.g. ``int8``).  ``engine_id`` names the engine in
        traces and fleets (default: the numerics label).  ``shadow_params``
        is the second pack shadow replays run (``ecfg.shadow_fraction >
        0``), labelled ``shadow_numerics``.  ``mesh`` (a
        ``launch.mesh.Mesh``) is threaded through every model call the
        engine makes (the step, the probe, shadow replays, speculative
        rounds): an MoE arch with ``moe_impl="ep_psum"`` then serves
        expert-parallel over it."""
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.api = api or build_model(cfg, device)
        self.mesh = mesh
        if mesh is not None and self.api.decode_slots is not None:
            self.api = dataclasses.replace(
                self.api, decode_slots=functools.partial(
                    self.api.decode_slots, mesh=mesh))
        if self.api.init_slot_cache is None or self.api.decode_slots is None:
            why = self.api.slot_refusal or "no slot cache"
            raise NotImplementedError(
                f"{cfg.name}: the continuous-batching engine does not serve "
                f"this arch ({why}); use the lock-step path "
                "(`python -m repro_torch.launch.serve --legacy`)")
        self.numerics = numerics
        #: identity in traces and fleet routing
        self.engine_id = engine_id or numerics or "engine"
        self.draft_params = draft_params
        self.draft_numerics = draft_numerics
        self._spec_k = int(ecfg.speculative_k)
        if self._spec_k:
            if draft_params is None:
                raise ValueError(
                    "speculative_k > 0 needs draft_params: the approximate-"
                    "spec packed parameters that draft for this engine "
                    "(same weights, different numerics — see "
                    "repro_torch.launch.serve.build_serving_params)")
            if cfg.rwkv:
                # rollback is a cursor move over position-indexed K/V;
                # recurrent per-slot state cannot rewind a rejected draft
                raise NotImplementedError(
                    f"{cfg.name}: speculative decode needs a position-"
                    "indexed KV cache to roll back rejected drafts "
                    "(recurrent RWKV state cannot rewind)")
        if ecfg.kv_layout == "paged":
            from repro_torch.serving.paged import PagedKVPool

            self.pool = PagedKVPool(self.api, ecfg)
        elif ecfg.kv_layout == "contiguous":
            self.pool = SlotPool(self.api, ecfg.slots, ecfg.max_len,
                                 ecfg.cache_dtype)
        else:
            raise ValueError(f"unknown kv_layout {ecfg.kv_layout!r}; "
                             "valid choices: ['contiguous', 'paged']")
        self._paged = ecfg.kv_layout == "paged"
        # the pool's cumulative counters at the start of the metrics window
        self._block_baseline = (self.pool.block_stats() if self._paged
                                else None)
        self.queue = RequestQueue()
        self.admission = AdmissionController(
            ecfg.max_queue, ecfg.max_len, ecfg.prefill_chunk,
            kv_block_size=ecfg.kv_block_size if self._paged else None,
            kv_blocks=self.pool.blocks_total if self._paged else None)
        self.scheduler = SlotScheduler(ecfg.slots, ecfg.prefill_chunk,
                                       ecfg.interleave, ecfg.mixed_batches)
        from repro_torch.kernels.ops import DECODE_M_MAX

        # thin steps run the kernel's split-K decode rows: only blocked
        # (kernel) packs go through it
        self._decode_specialized = (ecfg.slots <= DECODE_M_MAX
                                    and _has_blocked_packs(params))
        self._shadow = None
        self.metrics = self._new_metrics()
        # request-span tracing: a bounded ring of typed events, recorded
        # at points the engine already touches each request
        self.tracer = (SpanTracer(capacity=ecfg.trace_buffer,
                                  engine=self.engine_id)
                       if ecfg.trace else None)
        self._bridge_window_samples()
        # -- robustness layer ------------------------------------------------
        self._probe = None
        self._steps = 0
        if ecfg.error_probe_every > 0:
            self._probe = ErrorProbe(self.api, paged=self._paged,
                                     kv_len=ecfg.max_len,
                                     block_size=ecfg.kv_block_size)
        self.governor = governor
        self._pack_fn = pack_fn
        self._injector = fault_injector
        self._exact_params = exact_params
        self._detect = fault_injector is not None or ecfg.detect_faults
        self._rung_packs: dict = {}
        #: quarantine replays: {rid, slot, step, token}
        self.quarantine_log: list[dict] = []
        if governor is not None:
            if pack_fn is None:
                raise ValueError(
                    "a governor needs pack_fn: called with a rung's "
                    "NumericsSpec (or None for float) to build the pack it "
                    "hot-swaps in — see repro_torch.launch.serve for the "
                    "build_serving_params closure")
            if ecfg.error_probe_every <= 0:
                raise ValueError(
                    "the governor consumes the error probe; set "
                    "EngineConfig.error_probe_every > 0")
            if self._spec_k:
                raise ValueError(
                    "governor + speculative decode is unsupported: "
                    "speculation already pins every emitted token to the "
                    "exact pack, so there is no approximate emission for "
                    "an SLO to govern")
            # the live params ARE the starting rung's pack
            self._rung_packs[governor.rung.name] = params
        if fault_injector is not None and self._spec_k:
            raise ValueError(
                "fault injection targets the plain serving path; the "
                "speculative path's emissions are exact-verified already")
        if self._detect and cfg.rwkv:
            # the quarantine rollback is a cursor move; the recurrent
            # state has already consumed the corrupted step's tokens, and
            # the reference's replay onto it diverges from a clean run
            raise NotImplementedError(
                f"{cfg.name}: fault detection and quarantine replay need a "
                "position-indexed KV cache to roll a corrupted step back "
                "(recurrent RWKV state has already advanced past the step, "
                "so a replay onto it is not the clean step)")
        # -- A/B shadow serving (repro_torch.serving.shadow) -----------------
        # a sampled fraction of FINISHED requests replays teacher-forced
        # through a second pack at finish time inside step()
        self._finish_count = 0
        if ecfg.shadow_fraction > 0:
            if shadow_params is None:
                raise ValueError(
                    "shadow_fraction > 0 needs shadow_params: the second "
                    "NumericsSpec pack sampled requests replay through "
                    "(same weights, different numerics)")
            if self._spec_k:
                raise ValueError(
                    "shadow serving + speculative decode is unsupported: "
                    "the draft pack already occupies the second-pack slot")
            if governor is not None:
                raise ValueError(
                    "shadow serving + governor is unsupported: a mid-run "
                    "hot-swap would mix regimes inside one A/B verdict")
            from repro_torch.serving.shadow import ShadowRunner

            self._shadow = ShadowRunner(
                self.api, ecfg, params, shadow_params,
                primary_label=numerics or "primary",
                shadow_label=shadow_numerics or "shadow")
            self.metrics.shadow_numerics = self._shadow.shadow_label
        self._power_profiles: dict = {}
        self._register_power_profile()
        self.active: dict[int, Request] = {}
        self._rid = itertools.count()
        #: (parameter tree, token shape) pairs dispatched: the counterpart
        #: of the reference's jit cache (:meth:`compile_count`)
        self._shapes: set[tuple[int, tuple[int, ...]]] = set()

    def _new_metrics(self) -> EngineMetrics:
        return EngineMetrics(
            numerics=self.numerics, kv_layout=self.ecfg.kv_layout,
            decode_specialized=self._decode_specialized,
            window_s=self.ecfg.metrics_window_s,
            speculative_k=self._spec_k,
            draft_numerics=self.draft_numerics if self._spec_k else None,
            shadow_numerics=(self._shadow.shadow_label
                             if self._shadow is not None else None))

    def _bridge_window_samples(self) -> None:
        """Forward the windowed metrics samples into the span trace as
        Chrome counter events; the sample's own ``t`` rides as
        ``window_t``."""
        if self.tracer is not None and self.metrics.window_s > 0:
            self.metrics.on_window_sample = (
                lambda s: self.tracer.record(
                    "metrics_window",
                    **{("window_t" if k == "t" else k): v
                       for k, v in s.items()}))

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, priority: int = 0,
               eos_id: int | None = None,
               on_token: Callable | None = None,
               deadline_ms: float | None = None) -> Request:
        """Admission-checked enqueue; returns the Request (maybe REJECTED;
        a queued request can still be REJECTED later, evicted from a full
        queue by a more urgent one)."""
        req = Request(rid=next(self._rid), prompt=[int(t) for t in prompt],
                      max_new_tokens=int(max_new_tokens), priority=priority,
                      eos_id=eos_id, on_token=on_token,
                      deadline_ms=deadline_ms)
        self.metrics.submitted += 1
        tr = self.tracer
        ok, reason, evicted = self.admission.admit(self.queue, req)
        if not ok:
            req.state = RequestState.REJECTED
            req.reject_reason = reason
            self.metrics.rejected += 1
            if tr is not None:
                tr.record("rejected", rid=req.rid, reason=reason)
            return req
        if evicted is not None:
            evicted.state = RequestState.REJECTED
            evicted.reject_reason = (f"evicted from full queue by "
                                     f"higher-priority request {req.rid}")
            self.metrics.rejected += 1
            self.metrics.evicted += 1
            if tr is not None:
                tr.record("evicted", rid=evicted.rid, by=req.rid)
        self.queue.push(req)
        if tr is not None:
            tr.record("queued", rid=req.rid, t=req.t_queued_mono,
                      prompt_len=req.prompt_len, priority=req.priority)
        return req

    # -- engine loop ---------------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self.active and not len(self.queue)

    def step(self) -> list[Request]:
        """One engine iteration; returns the requests that finished in it
        (queued requests whose deadline passed included)."""
        tr = self.tracer
        expired = self.scheduler.purge_expired(self.queue, self.metrics,
                                               tracer=tr)
        admitted = self.scheduler.admit(self.queue, self.pool, self.active,
                                        self.metrics, tracer=tr)
        for r in admitted:
            if r.prefix_hit_tokens:
                self.metrics.prefix_hits += 1
                self.metrics.prefix_hit_tokens += r.prefix_hit_tokens
                if tr is not None:
                    tr.record("prefix_hit", rid=r.rid,
                              hit_tokens=r.prefix_hit_tokens)
        if self._spec_k:
            # every turn is a speculative round, so plain decode rows ride
            # chunk-shaped exact calls and the exact parameters never run
            # the thin shape
            rnd = speculative.plan_round(self.active, self._spec_k,
                                         self.ecfg.prefill_chunk)
            if rnd is None:
                return expired
            return expired + self._speculative_step(rnd)
        batch = self.scheduler.next_batch(self.active)
        if batch is None:
            return expired
        # arm the throughput clock before the first served dispatch
        self.metrics.start_clock()
        t0 = time.perf_counter() if tr is not None else 0.0
        probe_due = self._probe_due()
        tables = None
        if self._paged:
            # copy-on-write barrier: every block this batch writes is
            # uniquely owned before the step runs
            cow0 = self.pool.cow_copies
            for slot, nv in enumerate(batch.n_valid):
                self.pool.ensure_writable(slot, int(nv))
            self.pool.flush_copies()
            if tr is not None and self.pool.cow_copies > cow0:
                tr.record("cow_copy", copies=self.pool.cow_copies - cow0)
            tables = self.pool.block_tables_array()
        # the probe re-runs a row from its pre-step cursor (the cache is
        # written in place, so the cursor is what must be kept)
        pre_lengths = self.pool.lengths() if probe_due else None
        logits = self._dispatch(self.params, batch, tables)
        if self._paged:
            self.pool.advance(batch.n_valid)
        # fault injection (step surface): corrupt a copy of chosen rows'
        # logits; the detector below must catch every one before emission
        if (self._injector is not None
                and self._injector.spec.surface == "step"
                and self._injector.fires(self._steps)):
            live = [r.slot for r in batch.rows if batch.n_valid[r.slot] > 0]
            bad_rows = self._injector.plan_rows(self._steps, live)
            if bad_rows:
                logits = self._injector.corrupt_logits(self._steps, logits,
                                                       bad_rows)
                self.metrics.faults_injected += len(bad_rows)
        pp_batch, q_finished, q_emitted, q_prompt = (
            self._quarantine(batch, logits, tables) if self._detect
            else (batch, [], 0, 0))
        finished, emitted, prompt_toks = self._postprocess(pp_batch, logits)
        finished += q_finished
        emitted += q_emitted
        prompt_toks += q_prompt
        if tr is not None:
            t1 = time.perf_counter()
            for r, kind in zip(batch.rows, batch.row_kinds):
                tr.record("prefill_chunk" if kind == "prefill"
                          else "decode_step", rid=r.rid, t=t0, dur=t1 - t0,
                          slot=r.slot, n_valid=int(batch.n_valid[r.slot]))
            self._trace_finished(finished)
        self.metrics.record_step(
            batch.kind, self.pool.occupancy, len(self.queue),
            prompt_tokens=prompt_toks, generated_tokens=emitted,
            block_stats=self._windowed_block_stats() if self._paged else None)
        self._steps += 1
        if probe_due:
            self._run_probe(batch, pre_lengths, tables)
        if self._shadow is not None and finished:
            self._run_shadow(finished)
        return expired + finished

    def _trace_finished(self, finished: list[Request]) -> None:
        for r in finished:
            self.tracer.record("finished", rid=r.rid, reason=r.finish_reason,
                               generated=len(r.generated))

    # -- A/B shadow serving (repro_torch.serving.shadow) ---------------------

    def _run_shadow(self, finished: list[Request]) -> None:
        """Replay the sampled finished requests (every Nth with generated
        tokens) teacher-forced through both packs; each replay records a
        ``shadow`` span whose duration is its wall time."""
        for r in finished:
            if not r.generated:
                continue
            self._finish_count += 1
            if not self._shadow.wants(self._finish_count):
                continue
            t0 = time.perf_counter()
            rec = self._shadow.replay(r.prompt, r.generated)
            t1 = time.perf_counter()
            self.metrics.record_shadow(rec)
            if self.tracer is not None:
                self.tracer.record(
                    "shadow", rid=r.rid, t=t0, dur=t1 - t0,
                    tokens=rec["tokens"], matches=rec["matches"],
                    logits_err_var=rec["logits_err"]["var"],
                    logits_err_max_abs=rec["logits_err"]["max_abs"])

    def shadow_verdict(self) -> dict | None:
        """The accumulated A/B verdict (None without a shadow, or before
        the first replay)."""
        return self._shadow.verdict() if self._shadow is not None else None

    # -- fault detection & quarantine (repro_torch.quant.faults) -------------

    def _quarantine(self, batch: ScheduledBatch, logits: torch.Tensor,
                    tables) -> tuple[ScheduledBatch, list[Request], int, int]:
        """Detect corrupted rows in this step's logits and quarantine them.

        Each live row's consumed column (``n_valid - 1``) is checked on
        the device for non-finite or divergent values
        (:func:`repro_torch.quant.faults.suspect_rows`; only the mask
        comes to the host).  A flagged row's cursor rolls back to its
        pre-step value (a pure cursor move, the speculative rollback) and
        the row REPLAYS on the exact pack without the injector, so its
        corrupted logits are discarded before any token is emitted.
        Returns the batch without the flagged rows and the replay's
        ``(finished, emitted, prompt_tokens)``."""
        nv = np.asarray(batch.n_valid)
        live = [(r, k) for r, k in zip(batch.rows, batch.row_kinds)
                if nv[r.slot] > 0]
        if not live:
            return batch, [], 0, 0
        slots = torch.as_tensor([r.slot for r, _ in live],
                                device=logits.device)
        cols = torch.as_tensor(np.maximum(nv - 1, 0),
                               device=logits.device)[slots]
        mask = faults.suspect_rows(logits[slots, cols])
        if not mask.any():
            return batch, [], 0, 0
        bad = [live[i] for i in np.nonzero(mask)[0]]
        bad_slots = {r.slot for r, _ in bad}
        tr = self.tracer
        self.metrics.faults_detected += len(bad)
        if tr is not None:
            for r, _ in bad:
                tr.record("fault_detected", rid=r.rid, slot=r.slot,
                          step=self._steps)
        if self.governor is not None:
            # a detected fault is an unbounded-variance observation: the
            # governor escalates at once, no window arithmetic
            self._apply_decision(self.governor.note_fault())
        # the flagged slots' cursors back to their pre-step values
        cur = self.pool.lengths()
        for r, _ in bad:
            cur[r.slot] -= int(nv[r.slot])
        self.pool.set_lengths(cur)
        # replay ONLY the flagged rows on the exact pack, same batch shape
        rep_nv = np.zeros_like(nv)
        for r, _ in bad:
            rep_nv[r.slot] = nv[r.slot]
        rep_batch = ScheduledBatch(batch.kind, batch.tokens, rep_nv,
                                   [r for r, _ in bad], [k for _, k in bad])
        rep_params = (self._exact_params if self._exact_params is not None
                      else self.params)
        rep_logits = self._dispatch(rep_params, rep_batch, tables)
        if self._paged:
            self.pool.advance(rep_nv)
        self.metrics.quarantines += len(bad)
        self.metrics.quarantine_replays += len(bad)
        finished, emitted, prompt_toks = self._postprocess(rep_batch,
                                                           rep_logits)
        for r, _ in bad:
            tok = r.generated[-1] if r.generated else None
            self.quarantine_log.append({"rid": r.rid, "slot": r.slot,
                                        "step": self._steps, "token": tok})
            if tr is not None:
                tr.record("quarantine", rid=r.rid, slot=r.slot,
                          step=self._steps, replayed=int(rep_nv[r.slot]))
        clean_nv = np.array(nv, copy=True)
        clean_nv[list(bad_slots)] = 0
        clean = ScheduledBatch(
            batch.kind, batch.tokens, clean_nv,
            [r for r in batch.rows if r.slot not in bad_slots],
            [k for r, k in zip(batch.rows, batch.row_kinds)
             if r.slot not in bad_slots])
        return clean, finished, emitted, prompt_toks

    # -- error probe and governor --------------------------------------------

    def _probe_due(self) -> bool:
        """Whether the step about to run is probed (every N-th step)."""
        return (self._probe is not None
                and (self._steps + 1) % self.ecfg.error_probe_every == 0)

    def _run_probe(self, batch: ScheduledBatch, lengths, tables) -> None:
        """One approximation-error probe of the batch just served, from
        the rows' pre-step cursors ``lengths``.  A dense-surface injector
        arms its hook around the probe (a degraded MAC array corrupts what
        the probe measures, which is how the governor sees it); the report
        feeds the metrics and the governor's running SLO estimate."""
        t0 = time.perf_counter()
        inj = self._injector
        args = (self.params, batch.tokens, batch.n_valid, self.pool.cache,
                lengths)
        if inj is not None and inj.spec.surface == "dense":
            log0 = len(inj.log)
            with inj.armed(self._steps):
                report = self._probe.run(*args, block_tables=tables)
            self.metrics.faults_injected += len(inj.log) - log0
        else:
            report = self._probe.run(*args, block_tables=tables)
        t1 = time.perf_counter()
        if report is None:
            return
        self.metrics.record_probe(report)
        if self.tracer is not None:
            # the span's duration is the probe's wall time, so the decode
            # gap it opens reads as probe cost, not scheduler idle
            rid = next((r.rid for r in batch.rows
                        if r.slot == report["row"]), None)
            lvars = {p: st["var"] for p, st in report["layers"].items()}
            extra = {}
            if lvars:
                worst = max(lvars, key=lvars.get)
                extra = {"max_layer_err_var": lvars[worst],
                         "worst_layer": worst}
            self.tracer.record(
                "probe", rid=rid, t=t0, dur=t1 - t0,
                logits_err_var=report["logits"]["var"],
                logits_err_max_abs=report["logits"]["max_abs"],
                mean_layer_err_var=(sum(lvars.values()) / len(lvars)
                                    if lvars else 0.0), **extra)
        if self.governor is not None:
            self._apply_decision(self.governor.observe_probe(report))

    def _apply_decision(self, decision) -> None:
        """Execute one governor ladder move: hot-swap the live pack.  Rung
        packs build lazily through ``pack_fn`` and are cached per rung
        name, so an escalate/relax cycle packs each rung once; every
        request's KV carries over untouched."""
        if decision is None:
            return
        rung = self.governor.rung
        pack = self._rung_packs.get(rung.name)
        if pack is None:
            pack = self._pack_fn(rung.spec)
            self._rung_packs[rung.name] = pack
        self.params = pack
        self.numerics = rung.name
        self.metrics.numerics = rung.name
        # the new rung's tokens attribute to ITS power profile from here on
        self._register_power_profile()
        self.metrics.governor_switches += 1
        if decision.action == "escalate":
            self.metrics.governor_escalations += 1
        else:
            self.metrics.governor_relaxes += 1
        if self.tracer is not None:
            self.tracer.record("governor_switch", step=self._steps,
                               **decision.to_dict())

    def _register_power_profile(self) -> None:
        """Profile the LIVE pack (cached per numerics label) and register
        it with the metrics' power attribution."""
        label = self.numerics or "unknown"
        prof = self._power_profiles.get(label)
        if prof is None:
            prof = power_profile_from_params(self.params)
            self._power_profiles[label] = prof
        self.metrics.set_power_profile(label, prof)

    def _dispatch(self, params, batch: ScheduledBatch,
                  tables=None) -> torch.Tensor:
        """Run the slot step under ``params``; the cache is updated in
        place.  ``tables`` are the paged layout's block tables."""
        dev = self.api.device
        tokens = torch.as_tensor(batch.tokens, dtype=torch.long, device=dev)
        self._shapes.add((id(params), tuple(tokens.shape)))
        if tables is None:
            logits, _ = self.api.decode_slots(params, tokens, self.pool.cache,
                                              batch.n_valid)
        else:
            logits, _ = self.api.decode_slots(
                params, tokens, self.pool.cache, batch.n_valid,
                block_tables=tables, kv_len=self.ecfg.max_len)
        return logits

    # -- speculative rounds (repro_torch.serving.speculative) ----------------

    def _speculative_step(self, rnd) -> list[Request]:
        """One draft-and-verify round: up to ``rnd.max_k`` thin calls with
        the draft parameters, a rollback to the pre-draft cursors, ONE
        chunk-shaped call with the exact parameters over the verify rows
        (prompt chunks and budget-exhausted decoders ride along), then
        longest-agreeing-prefix emission and the final cursors."""
        tr = self.tracer
        self.metrics.start_clock()
        ch = self.ecfg.prefill_chunk
        tables = None
        if self._paged:
            # one copy-on-write barrier for the whole round: prompt chunks,
            # draft writes [L, L+k) and verify writes [L, L+k] land in
            # blocks made uniquely owned here (a rollback never remaps)
            cow0 = self.pool.cow_copies
            for r in rnd.prefilling:
                self.pool.ensure_writable(
                    r.slot, min(ch, r.prompt_len - r.prefilled))
            for row in rnd.spec_rows:
                self.pool.ensure_writable(row.req.slot, row.k_eff + 1)
            for r in rnd.plain:
                self.pool.ensure_writable(r.slot, 1)
            self.pool.flush_copies()
            if tr is not None and self.pool.cow_copies > cow0:
                tr.record("cow_copy", copies=self.pool.cow_copies - cow0)
            tables = self.pool.block_tables_array()
        base = self.pool.lengths()

        t_d0 = time.perf_counter()
        max_k = rnd.max_k
        for i in range(max_k):
            db = self.scheduler.draft_batch(rnd, i)
            logits = self._dispatch(self.draft_params, db, tables)
            toks = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
            speculative.record_drafts(rnd, i, toks)
        t_d1 = time.perf_counter()
        if max_k:
            # the draft K/V above each base cursor is approximate: retreat
            # the cursors; the verify call overwrites those positions
            self.pool.set_lengths(base)

        vb = self.scheduler.verify_batch(rnd)
        probe_due = self._probe_due()
        t_v0 = time.perf_counter()
        logits = self._dispatch(self.params, vb, tables)
        t_v1 = time.perf_counter()
        (finished, emitted, prompt_toks,
         drafted, accepted) = self._spec_postprocess(rnd, vb, logits)

        # final cursors: base + n_valid for prefill and plain rows, base +
        # emitted for verify rows (rejected positions stay masked until
        # overwritten); this also keeps the paged host mirror in step
        final = base.copy()
        for r, kind in zip(vb.rows, vb.row_kinds):
            if kind != "verify":
                final[r.slot] = base[r.slot] + int(vb.n_valid[r.slot])
        for row in rnd.spec_rows:
            final[row.req.slot] = base[row.req.slot] + row.emitted
        self.pool.set_lengths(final)
        if tr is not None:
            for r, kind in zip(vb.rows, vb.row_kinds):
                if kind != "verify":
                    tr.record("prefill_chunk" if kind == "prefill"
                              else "decode_step", rid=r.rid, t=t_v0,
                              dur=t_v1 - t_v0, slot=r.slot,
                              n_valid=int(vb.n_valid[r.slot]))
            for row in rnd.spec_rows:
                tr.record("draft", rid=row.req.rid, t=t_d0,
                          dur=t_d1 - t_d0, slot=row.req.slot, k=row.k_eff)
                tr.record("verify", rid=row.req.rid, t=t_v0,
                          dur=t_v1 - t_v0, slot=row.req.slot,
                          drafted=row.k_eff, accepted=row.accepted,
                          emitted=row.emitted)
            self._trace_finished(finished)
        self.metrics.record_step(
            "spec" if rnd.spec_rows else ("mixed" if rnd.plain else "prefill"),
            self.pool.occupancy, len(self.queue),
            prompt_tokens=prompt_toks, generated_tokens=emitted,
            block_stats=self._windowed_block_stats() if self._paged else None,
            drafted=drafted, accepted=accepted, draft_calls=max_k)
        self._steps += 1
        if probe_due:
            # a verify row against the exact path: under speculation the
            # served parameters ARE exact, so this reports the noise floor
            self._run_probe(vb, base, tables)
        return finished

    def _spec_postprocess(self, rnd, vb: ScheduledBatch, logits):
        """Per-row advance of a verify call: prefill and plain rows as in
        :meth:`_postprocess`; verify rows emit their accepted prefix plus
        the correction token one at a time through the stop check, so a
        drafted-but-rejected eos never finishes a request.  Returns
        ``(finished, generated, prompt_tokens, drafted, accepted)``."""
        finished: list[Request] = []
        emitted = prompt_toks = drafted = accepted = 0
        toks = torch.argmax(logits, dim=-1).cpu().numpy()  # (slots, C)
        for r, kind in zip(vb.rows, vb.row_kinds):
            if kind == "prefill":
                n = int(vb.n_valid[r.slot])
                r.prefilled += n
                prompt_toks += n
                if self._paged:
                    self.pool.register_prefix(r.slot, r.prompt_len,
                                              r.prefilled)
                if r.prefilled < r.prompt_len:
                    if r.deadline_expired:
                        r.finish_reason = "deadline"
                        self.metrics.requests_deadline_expired += 1
                        finished.append(self._finish(r))
                    continue
                r.state = RequestState.DECODE
                self._emit_row(r, int(toks[r.slot, n - 1]), finished,
                               first=True)
                emitted += 1
            elif kind == "decode":
                self._emit_row(r, int(toks[r.slot, 0]), finished,
                               first=False)
                emitted += 1
        for row in rnd.spec_rows:
            r = row.req
            candidates = speculative.accept(row, toks[r.slot])
            drafted += row.k_eff
            accepted += row.accepted
            for tok in candidates:
                self._emit_row(r, tok, finished, first=False)
                row.emitted += 1
                emitted += 1
                if r.state == RequestState.FINISHED:
                    break  # candidates past the stop are dropped
        return finished, emitted, prompt_toks, drafted, accepted

    def _windowed_block_stats(self) -> dict:
        """Pool block statistics with the cumulative counters rebased to
        the current metrics window."""
        stats = self.pool.block_stats()
        base = self._block_baseline
        return {**stats,
                "cow_copies": stats["cow_copies"] - base["cow_copies"],
                "prefix_evictions": (stats["prefix_evictions"]
                                     - base["prefix_evictions"])}

    def run(self, max_steps: int | None = None) -> list[Request]:
        """Drive until idle (or ``max_steps``); returns finished requests."""
        finished: list[Request] = []
        steps = 0
        while not self.idle:
            finished.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return finished

    # -- replica handle ------------------------------------------------------
    # What a FleetRouter (repro_torch.serving.fleet) drives a replica
    # through; everything crossing it is plain data (token lists, dicts,
    # host tensors).

    def drain(self, max_steps: int | None = None) -> list[Request]:
        return self.run(max_steps)

    def load(self) -> dict:
        """Routing-facing load signal: the backlog by phase, slot
        pressure, and the mean TTFT so far (None before the first)."""
        ttfts = self.metrics.ttfts
        return {**self.scheduler.backlog(self.queue, self.active),
                "slots": self.ecfg.slots, "slots_free": self.pool.n_free,
                "ttft_mean_s": ttfts.mean if len(ttfts) else None}

    def snapshot(self) -> dict:
        return self.metrics.snapshot()

    def export_prefix(self) -> list[tuple[bytes, dict]]:
        """This replica's prefix-cache entries, (chain hash, host block
        content), for adoption by a colder replica ([] unless paged)."""
        if not self._paged:
            return []
        return self.pool.export_prefix_entries()

    def import_prefix(self, entries) -> int:
        """Adopt prefix entries another replica exported; returns the
        blocks imported (0 on the contiguous layout)."""
        if not self._paged or not entries:
            return 0
        imported = self.pool.import_prefix_entries(entries)
        if imported:
            self.metrics.prefix_imports += imported
            if self.tracer is not None:
                self.tracer.record("prefix_import", blocks=imported)
        return imported

    def compile_count(self) -> int:
        """Distinct (parameter tree, token shape) pairs dispatched so far:
        the port has no jit, so this counts what the reference's jit cache
        holds — 2 for every layout, speculation included (draft
        parameters x thin, exact parameters x chunk)."""
        return len(self._shapes)

    def reset_metrics(self) -> None:
        """Fresh counters (after a warm-up, say) that keep the engine's
        numerics labels; the paged pool's cumulative counters are rebased
        so the next snapshot covers one window."""
        self.metrics = self._new_metrics()
        self._bridge_window_samples()
        self._register_power_profile()
        if self._paged:
            self.pool.reset_peak_blocks()
            self._block_baseline = self.pool.block_stats()

    # -- postprocessing ------------------------------------------------------

    def _postprocess(self, batch: ScheduledBatch,
                     logits: torch.Tensor) -> tuple[list[Request], int, int]:
        """Per-row advance for every batch kind.  Row b's next token is at
        logits column ``n_valid[b] - 1``; decode rows always emit, prefill
        rows only on the chunk that completes their prompt.  Returns
        ``(finished, generated_tokens, prompt_tokens)``."""
        finished: list[Request] = []
        emitted = prompt_toks = 0
        emitting = any(
            kind == "decode"
            or r.prefilled + int(batch.n_valid[r.slot]) >= r.prompt_len
            for r, kind in zip(batch.rows, batch.row_kinds))
        toks = None
        if emitting:
            # gather each row's one needed column before the argmax, and
            # ship only (slots,) token ids to the host
            cols = torch.as_tensor(np.maximum(batch.n_valid - 1, 0),
                                   dtype=torch.long, device=logits.device)
            rows = torch.arange(logits.shape[0], device=logits.device)
            toks = torch.argmax(logits[rows, cols], dim=-1).cpu().numpy()
        for r, kind in zip(batch.rows, batch.row_kinds):
            if kind == "prefill":
                n = int(batch.n_valid[r.slot])
                r.prefilled += n
                prompt_toks += n
                if self._paged:
                    # publish newly full prompt blocks as they fill
                    self.pool.register_prefix(r.slot, r.prompt_len,
                                              r.prefilled)
                if r.prefilled < r.prompt_len:
                    if r.deadline_expired:
                        # blown mid-prompt: stop before more prefill
                        r.finish_reason = "deadline"
                        self.metrics.requests_deadline_expired += 1
                        finished.append(self._finish(r))
                    continue
                r.state = RequestState.DECODE
                self._emit_row(r, int(toks[r.slot]), finished, first=True)
            else:
                self._emit_row(r, int(toks[r.slot]), finished, first=False)
            emitted += 1
        return finished, emitted, prompt_toks

    def _emit_row(self, r: Request, tok: int, finished: list[Request],
                  first: bool) -> None:
        gap = r.emit(tok)
        if first:
            self.metrics.record_first_token(r)
        self.metrics.record_itl(gap)
        if self._done(r, tok):
            finished.append(self._finish(r))

    def _done(self, r: Request, tok: int) -> bool:
        """Stop check; records ``finish_reason`` (deadline, then length,
        then eos)."""
        if r.deadline_expired:
            r.finish_reason = "deadline"
            self.metrics.requests_deadline_expired += 1
            return True
        if len(r.generated) >= r.max_new_tokens:
            r.finish_reason = "length"
            return True
        if r.eos_id is not None and tok == r.eos_id:
            r.finish_reason = "eos"
            return True
        return False

    def _finish(self, r: Request) -> Request:
        r.state = RequestState.FINISHED
        r.t_finish = time.perf_counter()
        self.pool.release(r.slot)
        del self.active[r.slot]
        self.metrics.record_finish(r)
        return r
