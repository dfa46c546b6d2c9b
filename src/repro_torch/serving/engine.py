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
parameters verifies, and only verifier tokens are emitted.  The error
probe, the governor, quarantine, shadow serving, the fleet and power
attribution are later slices.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, EngineConfig
from repro_torch.models.registry import ModelApi, build_model
from repro_torch.serving import speculative
from repro_torch.serving.kv_pool import SlotPool
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.request import (AdmissionController, Request,
                                         RequestQueue, RequestState)
from repro_torch.serving.scheduler import ScheduledBatch, SlotScheduler


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig = EngineConfig(),
                 api: ModelApi | None = None, numerics: str | None = None,
                 device=None, draft_params=None,
                 draft_numerics: str | None = None) -> None:
        """``device`` defaults to ``cuda`` and raises without a card; pass
        ``device="cpu"`` (or an ``api`` built for it) to serve on the CPU.
        ``params`` serve (and, under speculation, verify); ``draft_params``
        draft when ``ecfg.speculative_k > 0``."""
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.api = api or build_model(cfg, device)
        if self.api.init_slot_cache is None or self.api.decode_slots is None:
            raise NotImplementedError(
                f"{cfg.name}: the continuous-batching engine does not serve "
                "this arch yet (no slot cache); use the lock-step path "
                "(`python -m repro_torch.launch.serve --legacy`)")
        self.numerics = numerics
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
        self.metrics = self._new_metrics()
        self.active: dict[int, Request] = {}
        self._rid = itertools.count()
        #: (parameter tree, token shape) pairs dispatched: the counterpart
        #: of the reference's jit cache (:meth:`compile_count`)
        self._shapes: set[tuple[int, tuple[int, ...]]] = set()

    def _new_metrics(self) -> EngineMetrics:
        return EngineMetrics(
            numerics=self.numerics, kv_layout=self.ecfg.kv_layout,
            speculative_k=self._spec_k,
            draft_numerics=self.draft_numerics if self._spec_k else None)

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
        ok, reason, evicted = self.admission.admit(self.queue, req)
        if not ok:
            req.state = RequestState.REJECTED
            req.reject_reason = reason
            self.metrics.rejected += 1
            return req
        if evicted is not None:
            evicted.state = RequestState.REJECTED
            evicted.reject_reason = (f"evicted from full queue by "
                                     f"higher-priority request {req.rid}")
            self.metrics.rejected += 1
            self.metrics.evicted += 1
        self.queue.push(req)
        return req

    # -- engine loop ---------------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self.active and not len(self.queue)

    def step(self) -> list[Request]:
        """One engine iteration; returns the requests that finished in it
        (queued requests whose deadline passed included)."""
        expired = self.scheduler.purge_expired(self.queue, self.metrics)
        admitted = self.scheduler.admit(self.queue, self.pool, self.active,
                                        self.metrics)
        for r in admitted:
            if r.prefix_hit_tokens:
                self.metrics.prefix_hits += 1
                self.metrics.prefix_hit_tokens += r.prefix_hit_tokens
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
        tables = None
        if self._paged:
            # copy-on-write barrier: every block this batch writes is
            # uniquely owned before the step runs
            for slot, nv in enumerate(batch.n_valid):
                self.pool.ensure_writable(slot, int(nv))
            self.pool.flush_copies()
            tables = self.pool.block_tables_array()
        logits = self._dispatch(self.params, batch, tables)
        if self._paged:
            self.pool.advance(batch.n_valid)
        finished, emitted, prompt_toks = self._postprocess(batch, logits)
        self.metrics.record_step(
            batch.kind, self.pool.occupancy, len(self.queue),
            prompt_tokens=prompt_toks, generated_tokens=emitted,
            block_stats=self._windowed_block_stats() if self._paged else None)
        return expired + finished

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
        self.metrics.start_clock()
        ch = self.ecfg.prefill_chunk
        tables = None
        if self._paged:
            # one copy-on-write barrier for the whole round: prompt chunks,
            # draft writes [L, L+k) and verify writes [L, L+k] land in
            # blocks made uniquely owned here (a rollback never remaps)
            for r in rnd.prefilling:
                self.pool.ensure_writable(
                    r.slot, min(ch, r.prompt_len - r.prefilled))
            for row in rnd.spec_rows:
                self.pool.ensure_writable(row.req.slot, row.k_eff + 1)
            for r in rnd.plain:
                self.pool.ensure_writable(r.slot, 1)
            self.pool.flush_copies()
            tables = self.pool.block_tables_array()
        base = self.pool.lengths()

        max_k = rnd.max_k
        for i in range(max_k):
            db = self.scheduler.draft_batch(rnd, i)
            logits = self._dispatch(self.draft_params, db, tables)
            toks = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
            speculative.record_drafts(rnd, i, toks)
        if max_k:
            # the draft K/V above each base cursor is approximate: retreat
            # the cursors; the verify call overwrites those positions
            self.pool.set_lengths(base)

        vb = self.scheduler.verify_batch(rnd)
        logits = self._dispatch(self.params, vb, tables)
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
        self.metrics.record_step(
            "spec" if rnd.spec_rows else ("mixed" if rnd.plain else "prefill"),
            self.pool.occupancy, len(self.queue),
            prompt_tokens=prompt_toks, generated_tokens=emitted,
            block_stats=self._windowed_block_stats() if self._paged else None,
            drafted=drafted, accepted=accepted, draft_calls=max_k)
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
