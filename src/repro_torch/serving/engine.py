"""The continuous-batching serving engine (port of
``repro.serving.engine``, plain path).

``submit()`` runs admission control (with priority eviction from a full
queue) and enqueues; ``step()`` admits into free slots, asks the scheduler
for one fixed-shape batch — chunk-shaped with mixed prefill+decode rows
when both kinds pend, thin ``(slots, 1)`` otherwise — runs the model's slot
step (which updates the pooled KV cache in place), and advances every
participating request through one per-row postprocess.

Numerics live in the parameters (``repro_torch.launch.serve.
build_serving_params``): the same engine serves float, exact-int8 and
approximate+CV packs.  Generation is greedy (argmax).  Speculative decode,
the error probe, the governor, quarantine, shadow serving, paged KV and
power attribution are later slices.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, EngineConfig
from repro_torch.models.registry import ModelApi, build_model
from repro_torch.serving.kv_pool import SlotPool
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.request import (AdmissionController, Request,
                                         RequestQueue, RequestState)
from repro_torch.serving.scheduler import ScheduledBatch, SlotScheduler


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig = EngineConfig(),
                 api: ModelApi | None = None, numerics: str | None = None,
                 device=None) -> None:
        """``device`` defaults to ``cuda`` and raises without a card; pass
        ``device="cpu"`` (or an ``api`` built for it) to serve on the CPU."""
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
        self.pool = SlotPool(self.api, ecfg.slots, ecfg.max_len,
                             ecfg.cache_dtype)
        self.queue = RequestQueue()
        self.admission = AdmissionController(ecfg.max_queue, ecfg.max_len,
                                             ecfg.prefill_chunk)
        self.scheduler = SlotScheduler(ecfg.slots, ecfg.prefill_chunk,
                                       ecfg.interleave, ecfg.mixed_batches)
        self.metrics = EngineMetrics(numerics=numerics)
        self.active: dict[int, Request] = {}
        self._rid = itertools.count()

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, priority: int = 0,
               eos_id: int | None = None,
               on_token: Callable | None = None) -> Request:
        """Admission-checked enqueue; returns the Request (maybe REJECTED)."""
        req = Request(rid=next(self._rid), prompt=[int(t) for t in prompt],
                      max_new_tokens=int(max_new_tokens), priority=priority,
                      eos_id=eos_id, on_token=on_token)
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
        """One engine iteration; returns the requests that finished in it."""
        self.scheduler.admit(self.queue, self.pool, self.active)
        batch = self.scheduler.next_batch(self.active)
        if batch is None:
            return []
        # arm the throughput clock before the first served dispatch
        self.metrics.start_clock()
        logits = self._dispatch(self.params, batch)
        finished, emitted, prompt_toks = self._postprocess(batch, logits)
        self.metrics.record_step(batch.kind, self.pool.occupancy,
                                 len(self.queue), prompt_tokens=prompt_toks,
                                 generated_tokens=emitted)
        return finished

    def _dispatch(self, params, batch: ScheduledBatch) -> torch.Tensor:
        """Run the slot step; the pooled cache is updated in place."""
        dev = self.api.device
        logits, _ = self.api.decode_slots(
            params, torch.as_tensor(batch.tokens, dtype=torch.long, device=dev),
            self.pool.cache, batch.n_valid)
        return logits

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

    def snapshot(self) -> dict:
        return self.metrics.snapshot()

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
                if r.prefilled < r.prompt_len:
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
        """Stop check; records ``finish_reason`` (length before eos)."""
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
