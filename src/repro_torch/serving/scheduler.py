"""Slot scheduler: admission + fixed-shape batch construction (port of
``repro.serving.scheduler``, plain path).

Every engine iteration is one of two shapes:

  * chunk-shaped ``(slots, prefill_chunk)`` — the next chunk of every
    prefilling request, and (``mixed=True``) every decoding request riding
    the same call with ``n_valid = 1``;
  * decode ``(slots, 1)`` — the last token of every decoding request, used
    whenever no prefill work pends (the kernels' thin-M tiles).

Rows of idle slots carry ``n_valid = 0`` and do not move their cursor.
Under speculative decode a round is thin draft calls (``draft_batch``)
and one chunk-shaped verify call (``verify_batch``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serving.request import Request, RequestQueue, RequestState


@dataclasses.dataclass
class ScheduledBatch:
    """One fixed-shape engine iteration."""

    #: "prefill" | "decode" | "mixed" (chunk-shaped, both row kinds) |
    #: "draft" (thin speculative draft call) | "spec" (chunk-shaped verify)
    kind: str
    tokens: np.ndarray  # (slots, C) int32
    n_valid: np.ndarray  # (slots,) int32
    rows: list[Request]  # participating requests (their .slot indexes rows)
    #: per entry of rows: "prefill" | "decode" | "draft" | "verify" (a
    #: decoding request's [last token, drafts...] row, n_valid = k_eff + 1)
    row_kinds: list[str]


class SlotScheduler:
    def __init__(self, slots: int, prefill_chunk: int,
                 interleave: bool = True, mixed: bool = True) -> None:
        self.slots = slots
        self.prefill_chunk = prefill_chunk
        self.interleave = interleave
        self.mixed = mixed
        self._prefill_turn = True  # alternation state when both kinds pend

    def purge_expired(self, queue: RequestQueue, metrics=None,
                      tracer=None) -> list[Request]:
        """Finish every queued request whose deadline passed, before it
        takes a slot (``finish_reason`` "deadline"; an ``evicted`` span
        with reason ``deadline`` each)."""
        expired = queue.purge(lambda r: r.deadline_expired)
        for r in expired:
            r.state = RequestState.FINISHED
            r.finish_reason = "deadline"
            r.t_finish = time.perf_counter()
            if metrics is not None:
                metrics.requests_deadline_expired += 1
            if tracer is not None:
                tracer.record("evicted", rid=r.rid, reason="deadline",
                              deadline_ms=r.deadline_ms)
        return expired

    def admit(self, queue: RequestQueue, pool, active: dict[int, Request],
              metrics=None, tracer=None) -> list[Request]:
        """Move queued requests into free slots (priority, then FIFO).  The
        head is placed before it is popped: when the pool lacks a slot or
        (paged) blocks it keeps its place and the iteration counts as a
        ``no_capacity_stalls`` sample.  A prefix-cache hit enters prefill
        with ``prefix_hit_tokens`` of its prompt done.  ``tracer`` gets an
        ``admitted`` span a placement (with its queue wait) and a
        ``capacity_stall`` span a stalled iteration."""
        admitted = []
        stalled = False
        while len(queue):
            if not pool.n_free:
                stalled = True
                break
            req = queue.peek()
            slot = pool.acquire_for(req)
            if slot is None:
                stalled = True
                break
            queue.pop()
            req.slot = slot
            req.prefilled = req.prefix_hit_tokens
            req.state = RequestState.PREFILL
            active[slot] = req
            admitted.append(req)
            if tracer is not None:
                tracer.record(
                    "admitted", rid=req.rid, slot=slot,
                    queue_wait_s=round(
                        time.perf_counter() - req.t_queued_mono, 6))
        if stalled:
            if metrics is not None:
                metrics.no_capacity_stalls += 1
            if tracer is not None:
                head = queue.peek()
                tracer.record("capacity_stall",
                              rid=head.rid if head else None,
                              queued=len(queue))
        return admitted

    def backlog(self, queue: RequestQueue,
                active: dict[int, Request]) -> dict:
        """Pending work by phase: queued, prefilling, decoding, and their
        sum."""
        prefilling = sum(r.state == RequestState.PREFILL
                         for r in active.values())
        decoding = sum(r.state == RequestState.DECODE
                       for r in active.values())
        return {"queued": len(queue), "prefilling": prefilling,
                "decoding": decoding,
                "pending": len(queue) + prefilling + decoding}

    def next_batch(self, active: dict[int, Request]) -> ScheduledBatch | None:
        prefilling = [r for r in active.values()
                      if r.state == RequestState.PREFILL]
        decoding = [r for r in active.values()
                    if r.state == RequestState.DECODE]
        if not prefilling and not decoding:
            return None
        if prefilling and decoding:
            if self.mixed:
                return self._chunk_batch(prefilling, decoding)
            do_prefill = self._prefill_turn if self.interleave else True
            self._prefill_turn = not self._prefill_turn
        else:
            do_prefill = bool(prefilling)
        if do_prefill:
            return self._chunk_batch(prefilling, [])
        return self._decode_batch(decoding)

    def _chunk_batch(self, prefilling: list[Request],
                     decoding: list[Request]) -> ScheduledBatch:
        ch = self.prefill_chunk
        tokens = np.zeros((self.slots, ch), np.int32)
        n_valid = np.zeros((self.slots,), np.int32)
        for r in prefilling:
            n = min(ch, r.prompt_len - r.prefilled)
            tokens[r.slot, :n] = r.prompt[r.prefilled: r.prefilled + n]
            n_valid[r.slot] = n
        for r in decoding:
            tokens[r.slot, 0] = r.generated[-1]
            n_valid[r.slot] = 1
        return ScheduledBatch("mixed" if decoding else "prefill", tokens,
                              n_valid, prefilling + decoding,
                              ["prefill"] * len(prefilling)
                              + ["decode"] * len(decoding))

    def _decode_batch(self, decoding: list[Request]) -> ScheduledBatch:
        tokens = np.zeros((self.slots, 1), np.int32)
        n_valid = np.zeros((self.slots,), np.int32)
        for r in decoding:
            tokens[r.slot, 0] = r.generated[-1]
            n_valid[r.slot] = 1
        return ScheduledBatch("decode", tokens, n_valid, decoding,
                              ["decode"] * len(decoding))

    # -- speculative rounds (repro_torch.serving.speculative) -------------

    def draft_batch(self, rnd, i: int) -> ScheduledBatch:
        """Thin ``(slots, 1)`` draft call ``i`` of a speculative round: the
        spec rows still inside their ``k_eff``; every other row pads."""
        from repro_torch.serving.speculative import draft_inputs

        tokens, n_valid = draft_inputs(rnd, self.slots, i)
        rows = [row.req for row in rnd.spec_rows if i < row.k_eff]
        return ScheduledBatch("draft", tokens, n_valid, rows,
                              ["draft"] * len(rows))

    def verify_batch(self, rnd) -> ScheduledBatch:
        """The round's one chunk-shaped exact call: prompt chunks
        ("prefill"), ``[last token, d_1..d_k]`` rows with ``n_valid =
        k_eff + 1`` ("verify") and budget-exhausted decoders as ``n_valid =
        1`` rows ("decode"), so the exact parameters never run the thin
        shape."""
        ch = self.prefill_chunk
        tokens = np.zeros((self.slots, ch), np.int32)
        n_valid = np.zeros((self.slots,), np.int32)
        rows: list[Request] = []
        kinds: list[str] = []
        for r in rnd.prefilling:
            n = min(ch, r.prompt_len - r.prefilled)
            tokens[r.slot, :n] = r.prompt[r.prefilled: r.prefilled + n]
            n_valid[r.slot] = n
            rows.append(r)
            kinds.append("prefill")
        for row in rnd.spec_rows:
            r = row.req
            seq = [r.generated[-1]] + row.drafts
            tokens[r.slot, :len(seq)] = seq
            n_valid[r.slot] = len(seq)
            rows.append(r)
            kinds.append("verify")
        for r in rnd.plain:
            tokens[r.slot, 0] = r.generated[-1]
            n_valid[r.slot] = 1
            rows.append(r)
            kinds.append("decode")
        return ScheduledBatch("spec", tokens, n_valid, rows, kinds)
