"""Slot scheduler: admission + fixed-shape batch construction (port of
``repro.serving.scheduler``, plain path).

Every engine iteration is one of two shapes:

  * chunk-shaped ``(slots, prefill_chunk)`` — the next chunk of every
    prefilling request, and (``mixed=True``) every decoding request riding
    the same call with ``n_valid = 1``;
  * decode ``(slots, 1)`` — the last token of every decoding request, used
    whenever no prefill work pends (the kernels' thin-M tiles).

Rows of idle slots carry ``n_valid = 0`` and do not move their cursor.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.request import Request, RequestQueue, RequestState


@dataclasses.dataclass
class ScheduledBatch:
    """One fixed-shape engine iteration."""

    kind: str  # "prefill" | "decode" | "mixed" (chunk-shaped, both kinds)
    tokens: np.ndarray  # (slots, C) int32
    n_valid: np.ndarray  # (slots,) int32
    rows: list[Request]  # participating requests (their .slot indexes rows)
    row_kinds: list[str]  # per entry of rows: "prefill" | "decode"


class SlotScheduler:
    def __init__(self, slots: int, prefill_chunk: int,
                 interleave: bool = True, mixed: bool = True) -> None:
        self.slots = slots
        self.prefill_chunk = prefill_chunk
        self.interleave = interleave
        self.mixed = mixed
        self._prefill_turn = True  # alternation state when both kinds pend

    def admit(self, queue: RequestQueue, pool,
              active: dict[int, Request]) -> list[Request]:
        """Move queued requests into free slots (priority, then FIFO)."""
        admitted = []
        while len(queue) and pool.n_free:
            req = queue.peek()
            slot = pool.acquire_for(req)
            if slot is None:
                break
            queue.pop()
            req.slot = slot
            req.prefilled = 0
            req.state = RequestState.PREFILL
            active[slot] = req
            admitted.append(req)
        return admitted

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
