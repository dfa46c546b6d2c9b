"""Self-verifying speculative decode (port of
``repro.serving.speculative``): the approximate pack drafts, the exact pack
verifies.

One checkpoint is packed twice: a perforated+CV pack (``serve-default``;
on ``backend: "pallas"`` each draft step runs the approx kernel's split-K
decode launch) proposes greedy tokens, and an exact-int8 pack verifies
them.  The emitted stream is bit-identical to exact greedy decode, and the
draft acceptance rate measures what the CV buys at the argmax.

One round, per decoding slot (``x`` its last emitted token, cursor ``L``):

1. plan: ``k_eff = min(k, budget - 1, chunk - 1)``; a slot with no draft
   budget rides the verify call as a plain ``n_valid = 1`` row;
2. draft: ``max(k_eff)`` thin ``(slots, 1)`` calls with the DRAFT params,
   each feeding the previous greedy output, writing approximate K/V at
   ``[L, L + k)``;
3. rollback: the cursors return to ``L`` (a pure cursor move,
   ``models.lm.rollback_slots``);
4. verify: ONE chunk-shaped call with the EXACT params over ``[x, d_1 ..
   d_k]`` (prompt chunks and plain rows ride along), overwriting ``[L, L +
   k]`` with exact K/V;
5. accept: the longest prefix with ``v_i == d_i`` plus the verifier's
   correction token, emitted one at a time through the stop check (a
   drafted eos that the verifier rejects is never seen), and the cursor
   set to ``L`` + emitted.

The exact parameters only ever run the chunk shape and the draft
parameters the thin one, so the engine sees two (parameters, shape) pairs
per layout, as without speculation.  This module is host-side planning
and acceptance; the engine dispatches and the scheduler builds batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.request import Request, RequestState

__all__ = ["SpecRow", "SpecRound", "plan_round", "draft_inputs",
           "record_drafts", "accept"]


@dataclasses.dataclass
class SpecRow:
    """One decoding slot's state across a single speculative round."""

    req: Request
    k_eff: int  # draft tokens this round (>= 1)
    drafts: list[int] = dataclasses.field(default_factory=list)
    #: longest agreeing draft prefix (the acceptance metric counts this,
    #: whatever the stop check truncates)
    accepted: int = 0
    #: tokens actually emitted; the final cursor is base + emitted
    emitted: int = 0


@dataclasses.dataclass
class SpecRound:
    """One iteration's roles: prompt chunks, drafting rows, and decoders
    with no draft budget (plain ``n_valid = 1`` rows of the verify call)."""

    prefilling: list[Request]
    spec_rows: list[SpecRow]
    plain: list[Request]

    @property
    def max_k(self) -> int:
        return max((row.k_eff for row in self.spec_rows), default=0)


def plan_round(active: dict[int, Request], k: int,
               prefill_chunk: int) -> SpecRound | None:
    """Partition the active requests into this round's roles; None when
    nothing is runnable.  The ``budget - 1`` cap keeps the round's
    emissions within the generation budget and every draft cursor below
    ``max_len`` (and inside the paged layout's reserved blocks); the chunk
    cap fits ``[x, d_1..d_k]`` in one verify row."""
    prefilling = [r for r in active.values()
                  if r.state == RequestState.PREFILL]
    decoding = [r for r in active.values()
                if r.state == RequestState.DECODE]
    if not prefilling and not decoding:
        return None
    spec_rows: list[SpecRow] = []
    plain: list[Request] = []
    for r in decoding:
        budget = r.max_new_tokens - len(r.generated)
        k_eff = min(k, budget - 1, prefill_chunk - 1)
        if k_eff >= 1:
            spec_rows.append(SpecRow(r, k_eff))
        else:
            plain.append(r)
    return SpecRound(prefilling, spec_rows, plain)


def draft_inputs(rnd: SpecRound, slots: int,
                 i: int) -> tuple[np.ndarray, np.ndarray]:
    """Tokens and n_valid of draft call ``i``: each drafting row feeds its
    last emitted token (call 0), then its own latest draft; rows done
    drafting and every other slot pad with ``n_valid = 0``."""
    tokens = np.zeros((slots, 1), np.int32)
    n_valid = np.zeros((slots,), np.int32)
    for row in rnd.spec_rows:
        if i < row.k_eff:
            r = row.req
            tokens[r.slot, 0] = row.drafts[-1] if row.drafts else r.generated[-1]
            n_valid[r.slot] = 1
    return tokens, n_valid


def record_drafts(rnd: SpecRound, i: int, toks: np.ndarray) -> None:
    """Append draft call ``i``'s per-slot argmax to each drafting row."""
    for row in rnd.spec_rows:
        if i < row.k_eff:
            row.drafts.append(int(toks[row.req.slot]))


def accept(row: SpecRow, verifier_row: np.ndarray) -> list[int]:
    """Longest-agreeing-prefix acceptance.  ``verifier_row[i]`` is the
    exact model's greedy token after verify input ``i``; returns ``v_1 ..
    v_{j+1}``, the ``j`` accepted drafts plus the correction token, all
    exact-model outputs over accepted exact history."""
    k = row.k_eff
    v = [int(t) for t in verifier_row[:k + 1]]
    j = 0
    while j < k and v[j] == row.drafts[j]:
        j += 1
    row.accepted = j
    return v[:j + 1]
