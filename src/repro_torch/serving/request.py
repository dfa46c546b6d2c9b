"""Request lifecycle for the continuous-batching engine (port of
``repro.serving.request``).

A :class:`Request` moves QUEUED -> PREFILL -> DECODE -> FINISHED, or is
REJECTED at admission.  A request with a deadline that passes while it is
queued is purged before admission, and one that passes while it runs stops
at its next prefill chunk or emission (``finish_reason`` "deadline", the
partial output kept).  :class:`RequestQueue` orders admission by
(priority, arrival).  :class:`AdmissionController` bounds queue depth and
rejects jobs that can never fit a slot (or, under the paged KV layout, the
whole block pool).
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import time
from typing import Callable


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    """One generation job and its serving telemetry."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    priority: int = 0  # lower = more urgent; FIFO within a class
    eos_id: int | None = None
    #: latency budget in ms from submission; None = no deadline
    deadline_ms: float | None = None
    #: streaming hook, called as on_token(request, token) per token
    on_token: Callable | None = None

    state: RequestState = RequestState.QUEUED
    reject_reason: str | None = None
    #: prompt tokens whose prefill was skipped by attaching to cached
    #: prefix blocks at admission (paged layout); the cursor starts here
    prefix_hit_tokens: int = 0
    #: the prompt's block-hash chain, memoized by the paged pool (a
    #: capacity-stalled admission retries every step)
    block_hashes: list | None = dataclasses.field(default=None, repr=False)
    #: "length" | "eos" | "deadline", recorded when the stop condition fires
    finish_reason: str | None = None
    slot: int | None = None
    prefilled: int = 0  # prompt tokens already processed
    generated: list[int] = dataclasses.field(default_factory=list)

    t_submit: float = dataclasses.field(default_factory=time.perf_counter)
    #: submission stamp on the span tracer's clock (queue waits); the
    #: same clock as ``t_submit`` here, kept as its own field as in the
    #: reference, whose ``t_submit`` is wall-clock time
    t_queued_mono: float = dataclasses.field(
        default_factory=time.perf_counter, repr=False)
    t_first_token: float | None = None
    t_last_token: float | None = None
    t_finish: float | None = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def finished(self) -> bool:
        return self.state == RequestState.FINISHED

    @property
    def deadline_expired(self) -> bool:
        return (self.deadline_ms is not None
                and (time.perf_counter() - self.t_submit) * 1e3
                > self.deadline_ms)

    @property
    def ttft(self) -> float | None:
        """Time to first token (seconds from submit)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    def emit(self, token: int) -> float | None:
        """Record one generated token; returns the inter-token gap in
        seconds (None for the first token)."""
        now = time.perf_counter()
        gap = None if self.t_last_token is None else now - self.t_last_token
        if self.t_first_token is None:
            self.t_first_token = now
        self.t_last_token = now
        self.generated.append(token)
        if self.on_token is not None:
            self.on_token(self, token)
        return gap


class RequestQueue:
    """Priority queue with FIFO order inside each priority class."""

    def __init__(self) -> None:
        self._heap: list[tuple[int, int, Request]] = []
        self._seq = itertools.count()

    def push(self, req: Request) -> None:
        heapq.heappush(self._heap, (req.priority, next(self._seq), req))

    def pop(self) -> Request | None:
        return heapq.heappop(self._heap)[2] if self._heap else None

    def peek(self) -> Request | None:
        return self._heap[0][2] if self._heap else None

    def lowest_priority(self) -> int | None:
        return max(pr for pr, _, _ in self._heap) if self._heap else None

    def evict_lowest(self) -> Request | None:
        """Remove and return the worst queued request (lowest priority
        class, latest arrival within it)."""
        if not self._heap:
            return None
        i = max(range(len(self._heap)),
                key=lambda j: (self._heap[j][0], self._heap[j][1]))
        req = self._heap[i][2]
        self._heap[i] = self._heap[-1]
        self._heap.pop()
        heapq.heapify(self._heap)
        return req

    def purge(self, pred) -> list[Request]:
        """Remove and return every queued request satisfying ``pred``
        (evaluated once per request), keeping the others' order."""
        flagged = [bool(pred(e[2])) for e in self._heap]
        if not any(flagged):
            return []
        gone = [e[2] for e, f in zip(self._heap, flagged) if f]
        self._heap = [e for e, f in zip(self._heap, flagged) if not f]
        heapq.heapify(self._heap)
        return gone

    def __len__(self) -> int:
        return len(self._heap)


class AdmissionController:
    """Bounds queue depth and rejects jobs that cannot fit a slot: a prompt
    rounded up to whole prefill chunks, and prompt + generation, must fit
    the per-slot capacity ``max_len``; under the paged layout
    (``kv_block_size``/``kv_blocks`` set) the job's block need must fit
    the whole pool, or it would stall the queue's head forever."""

    def __init__(self, max_queue: int, max_len: int, prefill_chunk: int,
                 kv_block_size: int | None = None,
                 kv_blocks: int | None = None) -> None:
        self.max_queue = max_queue
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.kv_block_size = kv_block_size
        self.kv_blocks = kv_blocks

    def check(self, queue: RequestQueue, req: Request) -> tuple[bool, str | None]:
        if req.prompt_len == 0:
            return False, "empty prompt"
        if req.max_new_tokens < 1:
            return False, "max_new_tokens must be >= 1"
        if len(queue) >= self.max_queue:
            worst = queue.lowest_priority()
            if worst is None or worst <= req.priority:
                return False, f"queue full ({self.max_queue})"
        ch = self.prefill_chunk
        padded = ((req.prompt_len + ch - 1) // ch) * ch
        if padded > self.max_len:
            return False, (f"prompt of {req.prompt_len} (padded {padded}) "
                           f"exceeds slot capacity {self.max_len}")
        if req.prompt_len + req.max_new_tokens > self.max_len:
            return False, (f"prompt+generation {req.prompt_len}+"
                           f"{req.max_new_tokens} exceeds slot capacity "
                           f"{self.max_len}")
        if self.kv_blocks is not None:
            bs = self.kv_block_size
            need = (req.prompt_len + req.max_new_tokens + bs - 1) // bs
            if need > self.kv_blocks:
                return False, (f"needs {need} KV blocks; the pool holds "
                               f"{self.kv_blocks}")
        return True, None

    def admit(self, queue: RequestQueue,
              req: Request) -> tuple[bool, str | None, Request | None]:
        """:meth:`check` plus queue-full eviction of strictly
        lower-priority work; returns ``(ok, reason, evicted)``."""
        ok, reason = self.check(queue, req)
        if not ok:
            return False, reason, None
        evicted = queue.evict_lowest() if len(queue) >= self.max_queue else None
        return True, None, evicted
