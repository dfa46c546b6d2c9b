"""Per-engine serving metrics: the throughput, TTFT and ITL subset of
``repro.serving.metrics``, with the paged layout's block counters (prefix
hits, copy-on-write copies, utilization, capacity stalls), deadline
expiries and the speculative counters (drafted and accepted tokens, the
acceptance rate).

Counters are recorded on the host around each engine iteration.  Latency
samples go through a bounded reservoir (exact count, sum and max; uniform
sample for percentiles).  The throughput clock starts at the first served
batch, so set-up and warm-up before it are not charged.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time

RESERVOIR_CAP = 4096


def _percentile(xs, q: float) -> float:
    """Linear-interpolation percentile (numpy's default method)."""
    ys = sorted(xs)
    if not ys:
        return 0.0
    pos = q * (len(ys) - 1)
    lo = min(int(math.floor(pos)), len(ys) - 1)
    hi = min(lo + 1, len(ys) - 1)
    return ys[lo] + (ys[hi] - ys[lo]) * (pos - lo)


class Reservoir:
    """Bounded uniform sample of a stream with exact n/sum/max
    (Algorithm R, deterministic per-instance RNG)."""

    def __init__(self, cap: int = RESERVOIR_CAP, seed: int = 0x5EED) -> None:
        self.cap = cap
        self.n = 0
        self.total = 0.0
        self._max = float("-inf")
        self.samples: list[float] = []
        self._rng = random.Random(seed)

    def push(self, x: float) -> None:
        x = float(x)
        self.n += 1
        self.total += x
        self._max = max(self._max, x)
        if len(self.samples) < self.cap:
            self.samples.append(x)
        else:
            j = self._rng.randrange(self.n)
            if j < self.cap:
                self.samples[j] = x

    def __len__(self) -> int:
        return self.n

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    @property
    def max(self) -> float:
        return self._max if self.n else 0.0

    def percentile(self, q: float) -> float:
        return _percentile(self.samples, q)


@dataclasses.dataclass
class EngineMetrics:
    numerics: str | None = None
    kv_layout: str = "contiguous"
    #: speculative decode: k and the draft parameters' numerics label
    speculative_k: int = 0
    draft_numerics: str | None = None
    t_start: float | None = None

    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_steps: int = 0
    decode_steps: int = 0
    mixed_steps: int = 0
    spec_rounds: int = 0
    draft_calls: int = 0  # thin draft-parameter dispatches
    drafted_tokens: int = 0
    accepted_draft_tokens: int = 0  # drafts the exact verifier agreed with

    submitted: int = 0
    rejected: int = 0
    evicted: int = 0
    finished: int = 0
    #: iterations whose admission stopped for want of a slot or (paged)
    #: blocks: a delay, not a rejection
    no_capacity_stalls: int = 0
    #: requests that attached to cached prefix blocks, and the prompt
    #: tokens whose prefill that skipped
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0
    requests_retried: int = 0  # queue-full resubmissions (serve CLI)
    requests_deadline_expired: int = 0

    ttfts: Reservoir = dataclasses.field(default_factory=Reservoir)
    itls: Reservoir = dataclasses.field(default_factory=Reservoir)
    latencies: Reservoir = dataclasses.field(default_factory=Reservoir)

    _occupancy_sum: float = 0.0
    _queue_depth_sum: float = 0.0
    _samples: int = 0
    _block_util_sum: float = 0.0
    _block_frag_sum: float = 0.0
    _block_samples: int = 0
    _last_block_stats: dict | None = None

    def start_clock(self) -> None:
        """Arm the throughput clock (idempotent)."""
        if self.t_start is None:
            self.t_start = time.perf_counter()

    def record_step(self, kind: str, occupancy: float, queue_depth: int,
                    prompt_tokens: int = 0, generated_tokens: int = 0,
                    block_stats: dict | None = None, drafted: int = 0,
                    accepted: int = 0, draft_calls: int = 0) -> None:
        self.start_clock()
        if kind == "prefill":
            self.prefill_steps += 1
        elif kind == "mixed":
            self.mixed_steps += 1
        elif kind == "spec":  # draft_calls thin calls + one verify call
            self.spec_rounds += 1
        else:
            self.decode_steps += 1
        self.drafted_tokens += drafted
        self.accepted_draft_tokens += accepted
        self.draft_calls += draft_calls
        if block_stats is not None:
            self._block_util_sum += block_stats["block_util"]
            self._block_frag_sum += block_stats["block_frag"]
            self._block_samples += 1
            self._last_block_stats = block_stats
        self.prompt_tokens += prompt_tokens
        self.generated_tokens += generated_tokens
        self._occupancy_sum += occupancy
        self._queue_depth_sum += queue_depth
        self._samples += 1

    def record_first_token(self, req) -> None:
        if req.ttft is not None:
            self.ttfts.push(req.ttft)

    def record_itl(self, gap: float | None) -> None:
        if gap is not None:
            self.itls.push(gap)

    def record_finish(self, req) -> None:
        self.finished += 1
        if req.t_finish is not None:
            self.latencies.push(req.t_finish - req.t_submit)

    def snapshot(self) -> dict:
        elapsed = (max(time.perf_counter() - self.t_start, 1e-9)
                   if self.t_start is not None else 0.0)
        total = self.prompt_tokens + self.generated_tokens

        def pct(res: Reservoir, q: float):
            return res.percentile(q) if len(res) else None

        blk = self._last_block_stats or {}
        nb = self._block_samples
        return {
            "numerics": self.numerics,
            "kv_layout": self.kv_layout,
            "elapsed_s": elapsed,
            "requests_submitted": self.submitted,
            "requests_finished": self.finished,
            "requests_rejected": self.rejected,
            "requests_evicted": self.evicted,
            "no_capacity_stalls": self.no_capacity_stalls,
            "requests_retried": self.requests_retried,
            "requests_deadline_expired": self.requests_deadline_expired,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "mean_block_utilization": (self._block_util_sum / nb
                                       if nb else None),
            "mean_block_fragmentation": (self._block_frag_sum / nb
                                         if nb else None),
            "block_step_samples": nb,
            "peak_blocks_in_use": blk.get("peak_blocks_in_use"),
            "blocks_total": blk.get("blocks_total"),
            "prefix_cache_entries": blk.get("prefix_cache_entries"),
            "cow_copies": blk.get("cow_copies"),
            "prefix_evictions": blk.get("prefix_evictions"),
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": self.generated_tokens,
            "gen_tok_per_s": self.generated_tokens / elapsed if elapsed else 0.0,
            "total_tok_per_s": total / elapsed if elapsed else 0.0,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "mixed_steps": self.mixed_steps,
            "speculative_k": self.speculative_k or None,
            "draft_numerics": self.draft_numerics,
            "spec_rounds": self.spec_rounds,
            "draft_calls": self.draft_calls,
            "drafted_tokens": self.drafted_tokens,
            "accepted_draft_tokens": self.accepted_draft_tokens,
            "acceptance_rate": (self.accepted_draft_tokens
                                / self.drafted_tokens
                                if self.drafted_tokens else None),
            "ttft_mean_s": self.ttfts.mean if len(self.ttfts) else None,
            "ttft_p50_s": pct(self.ttfts, 0.5),
            "ttft_p95_s": pct(self.ttfts, 0.95),
            "ttft_max_s": self.ttfts.max if len(self.ttfts) else None,
            "itl_p50_s": pct(self.itls, 0.5),
            "itl_p95_s": pct(self.itls, 0.95),
            "itl_max_s": self.itls.max if len(self.itls) else None,
            "latency_mean_s": self.latencies.mean if len(self.latencies) else None,
            "mean_slot_occupancy": (self._occupancy_sum / self._samples
                                    if self._samples else 0.0),
            "mean_queue_depth": (self._queue_depth_sum / self._samples
                                 if self._samples else 0.0),
        }
