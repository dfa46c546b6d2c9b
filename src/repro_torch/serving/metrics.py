"""Per-engine serving metrics: the throughput, TTFT and ITL subset of
``repro.serving.metrics``, with the paged layout's block counters (prefix
hits, copy-on-write copies, utilization, capacity stalls), deadline
expiries, the speculative counters (drafted and accepted tokens, the
acceptance rate), the robustness counters (governor switches, injected
and detected faults, quarantine replays), the error probe's Chan-merged
approximate-vs-exact moments and the modeled power attribution.  The
windowed time series of the reference are not ported yet.

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


def _merge_moments(a: tuple[int, float, float],
                   b: tuple[int, float, float]) -> tuple[int, float, float]:
    """Chan's parallel combine of (n, mean, variance) aggregates."""
    na, ma, va = a
    nb, mb, vb = b
    if na == 0:
        return b
    if nb == 0:
        return a
    n = na + nb
    d = mb - ma
    mean = ma + d * nb / n
    m2 = va * na + vb * nb + d * d * na * nb / n
    return n, mean, m2 / n


def merge_layer_moments(*maps: dict) -> dict:
    """Dict-union Chan merge of layer-keyed ``(n, mean, var)`` maps (the
    running probe totals and the governor's per-layer SLO windows):
    associative, and the key union never depends on which map saw a layer
    first."""
    out: dict = {}
    for m in maps:
        for path, mom in m.items():
            out[path] = _merge_moments(out.get(path, (0, 0.0, 0.0)),
                                       tuple(mom))
    return out


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

    # robustness counters (repro_torch.serving.governor, quant.faults):
    # governor pack switches, injected/detected faults and the quarantined
    # rows replayed on the exact pack
    governor_switches: int = 0
    governor_escalations: int = 0
    governor_relaxes: int = 0
    faults_injected: int = 0
    faults_detected: int = 0
    quarantines: int = 0
    quarantine_replays: int = 0

    # error-probe aggregation (repro_torch.quant.error_probe): per-layer
    # and logits-level (n, mean, var) of approximate-vs-exact deltas,
    # Chan-merged across probe runs
    probe_runs: int = 0
    _probe_layers: dict = dataclasses.field(default_factory=dict)
    _probe_logits: tuple = (0, 0.0, 0.0)

    # modeled power attribution: per-numerics-label layer profiles
    # ({path: {mac_per_token, saving_pct}}, from the live pack) joined
    # against the tokens served under each label, so a governor hot-swap
    # splits the attribution between rungs
    power_profiles: dict = dataclasses.field(default_factory=dict)
    _tokens_by_numerics: dict = dataclasses.field(default_factory=dict)

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
        if prompt_tokens or generated_tokens:
            # served tokens attribute to the numerics label active now
            label = self.numerics or "unknown"
            self._tokens_by_numerics[label] = (
                self._tokens_by_numerics.get(label, 0)
                + prompt_tokens + generated_tokens)
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

    # -- approximation-error probe -------------------------------------------

    def record_probe(self, report: dict) -> None:
        """Fold one :class:`~repro_torch.quant.error_probe.ErrorProbe`
        report (per-layer + logits ``{n, mean, var}``) into the running
        per-layer moments."""
        self.probe_runs += 1
        for path, st in report.get("layers", {}).items():
            self._probe_layers[path] = _merge_moments(
                self._probe_layers.get(path, (0, 0.0, 0.0)),
                (st["n"], st["mean"], st["var"]))
        lg = report.get("logits")
        if lg is not None:
            self._probe_logits = _merge_moments(
                self._probe_logits, (lg["n"], lg["mean"], lg["var"]))

    def _probe_snapshot(self) -> dict | None:
        if not self.probe_runs and not self._probe_layers:
            return None
        layers = {path: {"n": n, "err_mean": mean, "err_var": var}
                  for path, (n, mean, var)
                  in sorted(self._probe_layers.items())}
        lvars = [st["err_var"] for st in layers.values()]
        ln, lmean, lvar = self._probe_logits
        return {
            "runs": self.probe_runs,
            "numerics": self.numerics,
            "logits_err_n": ln,
            "logits_err_mean": lmean,
            "logits_err_var": lvar,
            "mean_layer_err_var": sum(lvars) / len(lvars) if lvars else None,
            "max_layer_err_var": max(lvars) if lvars else None,
            "layers": layers,
        }

    # -- modeled power attribution -------------------------------------------

    def set_power_profile(self, label: str, profile: dict) -> None:
        """Register the per-layer MAC cost/saving profile of one numerics
        label (:func:`repro_torch.serving.engine.power_profile_from_params`);
        the engine registers the live pack's at construction and after
        every governor hot-swap."""
        self.power_profiles[label] = dict(profile)

    def _power_attribution(self) -> dict | None:
        """Join the served token mix against the registered profiles.
        ``mac_units`` are tokens x MACs-per-token, a relative energy proxy;
        ``mac_units_saved`` applies each layer's cost-model saving."""
        if not self.power_profiles:
            return None
        per_layer: dict[str, dict] = {}
        per_tier: dict[str, dict] = {}
        for label, toks in sorted(self._tokens_by_numerics.items()):
            prof = self.power_profiles.get(label) or {}
            t_units = t_saved = 0.0
            for path, ent in prof.items():
                units = toks * ent["mac_per_token"]
                saved = units * ent["saving_pct"] / 100.0
                t_units += units
                t_saved += saved
                lay = per_layer.setdefault(
                    path, {"mac_units": 0.0, "mac_units_saved": 0.0})
                lay["mac_units"] += units
                lay["mac_units_saved"] += saved
            per_tier[label] = {
                "tokens": toks,
                "mac_units": round(t_units, 1),
                "mac_units_saved": round(t_saved, 1),
                "power_saving_pct": (round(100.0 * t_saved / t_units, 3)
                                     if t_units else 0.0),
            }
        for lay in per_layer.values():
            lay["saving_pct"] = (
                round(100.0 * lay["mac_units_saved"] / lay["mac_units"], 3)
                if lay["mac_units"] else 0.0)
            lay["mac_units"] = round(lay["mac_units"], 1)
            lay["mac_units_saved"] = round(lay["mac_units_saved"], 1)
        units = sum(t["mac_units"] for t in per_tier.values())
        saved = sum(t["mac_units_saved"] for t in per_tier.values())
        return {
            "tokens_attributed": sum(self._tokens_by_numerics.values()),
            "tokens_by_numerics": dict(sorted(
                self._tokens_by_numerics.items())),
            "mac_units": round(units, 1),
            "mac_units_saved": round(saved, 1),
            "modeled_power_saving_pct": (round(100.0 * saved / units, 3)
                                         if units else 0.0),
            "per_tier": per_tier,
            "per_layer": dict(sorted(per_layer.items())),
        }

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
            "governor_switches": self.governor_switches,
            "governor_escalations": self.governor_escalations,
            "governor_relaxes": self.governor_relaxes,
            "faults_injected": self.faults_injected,
            "faults_detected": self.faults_detected,
            "quarantines": self.quarantines,
            "quarantine_replays": self.quarantine_replays,
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
            "error_probe": self._probe_snapshot(),
            "power_attribution": self._power_attribution(),
        }
