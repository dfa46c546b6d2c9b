"""Per-engine serving metrics (port of ``repro.serving.metrics``).

Counters are recorded on the host around each engine iteration.
``snapshot()`` derives decode and end-to-end tokens/s, time to first
token, inter-token gaps, queue depth and slot occupancy; the paged
layout's block counters (utilization, fragmentation, prefix hits and
imports, copy-on-write copies, capacity stalls); the speculative counters
(acceptance, also keyed by draft spec); the robustness counters (governor
switches, faults, quarantine replays, deadline expiries); the error
probe's Chan-merged approximate-vs-exact moments; the A/B shadow's
replay counters; and the modeled power attribution.  Its key set is the
reference's.

Three observability surfaces beyond the end-of-run aggregate:

  * **Bounded latency samples.**  Per-request ttft/itl/latency samples go
    through a reservoir (:class:`Reservoir`, cap 4096): counts, sums and
    maxima stay exact, percentiles come from a uniform sample.  The
    snapshot carries ``*_samples`` (observed) and ``*_samples_capped``
    (observed minus retained).
  * **Windowed time series.**  With ``window_s > 0`` every
    ``record_step`` rolls an interval accumulator; once a window elapses a
    sample dict (window tok/s, mean queue depth and occupancy, step and
    stall deltas, block stats, the window's own probe moments, shadow and
    power deltas) goes into ``timeseries`` (a bounded ring) and to
    ``on_window_sample`` (the engine bridges it into its span tracer).
  * **Fleet merge.**  :meth:`EngineMetrics.merge` combines snapshot dicts
    across engines by sufficient statistics: counters sum, rates
    recompute over the longest elapsed window, means weight by their
    sample counts, moments combine with Chan's formula.  A merged dict
    merges again, and merge is associative.

The throughput clock starts at the first served batch (set-up and warm-up
before it are not charged) and, like the windows, reads
``time.perf_counter``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import random
import time
from typing import Callable

#: default reservoir capacity for per-request latency samples
RESERVOIR_CAP = 4096
#: windowed time-series ring capacity (samples); oldest dropped
TIMESERIES_CAP = 4096


def _percentile(xs, q: float) -> float:
    """Linear-interpolation percentile (numpy's default method).

    Nearest-rank rounding misreports tail percentiles on small samples —
    e.g. p95 of 10 samples rounds to the 9th order statistic, identical
    to p89 — so interpolate between the two bracketing order statistics
    instead.
    """
    xs = list(xs)
    if not xs:
        return 0.0
    ys = sorted(xs)
    pos = q * (len(ys) - 1)
    lo = min(int(math.floor(pos)), len(ys) - 1)
    hi = min(lo + 1, len(ys) - 1)
    frac = pos - lo
    return ys[lo] + (ys[hi] - ys[lo]) * frac


class Reservoir:
    """Bounded uniform sample of a stream with exact n/sum/max.

    Algorithm R with a deterministic per-instance RNG (reproducible
    snapshots).  Means and maxima are computed from exact running
    aggregates — only percentiles read the (uniform) reservoir — so
    capping never biases the headline numbers.
    """

    __slots__ = ("cap", "n", "total", "_max", "samples", "_rng")

    def __init__(self, cap: int = RESERVOIR_CAP, seed: int = 0x5EED) -> None:
        if cap < 1:
            raise ValueError(f"reservoir cap must be >= 1, got {cap}")
        self.cap = cap
        self.n = 0  # total observed (exact)
        self.total = 0.0  # running sum (exact)
        self._max = float("-inf")
        self.samples: list[float] = []
        self._rng = random.Random(seed)

    def push(self, x: float) -> None:
        x = float(x)
        self.n += 1
        self.total += x
        if x > self._max:
            self._max = x
        if len(self.samples) < self.cap:
            self.samples.append(x)
        else:
            j = self._rng.randrange(self.n)
            if j < self.cap:
                self.samples[j] = x

    def __len__(self) -> int:
        return self.n

    def __bool__(self) -> bool:
        return self.n > 0

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    @property
    def max(self) -> float:
        return self._max if self.n else 0.0

    @property
    def capped(self) -> int:
        """Observations not retained in the reservoir."""
        return self.n - len(self.samples)

    def percentile(self, q: float) -> float:
        return _percentile(self.samples, q)


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
    """Dict-union Chan merge of layer-keyed ``(n, mean, var)`` maps.

    The shared primitive behind per-layer probe aggregation: the running
    engine totals, the per-window accumulators, the governor's per-layer
    SLO windows, and the fleet merge all combine layer moment maps with
    this.  Associative and layout-independent: merging ``(a, b)`` then
    ``c`` equals merging ``a`` then ``(b, c)``, and the key union never
    depends on which engine saw which layer first.
    """
    out: dict = {}
    for m in maps:
        for path, mom in m.items():
            out[path] = _merge_moments(out.get(path, (0, 0.0, 0.0)),
                                       tuple(mom))
    return out


def _sig(x: float, digits: int = 6) -> float:
    """Round to significant digits (err variances span many decades;
    fixed decimal rounding flushes the small ones to zero)."""
    return float(f"{x:.{digits}g}")


@dataclasses.dataclass
class EngineMetrics:
    #: set by the first record_step (lazy); None while nothing was served
    t_start: float | None = None

    #: name of the NumericsSpec the served parameters were packed under
    #: (None = unknown/float); surfaced in snapshot() for fleet audits
    numerics: str | None = None

    #: whether the engine's slot count fits the kernel block picker's
    #: decode-specialized tiles (repro_torch.kernels.ops.DECODE_M_MAX): one-token
    #: decode steps then run thin-M, single-K-step kernel launches
    decode_specialized: bool | None = None

    #: KV memory model the engine serves under ("contiguous" | "paged")
    kv_layout: str = "contiguous"

    #: windowed time-series interval in seconds (0 disables the roller)
    window_s: float = 0.0
    #: called with each emitted window sample (the engine bridges samples
    #: into the span tracer); excluded from repr/compare
    on_window_sample: Callable | None = dataclasses.field(
        default=None, repr=False, compare=False)

    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_steps: int = 0
    decode_steps: int = 0
    mixed_steps: int = 0  # chunk-shaped batches carrying decode rows

    #: speculative decode config mirror: the engine's draft length
    #: (0 = speculation off) and the NumericsSpec name its draft
    #: parameters were packed under (the acceptance-rate key)
    speculative_k: int = 0
    draft_numerics: str | None = None
    spec_rounds: int = 0  # engine iterations that ran a draft phase
    draft_calls: int = 0  # thin approximate-parameter dispatches
    drafted_tokens: int = 0  # draft tokens proposed across all rounds
    accepted_draft_tokens: int = 0  # drafts the exact verifier agreed with

    submitted: int = 0
    rejected: int = 0
    evicted: int = 0  # queued requests re-rejected for higher-priority work
    finished: int = 0

    #: engine iterations where queued work could not be admitted because
    #: the pool lacked capacity (free slots, or — paged — free blocks).
    #: Distinct from queue-full REJECTION: a stall delays work, a
    #: rejection drops it; before this counter the two were
    #: indistinguishable in the snapshot.
    no_capacity_stalls: int = 0

    #: prefix-cache reuse (paged layout): requests admitted onto cached
    #: blocks, and the total prompt tokens whose prefill that skipped
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0
    #: prefix-cache blocks adopted from another replica's pool
    #: (cross-replica sharing, repro_torch.serving.fleet)
    prefix_imports: int = 0

    ttfts: Reservoir = dataclasses.field(default_factory=Reservoir)
    #: per-request gaps between consecutive generated tokens (seconds)
    itls: Reservoir = dataclasses.field(default_factory=Reservoir)
    latencies: Reservoir = dataclasses.field(default_factory=Reservoir)

    _occupancy_sum: float = 0.0
    _queue_depth_sum: float = 0.0
    _samples: int = 0

    # block-level accounting (paged layout; None-ish for contiguous).
    # Slot occupancy OVERSTATES utilization under heterogeneous lengths —
    # a slot holding a 16-token chat counts like one holding a 256-token
    # document — so block utilization/fragmentation is reported alongside.
    _block_util_sum: float = 0.0
    _block_frag_sum: float = 0.0
    _block_samples: int = 0
    _last_block_stats: dict | None = None

    # windowed time-series state (window_s > 0)
    timeseries: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=TIMESERIES_CAP))
    timeseries_dropped: int = 0
    _win_t0: float | None = None
    _win_base: dict | None = None

    # robustness counters (repro_torch.serving.governor / repro_torch.quant.faults):
    # SLO-governor pack switches, injected/detected faults, quarantined
    # rows replayed on the exact pack, deadline expiries, and submit-loop
    # retries after queue-full rejections
    governor_switches: int = 0
    governor_escalations: int = 0
    governor_relaxes: int = 0
    faults_injected: int = 0
    faults_detected: int = 0
    quarantines: int = 0
    quarantine_replays: int = 0
    requests_retried: int = 0
    requests_deadline_expired: int = 0

    # approximation-error probe aggregation (repro_torch.quant.error_probe):
    # per-layer and logits-level (n, mean, var) of approximate-vs-exact
    # output deltas, combined across probe runs with Chan's formula
    probe_runs: int = 0
    _probe_layers: dict = dataclasses.field(default_factory=dict)
    _probe_logits: tuple = (0, 0.0, 0.0)

    # per-WINDOW probe accumulators: moments are not diffable counters
    # (a base-vs-current subtraction is meaningless for a variance), so
    # the window roller keeps fresh accumulators reset at every roll
    # instead of riding _window_counters
    _win_probe_runs: int = 0
    _win_probe_layers: dict = dataclasses.field(default_factory=dict)
    _win_probe_logits: tuple = (0, 0.0, 0.0)

    # modeled power attribution: per-numerics-label layer cost profiles
    # ({path: {mac_per_token, saving_pct}}, derived from the live packed
    # params by the engine) joined against the token mix actually served
    # under each label — so a governor hot-swap mid-run splits the
    # attribution between rungs instead of crediting the final pack
    power_profiles: dict = dataclasses.field(default_factory=dict)
    _tokens_by_numerics: dict = dataclasses.field(default_factory=dict)

    # A/B shadow serving (repro_torch.serving.shadow): sampled-request replay
    # of a second pack; counters + Chan-merged logit-delta moments
    shadow_numerics: str | None = None
    shadow_sampled: int = 0
    shadow_tokens: int = 0
    shadow_token_matches: int = 0
    _shadow_logits: tuple = (0, 0.0, 0.0)
    _shadow_max_abs: float = 0.0

    # -- recording -----------------------------------------------------------

    def start_clock(self) -> None:
        """Arm the throughput clock (idempotent).  The engine calls this
        just before dispatching its first batch, so that step's wall time
        is inside the measured window; ``record_step`` also arms it as a
        fallback for direct users of the metrics object."""
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
        elif kind == "spec":
            # one speculative round = draft_calls thin approximate
            # dispatches + one chunk-shaped exact verify dispatch
            self.spec_rounds += 1
        else:
            self.decode_steps += 1
        self.drafted_tokens += drafted
        self.accepted_draft_tokens += accepted
        self.draft_calls += draft_calls
        self.prompt_tokens += prompt_tokens
        self.generated_tokens += generated_tokens
        if prompt_tokens or generated_tokens:
            # attribute served tokens to the numerics label active NOW —
            # the join key for modeled power attribution
            label = self.numerics or "unknown"
            self._tokens_by_numerics[label] = (
                self._tokens_by_numerics.get(label, 0)
                + prompt_tokens + generated_tokens)
        self._occupancy_sum += occupancy
        self._queue_depth_sum += queue_depth
        self._samples += 1
        if block_stats is not None:
            self._block_util_sum += block_stats["block_util"]
            self._block_frag_sum += block_stats["block_frag"]
            self._block_samples += 1
            self._last_block_stats = block_stats
        if self.window_s > 0:
            self._maybe_roll()

    def record_first_token(self, req) -> None:
        if req.ttft is not None:
            self.ttfts.push(req.ttft)

    def record_itl(self, gap: float | None) -> None:
        """One inter-token gap (``Request.emit``'s return; None = first
        token of a request, which has no gap)."""
        if gap is not None:
            self.itls.push(gap)

    def record_finish(self, req) -> None:
        self.finished += 1
        if req.t_finish is not None:
            self.latencies.push(req.t_finish - req.t_submit)

    # -- windowed time-series ------------------------------------------------

    def _window_counters(self) -> dict:
        return {"generated_tokens": self.generated_tokens,
                "prompt_tokens": self.prompt_tokens,
                "no_capacity_stalls": self.no_capacity_stalls,
                "prefill_steps": self.prefill_steps,
                "decode_steps": self.decode_steps,
                "mixed_steps": self.mixed_steps,
                "spec_rounds": self.spec_rounds,
                "draft_calls": self.draft_calls,
                "drafted_tokens": self.drafted_tokens,
                "accepted_draft_tokens": self.accepted_draft_tokens,
                "governor_switches": self.governor_switches,
                "faults_detected": self.faults_detected,
                "quarantines": self.quarantines,
                "shadow_sampled": self.shadow_sampled,
                "shadow_tokens": self.shadow_tokens,
                "shadow_token_matches": self.shadow_token_matches,
                # per-label token counters (flattened; labels can appear
                # mid-run on a governor switch, hence base.get below)
                **{f"_tok/{k}": v
                   for k, v in self._tokens_by_numerics.items()},
                "_occupancy_sum": self._occupancy_sum,
                "_queue_depth_sum": self._queue_depth_sum,
                "_samples": self._samples,
                "_block_util_sum": self._block_util_sum,
                "_block_frag_sum": self._block_frag_sum,
                "_block_samples": self._block_samples}

    def _maybe_roll(self) -> None:
        now = time.perf_counter()
        if self._win_t0 is None:
            self._win_t0 = now
            self._win_base = self._window_counters()
            return
        dur = now - self._win_t0
        if dur < self.window_s:
            return
        cur, base = self._window_counters(), self._win_base
        d = {k: cur[k] - base.get(k, 0) for k in cur}
        steps = d["_samples"]
        sample = {
            "t": round(now - (self.t_start or now), 4),
            "dur_s": round(dur, 4),
            "gen_tok_per_s": round(d["generated_tokens"] / dur, 2),
            "prompt_tok_per_s": round(d["prompt_tokens"] / dur, 2),
            "steps": steps,
            "prefill_steps": d["prefill_steps"],
            "decode_steps": d["decode_steps"],
            "mixed_steps": d["mixed_steps"],
            "no_capacity_stalls": d["no_capacity_stalls"],
            "mean_queue_depth": round(d["_queue_depth_sum"] / steps, 2)
            if steps else 0.0,
            "mean_slot_occupancy": round(d["_occupancy_sum"] / steps, 3)
            if steps else 0.0,
        }
        if d["_block_samples"]:
            sample["mean_block_utilization"] = round(
                d["_block_util_sum"] / d["_block_samples"], 3)
            sample["mean_block_fragmentation"] = round(
                d["_block_frag_sum"] / d["_block_samples"], 3)
        if self.speculative_k:
            # per-window acceptance: the live draft-quality signal (a CV
            # toggle or quality drift shows up here before it shows up in
            # the end-of-run aggregate)
            sample["spec_rounds"] = d["spec_rounds"]
            sample["drafted_tokens"] = d["drafted_tokens"]
            sample["accepted_draft_tokens"] = d["accepted_draft_tokens"]
            sample["acceptance_rate"] = (
                round(d["accepted_draft_tokens"] / d["drafted_tokens"], 4)
                if d["drafted_tokens"] else None)
        if self.governor_switches or self.faults_detected or self.quarantines:
            # robustness deltas appear once any governor/fault activity
            # exists (keeps pre-governor sample schemas unchanged)
            sample["governor_switches"] = d["governor_switches"]
            sample["faults_detected"] = d["faults_detected"]
            sample["quarantines"] = d["quarantines"]
        if self._win_probe_runs:
            # layer-resolved err-var for THIS window (fresh accumulators,
            # not a lifetime average): the per-layer time-series the
            # dashboard heatmap and the governor's layer SLOs consume.
            # probe_layers is a nested dict — it survives JSONL traces;
            # the Chrome counter export keeps only the numeric scalars.
            _, _, lvar = self._win_probe_logits
            lvars = {p: v for p, (_, _, v) in self._win_probe_layers.items()}
            sample["probe_runs"] = self._win_probe_runs
            sample["probe_logits_err_var"] = _sig(lvar)
            if lvars:
                worst = max(lvars, key=lvars.get)
                sample["probe_max_layer_err_var"] = _sig(lvars[worst])
                sample["probe_worst_layer"] = worst
                sample["probe_layers"] = {p: _sig(v)
                                          for p, v in sorted(lvars.items())}
        if self.shadow_numerics is not None:
            sample["shadow_sampled"] = d["shadow_sampled"]
            sample["shadow_tokens"] = d["shadow_tokens"]
            sample["shadow_token_match_rate"] = (
                round(d["shadow_token_matches"] / d["shadow_tokens"], 4)
                if d["shadow_tokens"] else None)
        if self.power_profiles:
            # this window's modeled power: token mix served per numerics
            # label x that label's per-layer MAC cost/saving profile
            mix = {k[len("_tok/"):]: d[k] for k in d
                   if k.startswith("_tok/") and d[k]}
            units = saved = 0.0
            for label, toks in mix.items():
                for ent in (self.power_profiles.get(label) or {}).values():
                    u = toks * ent["mac_per_token"]
                    units += u
                    saved += u * ent["saving_pct"] / 100.0
            sample["tokens_by_numerics"] = mix
            sample["modeled_mac_units"] = round(units, 1)
            sample["modeled_mac_units_saved"] = round(saved, 1)
            sample["modeled_power_saving_pct"] = (
                round(100.0 * saved / units, 3) if units else 0.0)
        self._win_probe_runs = 0
        self._win_probe_layers = {}
        self._win_probe_logits = (0, 0.0, 0.0)
        if len(self.timeseries) == self.timeseries.maxlen:
            self.timeseries_dropped += 1
        self.timeseries.append(sample)
        self._win_t0 = now
        self._win_base = cur
        if self.on_window_sample is not None:
            self.on_window_sample(sample)

    # -- approximation-error probe -------------------------------------------

    def record_probe(self, report: dict) -> None:
        """Fold one :class:`~repro_torch.quant.error_probe.ErrorProbe` report
        (per-layer + logits ``{n, mean, var}`` of approx-vs-exact output
        deltas) into the running per-layer moments."""
        self.probe_runs += 1
        self._win_probe_runs += 1
        for path, st in report.get("layers", {}).items():
            mom = (st["n"], st["mean"], st["var"])
            self._probe_layers[path] = _merge_moments(
                self._probe_layers.get(path, (0, 0.0, 0.0)), mom)
            self._win_probe_layers[path] = _merge_moments(
                self._win_probe_layers.get(path, (0, 0.0, 0.0)), mom)
        lg = report.get("logits")
        if lg is not None:
            mom = (lg["n"], lg["mean"], lg["var"])
            self._probe_logits = _merge_moments(self._probe_logits, mom)
            self._win_probe_logits = _merge_moments(
                self._win_probe_logits, mom)

    def _probe_snapshot(self) -> dict | None:
        if not self.probe_runs and not self._probe_layers:
            return None
        layers = {path: {"n": n, "err_mean": mean, "err_var": var}
                  for path, (n, mean, var) in sorted(self._probe_layers.items())}
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

    # -- A/B shadow serving --------------------------------------------------

    def record_shadow(self, rec: dict) -> None:
        """Fold one :class:`~repro_torch.serving.shadow.ShadowRunner` replay
        record (``{tokens, matches, logits_err: {n, mean, var, max_abs}}``)
        into the running shadow counters."""
        self.shadow_sampled += 1
        self.shadow_tokens += rec.get("tokens", 0)
        self.shadow_token_matches += rec.get("matches", 0)
        le = rec.get("logits_err")
        if le:
            self._shadow_logits = _merge_moments(
                self._shadow_logits, (le["n"], le["mean"], le["var"]))
            self._shadow_max_abs = max(self._shadow_max_abs,
                                       le.get("max_abs", 0.0))

    def _shadow_snapshot(self) -> dict | None:
        if not self.shadow_sampled:
            return None
        n, mean, var = self._shadow_logits
        return {
            "numerics": self.shadow_numerics,
            "sampled_requests": self.shadow_sampled,
            "tokens": self.shadow_tokens,
            "token_matches": self.shadow_token_matches,
            "token_match_rate": (
                round(self.shadow_token_matches / self.shadow_tokens, 4)
                if self.shadow_tokens else None),
            "logits_err_n": n,
            "logits_err_mean": mean,
            "logits_err_var": var,
            "logits_err_max_abs": self._shadow_max_abs,
        }

    # -- modeled power attribution -------------------------------------------

    def set_power_profile(self, label: str, profile: dict) -> None:
        """Register a per-layer MAC cost/saving profile for one numerics
        label (``{path: {mac_per_token, saving_pct}}``; see
        :func:`repro_torch.serving.engine.power_profile_from_params`).  The
        engine registers the active pack's profile at construction and
        again after every governor hot-swap."""
        self.power_profiles[label] = dict(profile)

    def _power_attribution(self) -> dict | None:
        """Join the served token mix against the registered profiles.

        ``mac_units`` are (tokens x MACs-per-token) — a relative energy
        proxy: multiply by the per-MAC energy of the exact 8x8 array to
        get mWh.  ``mac_units_saved`` applies each layer's cost-model
        saving, so the totals are traffic-weighted deltas, not the static
        plan percentages."""
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

    # -- derived -------------------------------------------------------------

    def snapshot(self) -> dict:
        elapsed = (max(time.perf_counter() - self.t_start, 1e-9)
                   if self.t_start is not None else 0.0)
        total_tok = self.prompt_tokens + self.generated_tokens
        blk = self._last_block_stats or {}
        return {
            "engines": 1,
            "numerics": self.numerics,
            "decode_specialized": self.decode_specialized,
            "kv_layout": self.kv_layout,
            "elapsed_s": round(elapsed, 4),
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
            "prefix_imports": self.prefix_imports,
            "mean_block_utilization": round(
                self._block_util_sum / self._block_samples, 3)
            if self._block_samples else None,
            "mean_block_fragmentation": round(
                self._block_frag_sum / self._block_samples, 3)
            if self._block_samples else None,
            "block_step_samples": self._block_samples,
            "peak_blocks_in_use": blk.get("peak_blocks_in_use"),
            "blocks_total": blk.get("blocks_total"),
            "prefix_cache_entries": blk.get("prefix_cache_entries"),
            "cow_copies": blk.get("cow_copies"),
            "prefix_evictions": blk.get("prefix_evictions"),
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": self.generated_tokens,
            "gen_tok_per_s": round(self.generated_tokens / elapsed, 2)
            if elapsed else 0.0,
            "total_tok_per_s": round(total_tok / elapsed, 2)
            if elapsed else 0.0,
            "prefill_steps": self.prefill_steps,
            "decode_steps": self.decode_steps,
            "mixed_steps": self.mixed_steps,
            "step_samples": self._samples,
            "speculative_k": self.speculative_k or None,
            "draft_numerics": self.draft_numerics,
            "spec_rounds": self.spec_rounds,
            "draft_calls": self.draft_calls,
            "drafted_tokens": self.drafted_tokens,
            "accepted_draft_tokens": self.accepted_draft_tokens,
            "acceptance_rate": round(
                self.accepted_draft_tokens / self.drafted_tokens, 4)
            if self.drafted_tokens else None,
            "acceptance_by_draft_spec": (
                {self.draft_numerics or "unknown": {
                    "drafted": self.drafted_tokens,
                    "accepted": self.accepted_draft_tokens,
                    "acceptance_rate": round(
                        self.accepted_draft_tokens / self.drafted_tokens,
                        4)}}
                if self.drafted_tokens else None),
            "ttft_mean_s": round(self.ttfts.mean, 4) if self.ttfts else None,
            "ttft_p50_s": round(self.ttfts.percentile(0.5), 4)
            if self.ttfts else None,
            "ttft_max_s": round(self.ttfts.max, 4) if self.ttfts else None,
            "ttft_samples": len(self.ttfts),
            "ttft_samples_capped": self.ttfts.capped,
            "itl_p50_s": round(self.itls.percentile(0.5), 4)
            if self.itls else None,
            "itl_p95_s": round(self.itls.percentile(0.95), 4)
            if self.itls else None,
            "itl_max_s": round(self.itls.max, 4) if self.itls else None,
            "itl_samples": len(self.itls),
            "itl_samples_capped": self.itls.capped,
            "latency_mean_s": round(self.latencies.mean, 4)
            if self.latencies else None,
            "latency_samples": len(self.latencies),
            "latency_samples_capped": self.latencies.capped,
            "mean_slot_occupancy": round(self._occupancy_sum / self._samples, 3)
            if self._samples else 0.0,
            "mean_queue_depth": round(self._queue_depth_sum / self._samples, 2)
            if self._samples else 0.0,
            "metrics_window_s": self.window_s if self.window_s > 0 else None,
            "timeseries_samples": len(self.timeseries),
            "timeseries_dropped": self.timeseries_dropped,
            "error_probe": self._probe_snapshot(),
            "shadow": self._shadow_snapshot(),
            "power_attribution": self._power_attribution(),
        }

    # -- fleet merge ---------------------------------------------------------

    _SUM_KEYS = (
        "engines", "requests_finished", "requests_rejected",
        "requests_evicted", "no_capacity_stalls",
        "governor_switches", "governor_escalations", "governor_relaxes",
        "faults_injected", "faults_detected", "quarantines",
        "quarantine_replays", "requests_retried",
        "requests_deadline_expired", "prefix_hits",
        "prefix_hit_tokens", "prefix_imports",
        "prompt_tokens", "generated_tokens",
        "prefill_steps", "decode_steps", "mixed_steps", "step_samples",
        "spec_rounds", "draft_calls", "drafted_tokens",
        "accepted_draft_tokens",
        "block_step_samples", "ttft_samples", "ttft_samples_capped",
        "itl_samples", "itl_samples_capped", "latency_samples",
        "latency_samples_capped", "timeseries_samples", "timeseries_dropped",
        "peak_blocks_in_use", "blocks_total", "prefix_cache_entries",
        "cow_copies", "prefix_evictions",
    )
    _MAX_KEYS = ("elapsed_s", "ttft_max_s", "itl_max_s")
    #: value key -> its weight key (count-weighted means; percentiles are
    #: APPROXIMATED by the same weighting — exact fleet percentiles would
    #: need the raw reservoirs, which snapshots deliberately do not carry)
    _WEIGHTED_KEYS = (
        ("ttft_mean_s", "ttft_samples"),
        ("ttft_p50_s", "ttft_samples"),
        ("itl_p50_s", "itl_samples"),
        ("itl_p95_s", "itl_samples"),
        ("latency_mean_s", "latency_samples"),
        ("mean_slot_occupancy", "step_samples"),
        ("mean_queue_depth", "step_samples"),
        ("mean_block_utilization", "block_step_samples"),
        ("mean_block_fragmentation", "block_step_samples"),
    )
    _EQUAL_OR_MIXED = ("numerics", "kv_layout")

    @staticmethod
    def merge(snaps: list[dict]) -> dict:
        """Combine snapshot dicts across engines (associative).

        Counters sum; throughput recomputes as summed tokens over the
        MAX elapsed window (engines run concurrently — summing rates
        would double-count shared wall time only when windows coincide,
        and max is the conservative fleet denominator either way); means
        weight by their carried sample counts; error-probe moments merge
        with Chan's parallel formula.  A merged dict is itself a valid
        ``merge`` input, so pairwise and flat merges agree (up to float
        association)."""
        snaps = list(snaps)
        if not snaps:
            return {}
        out: dict = {}
        for k in EngineMetrics._SUM_KEYS:
            vals = [s.get(k) for s in snaps if s.get(k) is not None]
            out[k] = sum(vals) if vals else None
        for k in EngineMetrics._MAX_KEYS:
            vals = [s.get(k) for s in snaps if s.get(k) is not None]
            out[k] = max(vals) if vals else None
        for k, wk in EngineMetrics._WEIGHTED_KEYS:
            pairs = [(s.get(k), s.get(wk)) for s in snaps
                     if s.get(k) is not None and s.get(wk)]
            if not pairs:
                # no weighted contributor: single-engine merge must be an
                # exact no-op, so a sole snapshot's value (e.g. the 0.0 a
                # zero-sample snapshot reports) passes through verbatim
                out[k] = snaps[0].get(k) if len(snaps) == 1 else None
            elif len(pairs) == 1:
                # one contributor: pass through exactly (v * w / w is not
                # bit-identical to v for every float)
                out[k] = pairs[0][0]
            else:
                num = sum(v * w for v, w in pairs)
                den = sum(w for _, w in pairs)
                out[k] = num / den
        for k in EngineMetrics._EQUAL_OR_MIXED:
            vals = {s.get(k) for s in snaps}
            out[k] = vals.pop() if len(vals) == 1 else "mixed"
        for k in ("decode_specialized", "metrics_window_s", "speculative_k"):
            vals = {s.get(k) for s in snaps}
            out[k] = vals.pop() if len(vals) == 1 else None
        # draft spec label: single non-None value passes through, a
        # heterogeneous fleet reads "mixed" (the per-spec breakdown below
        # keeps the split auditable)
        dn = {s.get("draft_numerics") for s in snaps
              if s.get("draft_numerics") is not None}
        out["draft_numerics"] = (dn.pop() if len(dn) == 1
                                 else ("mixed" if dn else None))
        elapsed = out.get("elapsed_s") or 0.0
        gen = out.get("generated_tokens") or 0
        total = gen + (out.get("prompt_tokens") or 0)
        out["gen_tok_per_s"] = round(gen / elapsed, 2) if elapsed else 0.0
        out["total_tok_per_s"] = round(total / elapsed, 2) if elapsed else 0.0
        # acceptance recomputes from the summed counters (rates never
        # average); the per-spec map unions by key, summing its counters
        drafted = out.get("drafted_tokens") or 0
        out["acceptance_rate"] = (
            round((out.get("accepted_draft_tokens") or 0) / drafted, 4)
            if drafted else None)
        by_spec: dict = {}
        for s in snaps:
            for label, st in (s.get("acceptance_by_draft_spec") or {}).items():
                cur = by_spec.setdefault(label, {"drafted": 0, "accepted": 0})
                cur["drafted"] += st["drafted"]
                cur["accepted"] += st["accepted"]
        for st in by_spec.values():
            st["acceptance_rate"] = (round(st["accepted"] / st["drafted"], 4)
                                     if st["drafted"] else None)
        out["acceptance_by_draft_spec"] = by_spec or None
        # error-probe moments: dict-union layers, Chan-merge shared paths
        probes = [s["error_probe"] for s in snaps if s.get("error_probe")]
        if probes:
            layers: dict = {}
            logits = (0, 0.0, 0.0)
            for p in probes:
                for path, st in p.get("layers", {}).items():
                    layers[path] = _merge_moments(
                        layers.get(path, (0, 0.0, 0.0)),
                        (st["n"], st["err_mean"], st["err_var"]))
                logits = _merge_moments(
                    logits, (p["logits_err_n"], p["logits_err_mean"],
                             p["logits_err_var"]))
            lvars = [v for _, _, v in layers.values()]
            pnum = {s["error_probe"].get("numerics") for s in snaps
                    if s.get("error_probe")}
            out["error_probe"] = {
                "runs": sum(p["runs"] for p in probes),
                "numerics": pnum.pop() if len(pnum) == 1 else "mixed",
                "logits_err_n": logits[0],
                "logits_err_mean": logits[1],
                "logits_err_var": logits[2],
                "mean_layer_err_var": (sum(lvars) / len(lvars)
                                       if lvars else None),
                "max_layer_err_var": max(lvars) if lvars else None,
                "layers": {path: {"n": n, "err_mean": m, "err_var": v}
                           for path, (n, m, v) in sorted(layers.items())},
            }
        else:
            out["error_probe"] = None
        # A/B shadow: counters sum, logit-delta moments Chan-merge,
        # match rate recomputes from the summed counters
        shadows = [s["shadow"] for s in snaps if s.get("shadow")]
        if shadows:
            logits = (0, 0.0, 0.0)
            for sh in shadows:
                logits = _merge_moments(
                    logits, (sh["logits_err_n"], sh["logits_err_mean"],
                             sh["logits_err_var"]))
            toks = sum(sh["tokens"] for sh in shadows)
            matches = sum(sh["token_matches"] for sh in shadows)
            snum = {sh.get("numerics") for sh in shadows}
            out["shadow"] = {
                "numerics": snum.pop() if len(snum) == 1 else "mixed",
                "sampled_requests": sum(sh["sampled_requests"]
                                        for sh in shadows),
                "tokens": toks,
                "token_matches": matches,
                "token_match_rate": (round(matches / toks, 4)
                                     if toks else None),
                "logits_err_n": logits[0],
                "logits_err_mean": logits[1],
                "logits_err_var": logits[2],
                "logits_err_max_abs": max(sh["logits_err_max_abs"]
                                          for sh in shadows),
            }
        else:
            out["shadow"] = None
        # power attribution: mac-unit totals sum (they are extensive
        # quantities), percentages recompute from the summed units
        powers = [s["power_attribution"] for s in snaps
                  if s.get("power_attribution")]
        if powers:
            per_tier: dict = {}
            per_layer: dict = {}
            tok_mix: dict = {}
            for p in powers:
                for label, t in p.get("per_tier", {}).items():
                    cur = per_tier.setdefault(label, {
                        "tokens": 0, "mac_units": 0.0,
                        "mac_units_saved": 0.0})
                    cur["tokens"] += t["tokens"]
                    cur["mac_units"] += t["mac_units"]
                    cur["mac_units_saved"] += t["mac_units_saved"]
                for path, lay in p.get("per_layer", {}).items():
                    cur = per_layer.setdefault(path, {
                        "mac_units": 0.0, "mac_units_saved": 0.0})
                    cur["mac_units"] += lay["mac_units"]
                    cur["mac_units_saved"] += lay["mac_units_saved"]
                for label, t in p.get("tokens_by_numerics", {}).items():
                    tok_mix[label] = tok_mix.get(label, 0) + t
            for cur in list(per_tier.values()) + list(per_layer.values()):
                cur["mac_units"] = round(cur["mac_units"], 1)
                cur["mac_units_saved"] = round(cur["mac_units_saved"], 1)
                pct = (100.0 * cur["mac_units_saved"] / cur["mac_units"]
                       if cur["mac_units"] else 0.0)
                key = "power_saving_pct" if "tokens" in cur else "saving_pct"
                cur[key] = round(pct, 3)
            units = sum(t["mac_units"] for t in per_tier.values())
            saved = sum(t["mac_units_saved"] for t in per_tier.values())
            out["power_attribution"] = {
                "tokens_attributed": sum(p["tokens_attributed"]
                                         for p in powers),
                "tokens_by_numerics": dict(sorted(tok_mix.items())),
                "mac_units": round(units, 1),
                "mac_units_saved": round(saved, 1),
                "modeled_power_saving_pct": (
                    round(100.0 * saved / units, 3) if units else 0.0),
                "per_tier": dict(sorted(per_tier.items())),
                "per_layer": dict(sorted(per_layer.items())),
            }
        else:
            out["power_attribution"] = None
        return out
