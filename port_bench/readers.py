"""Reductions shared by the metric readers (``port_bench/metrics/``):
from the harness's own request stamps, the proxy's record of the model
steps, and the trace's summary to numbers.  A reader that finds nothing
to read returns None, and the harness leaves its metric out."""

from __future__ import annotations

import math

from port_bench import peaks
from port_bench.harness import percentile


def ttfts(rec: dict) -> list[float]:
    """Seconds from submit to first token of every request whose first
    token came in the window; a rejected request misses (infinite)."""
    out = []
    for r in rec["requests"]:
        if r["rejected"]:
            out.append(math.inf)
        elif r["times"] and rec["t0"] <= r["times"][0] <= rec["t1"]:
            out.append(r["times"][0] - r["t_submit"])
    return out


def itls(rec: dict) -> list[float]:
    """Every gap between consecutive output tokens in the window."""
    out = []
    for r in rec["requests"]:
        ts = [t for t in r["times"] if rec["t0"] <= t <= rec["t1"]]
        out += [b - a for a, b in zip(ts, ts[1:])]
    return out


def p95_ms(values) -> float | None:
    v = percentile(values, 95)
    return None if v is None or not math.isfinite(v) else v * 1e3


def served_tokens(rec: dict) -> int:
    """Prompt tokens prefilled and tokens generated in the window (every
    request was submitted in it)."""
    return sum(r["prefilled"] + len(r["times"]) for r in rec["requests"])


def lm_useful_least_s(rec: dict) -> float | None:
    """Seconds at peak that the served tokens need: every approximate
    product of each useful row at the int8 rate, attention's QK and PV
    over the keys each useful row sees at the bf16 rate, and the head of
    each generated token at the bf16 rate.  Needs the cursors that a
    ``--trace 1`` run reads."""
    arch = rec["arch"]
    if not rec["calls"] or rec["calls"][0]["lengths"] is None:
        return None
    tokens = keys = 0.0
    for c in rec["calls"]:
        for n, start in zip(c["n_valid"], c["lengths"]):
            tokens += n
            keys += n * start + n * (n + 1) / 2
    generated = sum(len(r["times"]) for r in rec["requests"])
    return (tokens * peaks.lm_token_ops(arch) / peaks.PEAK["int8"]
            + arch["n_layers"] * peaks.lm_attention_ops(arch, keys)
            / peaks.PEAK["bf16"]
            + generated * peaks.lm_head_ops(arch) / peaks.PEAK["bf16"])


def approx_device_s(rec: dict) -> float | None:
    tr = rec.get("trace")
    if tr is None:
        return None
    s = sum(v for name, v in tr["device_s_by_name"].items()
            if any(k in name for k in peaks.APPROX_KERNELS))
    return s or None


def lm_approx_least_s(rec: dict) -> float:
    """Least seconds of the approximate products of the traced steps, on
    the rows each call was given."""
    arch, xb = rec["arch"], rec["x_bytes"]
    total = 0.0
    for c in rec["calls"]:
        if c["traced"]:
            m = c["shape"][0] * c["shape"][1]
            total += arch["n_layers"] * sum(
                peaks.least_time(*peaks.approx_group(m, k, ns, xb, xb), "int8")
                for k, ns in peaks.lm_layer_groups(arch))
    return total


def cnn_approx_least_s(rec: dict) -> float:
    """Least seconds of the approximate products of the traced batches."""
    b, xb = rec["batch"], rec["x_bytes"]
    per_batch = sum(
        peaks.least_time(*peaks.approx_group(rows * b, k, [n], xb, xb), "int8")
        for rows, k, n in peaks.resnet_layers(rec["cnn"]))
    return rec["traced_batches"] * per_batch


def cnn_image_ops(cnn: dict) -> float:
    return sum(2.0 * rows * k * n for rows, k, n in peaks.resnet_layers(cnn))


def idle_pct(rec: dict) -> float | None:
    tr = rec.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]


def roofline_pct(least_s: float, device_s: float | None) -> float | None:
    if not device_s or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
