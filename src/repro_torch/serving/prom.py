"""Prometheus / OpenMetrics text exposition for metrics snapshots (port of
``repro.serving.prom``: the same series names and the same text).

Dependency-free writer + parser pair over the plain-dict snapshots
``EngineMetrics.snapshot()`` / ``EngineMetrics.merge`` produce (engine or
fleet — a merged fleet snapshot exports exactly the same way).  The
writer flattens:

  * every numeric top-level snapshot field into a gauge
    ``repro_<field>`` (bools as 0/1, Nones skipped);
  * per-layer error-probe moments into
    ``repro_probe_layer_err_var{layer="..."}`` (+ ``_n``) — the series a
    Grafana heatmap reads;
  * the power attribution into per-tier and per-layer
    ``repro_power_*`` series;
  * the A/B shadow section into ``repro_shadow_*``.

Caller-supplied labels (e.g. ``{"engine": "int8-tier"}``) ride on every
series, so one scrape target can expose a whole fleet.  The parser is
the writer's inverse over the subset it emits — enough for the
round-trip tests and for CI to assert an export actually carries data —
not a general OpenMetrics implementation.

Run as a module to assert on an exported file (the CI smoke hook)::

    python -m repro_torch.serving.prom metrics.prom --require repro_generated_tokens
"""

from __future__ import annotations

import re

__all__ = ["to_openmetrics", "parse_openmetrics", "metric_value"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def _name(*parts: str) -> str:
    return _NAME_RE.sub("_", "_".join(p.strip("_") for p in parts if p))


def _fmt(name: str, labels: dict, value) -> str:
    if isinstance(value, bool):
        value = int(value)
    lab = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    body = f"{{{lab}}}" if lab else ""
    return f"{name}{body} {value}"


def to_openmetrics(snapshot: dict, prefix: str = "repro",
                   labels: dict | None = None) -> str:
    """Render one snapshot dict as OpenMetrics text exposition."""
    base = dict(labels or {})
    lines: list[str] = []
    seen_types: set[str] = set()

    def emit(name: str, value, extra: dict | None = None) -> None:
        if value is None or isinstance(value, str):
            return
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} gauge")
        lines.append(_fmt(name, {**base, **(extra or {})}, value))

    for key, value in snapshot.items():
        if isinstance(value, (dict, list)):
            continue
        emit(_name(prefix, key), value)
    probe = snapshot.get("error_probe") or {}
    for key in ("runs", "logits_err_n", "logits_err_mean", "logits_err_var",
                "mean_layer_err_var", "max_layer_err_var"):
        emit(_name(prefix, "probe", key), probe.get(key))
    for path, st in (probe.get("layers") or {}).items():
        emit(_name(prefix, "probe_layer_err_var"), st.get("err_var"),
             {"layer": path})
        emit(_name(prefix, "probe_layer_err_n"), st.get("n"),
             {"layer": path})
    shadow = snapshot.get("shadow") or {}
    for key in ("sampled_requests", "tokens", "token_matches",
                "token_match_rate", "logits_err_var", "logits_err_max_abs"):
        emit(_name(prefix, "shadow", key), shadow.get(key))
    power = snapshot.get("power_attribution") or {}
    for key in ("tokens_attributed", "mac_units", "mac_units_saved",
                "modeled_power_saving_pct"):
        emit(_name(prefix, "power", key), power.get(key))
    for tier, st in (power.get("per_tier") or {}).items():
        for key in ("tokens", "mac_units", "mac_units_saved",
                    "power_saving_pct"):
            emit(_name(prefix, "power_tier", key), st.get(key),
                 {"tier": tier})
    for path, st in (power.get("per_layer") or {}).items():
        for key in ("mac_units", "mac_units_saved", "saving_pct"):
            emit(_name(prefix, "power_layer", key), st.get(key),
                 {"layer": path})
    return "\n".join(lines) + "\n# EOF\n"


def parse_openmetrics(text: str) -> dict:
    """Parse exposition text back into ``{(name, labels...): value}``.

    Keys are ``(name, frozenset((label, value), ...))`` tuples; use
    :func:`metric_value` for ergonomic lookups."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, labpart, value = m.groups()
        labels = frozenset((k, _unescape(v))
                           for k, v in _LABEL_RE.findall(labpart or ""))
        out[(name, labels)] = float(value)
    return out


def metric_value(parsed: dict, name: str, **labels):
    """Look up one series by name + label SUBSET (None when absent)."""
    want = set(labels.items())
    for (n, lab), v in parsed.items():
        if n == name and want <= set(lab):
            return v
    return None


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Parse an OpenMetrics export and assert on it "
                    "(CI hook for repro_torch.serving.prom exports)")
    ap.add_argument("path", help="exposition file to parse")
    ap.add_argument("--require", nargs="*", default=[],
                    help="metric names that must be present")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        parsed = parse_openmetrics(f.read())
    names = {n for n, _ in parsed}
    missing = [n for n in args.require if n not in names]
    print(f"{args.path}: {len(parsed)} series, {len(names)} metric names")
    if missing:
        print(f"MISSING required metrics: {missing}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
