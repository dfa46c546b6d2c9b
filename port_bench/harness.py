"""The general part of the benchmark: finds a cell's files by the names
in ``BENCHMARK.json``, runs the cell through its runner, reads its
metrics through their readers, checks the process for JAX, and prints
the result line.

A cell runner (``port_bench/cell_<kind>.py``) exposes ``run(cell) ->
Outcome``.  A metric reader (``port_bench/metrics/<name>.py``) exposes
``read(rec) -> float | None``, ``rec`` being the dict of what the run
recorded.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Any

#: top-level module names that no process of the benchmark may hold once
#: its window has closed (compared whole: ``repro_torch`` is not ``repro``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """One run of one cell: its entries and files, and the run's
    arguments.  ``hooks`` lets a test break the timed path underneath
    (see the runners); a run from the command line has none."""

    root: pathlib.Path
    workload: dict
    config: dict
    traffic: dict
    metrics: list[dict]
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    hooks: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Outcome:
    """What a runner hands back: the record its metric readers read, the
    compared numbers ``{name: (value, limit)}`` (a value above its limit
    is not correct), requests or batches attempted and failed, the peak
    device memory and, with ``--trace 1``, the trace's summary
    (:func:`port_bench.trace.summarise`)."""

    rec: dict
    checks: dict[str, tuple[float, float]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict | None = None


def stamp(cell: Cell, phase: str) -> None:
    """Set-up's seconds so far, on standard error, by phase."""
    import torch

    if cell.device == "cuda":
        torch.cuda.synchronize()
    print(f"setup: {phase} done at "
          f"{time.perf_counter() - cell.t_start:.3f} s", file=sys.stderr)


def load_benchmark(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    with ``--trace 0``, its per-layer metrics with ``--trace 1``; a metric
    without ``workloads`` belongs to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def load_cell(root: pathlib.Path, name: str, seed: int, seconds: float,
              trace: bool, device: str, t_start: float,
              bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(by_name)}")
    wl = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (root / "port_bench" / "traffic" / f"{wl['traffic']}.json").read_text())
    return Cell(root=root, workload=wl, config=config, traffic=traffic,
                metrics=cell_metrics(bench, name, trace), seed=seed,
                seconds=seconds, trace=trace, device=device, t_start=t_start)


def runner(kind: str):
    return importlib.import_module(f"port_bench.cell_{kind}")


def reader(root: pathlib.Path, metric: str):
    """The ``read`` function of ``port_bench/metrics/<metric>.py`` (loaded
    by path: a metric's name may hold dots)."""
    path = root / "port_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- statistics -------------------------------------------------------------


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile by nearest rank (the smallest value with at
    least q% of the values at or below it); None for no values."""
    vals = sorted(values)
    if not vals:
        return None
    return vals[max(0, math.ceil(q / 100 * len(vals)) - 1)]


# -- the run ----------------------------------------------------------------


def forbidden_loaded(names=None) -> list[str]:
    """Forbidden top-level module names among ``names`` (default: the
    modules this process holds)."""
    tops = {name.split(".")[0]
            for name in (list(sys.modules) if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def device_info(cell: Cell, out: Outcome) -> dict:
    import torch

    if cell.device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": out.memory_peak_bytes}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell.workload["chips"],
                "memory_peak_bytes": out.memory_peak_bytes}
    if cell.trace and out.trace is not None:
        info["busy_s"] = out.trace["busy_s"]
        info["window_s"] = out.trace["window_s"]
    return info


def result_line(cell: Cell, out: Outcome) -> dict:
    """The result object; ``checks`` comes last, each compared number
    beside its limit."""
    metrics = {}
    for m in cell.metrics:
        value = reader(cell.root, m["name"])(out.rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = out.failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in out.checks.values())
    line: dict[str, Any] = {
        "correct": correct, "attempted": out.attempted, "failed": out.failed,
        "metrics": metrics, "device": device_info(cell, out)}
    if cell.trace and out.trace is not None:
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, (v, lim) in out.checks.items()}
    return line


def run_cell(cell: Cell) -> dict:
    """Runs ``cell`` through its runner and returns the result object."""
    out = runner(cell.config["kind"]).run(cell)
    return result_line(cell, out)


def emit(line: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, root: pathlib.Path, t_start: float) -> int:
    args = parse_args(argv)
    bench = load_benchmark(root)
    import torch

    torch.set_num_threads(1)

    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload, 1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on the card "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    cell = load_cell(root, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", t_start, bench)
    line = run_cell(cell)
    found = forbidden_loaded()
    if found:
        print(f"the process holds {found} after the window: the port's run "
              "must load none of " + ", ".join(FORBIDDEN_MODULES),
              file=sys.stderr)
        return 3
    emit(line)
    return 0
