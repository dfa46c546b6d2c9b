"""The paper's benches on the port, one module per table or figure.

    python -m repro_torch.paper.run                    # all, on the card
    python -m repro_torch.paper.run table1 fig10 ...   # some
    python -m repro_torch.paper.run table1 conv_error --device cpu

Prints one CSV-ish line per row, ``name,us_per_call,{json}``, the
reference harness's format (``benchmarks/run.py``); a suite that fails
prints one ``<suite>/ERROR`` row and the others still run.  Table 1, the
conv-error bench and Tables 2-4 run on ``--device`` (default the card);
the cost-model suites and Fig. 10 run on the host.  TF32 is off: the
benches compute in true float32.
"""

from __future__ import annotations

import argparse
import importlib
import json
import time

import torch

SUITES = [
    ("table1", "repro_torch.paper.table1_error"),
    ("conv_error", "repro_torch.paper.conv_error_validation"),
    ("tables2_4", "repro_torch.paper.tables2_4_accuracy"),
    ("fig7_9", "repro_torch.paper.fig7_9_power"),
    ("table5", "repro_torch.paper.table5_overhead"),
    ("fig10", "repro_torch.paper.fig10_pareto"),
]
#: the suites whose ``run`` takes a device
ON_DEVICE = {"table1", "conv_error", "tables2_4"}


def _emit(rows: list[dict]) -> None:
    for r in rows:
        name = r.pop("name", "?")
        us = r.pop("us_per_call", "")
        derived = json.dumps(r, sort_keys=True, default=str)
        print(f"{name},{us},{derived}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("suites", nargs="*", choices=[k for k, _ in SUITES],
                    help="suites to run (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = set(args.suites)
    t0 = time.time()
    for key, modname in SUITES:
        if want and key not in want:
            continue
        print(f"# --- {key} ({modname}) ---", flush=True)
        mod = importlib.import_module(modname)
        kw = {"device": args.device} if key in ON_DEVICE else {}
        try:
            rows = mod.run(**kw)
        except Exception as e:  # a failed suite must not hide the others
            rows = [{"name": f"{key}/ERROR",
                     "error": f"{type(e).__name__}: {e}"}]
        _emit(rows)
    print(f"# total {time.time() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
