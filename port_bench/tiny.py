"""Cells of the benchmark at a size a CPU test run can hold: the cell's
own runner, traffic kind and reference, at reduced widths on the plain
kernels (the program's wrappers take CPU tensors to their plain
versions).  The limits here are set from readings at this size, not the
cells'."""

from __future__ import annotations

import pathlib
import sys
import time

from port_bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.append(str(ROOT / "src"))

#: a sound tiny run of each kind reads a fifth to a third of these; a
#: broken one reads more
LIMITS = {"lm_engine": {"kv": [{"name": "kv_rel_err", "layers": [0, 1],
                                "limit": 0.5}],
                        "logit_decorr": 0.1, "token_not_greedy": 0},
          "cnn_eval": {"logit_gap_rel": 0.1}}


def cell(name: str, seed: int = 123_456_789_012, seconds: float = 1.0,
         trace: bool = False, hooks: dict | None = None) -> harness.Cell:
    c = harness.load_cell(ROOT, name, seed, seconds, trace, "cpu",
                          time.perf_counter())
    kind = c.config["kind"]
    if kind == "lm_engine":
        c.config["arch"].update(n_layers=2, d_model=64, n_heads=4,
                                kv_heads=4, d_ff=128, vocab=256,
                                compute_dtype="float32")
        c.traffic.update(
            clients=4, prompt_tokens={"dist": "lognormal", "median": 20,
                                      "sigma": 0.5, "min": 8, "max": 40},
            output_tokens={"dist": "uniform", "min": 2, "max": 8})
        c.traffic["engine"].update(slots=4, max_len=64, prefill_chunk=16)
    else:
        c.config["cnn"].update(width=8, depth=1, img_size=16)
        c.traffic.update(batch=20, pool=100, calib=20)
    c.config["checks"] = dict(LIMITS[kind])
    c.hooks = hooks or {}
    return c
