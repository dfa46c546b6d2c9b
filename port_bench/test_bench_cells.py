"""A tiny CPU run of each cell's path (its runner, traffic, readers and
reference at reduced widths, on the plain kernels) prints a well-formed
last line; the harness refuses to run without a card."""

import io
import json
import math
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from port_bench import harness, tiny


def well_formed(line: dict, cell) -> None:
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    names = {m["name"] for m in cell.metrics}
    assert set(line["metrics"]) <= names
    for m in cell.metrics:
        if m["name"] in line["metrics"]:
            v = line["metrics"][m["name"]]
            assert v["unit"] == m["unit"] and math.isfinite(v["value"])
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", ["olmo-1b.docs", "resnet44-c10.eval"])
def test_tiny_run_prints_a_well_formed_last_line(name):
    cell = tiny.cell(name, seconds=1.0)
    line = harness.run_cell(cell)
    well_formed(line, cell)
    # every end-to-end metric of the cell is there
    assert set(line["metrics"]) == {m["name"] for m in cell.metrics}
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.emit(line)
    assert json.loads(out.getvalue().splitlines()[-1]) == line
    assert err.getvalue().splitlines()[-1].startswith("check ")


def test_tiny_traced_run_reads_the_engine_counters():
    cell = tiny.cell("olmo-1b.docs", seconds=2.0, trace=True)
    line = harness.run_cell(cell)
    well_formed(line, cell)
    # no device on the CPU: the device readers find nothing to read
    assert {"row_fill_pct.serve", "engine_host_ms.serve",
            "mfu.serve"} <= set(line["metrics"])
    assert "device_idle_pct.serve" not in line["metrics"]


def test_the_same_seed_gives_the_same_inputs():
    from port_bench import traffic, weights
    import torch

    c = tiny.cell("olmo-1b.docs")
    a = traffic.requests(c.traffic, 2**31 + 5, 256)
    b = traffic.requests(c.traffic, 2**31 + 5, 256)
    assert [next(a) for _ in range(20)] == [next(b) for _ in range(20)]
    arch = c.config["arch"]
    assert torch.equal(weights.lm_layer(arch, 2**31 + 5, 1, "cpu")["up"],
                       weights.lm_layer(arch, 2**31 + 5, 1, "cpu")["up"])


def test_every_seed_serves_the_same_sizes():
    from port_bench import traffic

    c = tiny.cell("olmo-1b.docs")
    n = c.traffic["strata"]

    def sizes(seed):
        g = traffic.requests(c.traffic, seed, 256)
        return sorted((len(p), o) for p, o in (next(g) for _ in range(n)))

    one = sizes(1)
    assert [s[0] for s in one] == sorted(s[0] for s in sizes(2**33))
    assert sorted(s[1] for s in one) == sorted(s[1] for s in sizes(2**33))


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = subprocess.run(
        [sys.executable, str(tiny.ROOT / "port_bench" / "run.py"),
         "--workload", "olmo-1b.docs", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tiny.ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
