"""The port's command lines against the reference's: the serve CLI (the
engine path and the ``plan`` subcommand), the train CLI, the dry run and
``serving.prom`` take the reference's flags (the port adds a named few),
the reference's documented ``--engine`` invocation serves on the CPU,
``--legacy`` wins over ``--engine``, and the dry run's ``--force``,
``[cached]`` and ``--variant`` behave as the reference's."""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.serving import prom as tprom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (reference module, argv before --help, the port's main, flags only the
#: port has)
CLIS = {
    "serve": ("repro.launch.serve", [], tserve.main, {"--device"}),
    "serve plan": ("repro.launch.serve", ["plan"], tserve.main, set()),
    "train": ("repro.launch.train", [], ttrain.main, {"--device"}),
    "dryrun": ("repro.launch.dryrun", [], dryrun.main,
               {"--backend", "--out", "--workers"}),
    "prom": ("repro.serving.prom", [], tprom.main, set()),
}

#: an option line of argparse's help: two spaces, then the option strings
_OPTION = re.compile(r"^  (-[^ ].*?)(?:  |$)")


def _flags(help_text: str) -> set[str]:
    out = set()
    for line in help_text.splitlines():
        m = _OPTION.match(line)
        if m:
            out.update(tok.rstrip(",") for tok in m.group(1).split()
                       if tok.startswith("--"))
    return out


def _help(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(argv + ["--help"])
    return buf.getvalue()


@pytest.fixture(scope="module")
def reference_flags() -> dict[str, set[str]]:
    """Each reference CLI's ``--help`` flags, from one subprocess (the
    reference's dry run sets XLA_FLAGS when imported)."""
    code = (
        "import contextlib, importlib, io, json, sys\n"
        f"clis = {json.dumps({k: [m, a] for k, (m, a, _, _) in CLIS.items()})}\n"
        "out = {}\n"
        "for name, (mod, argv) in clis.items():\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        try:\n"
        "            importlib.import_module(mod).main(argv + ['--help'])\n"
        "        except SystemExit:\n"
        "            pass\n"
        "    out[name] = buf.getvalue()\n"
        "sys.stdout.write(json.dumps(out))\n")
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    return {k: _flags(v) for k, v in json.loads(res.stdout).items()}


@pytest.mark.parametrize("name", list(CLIS))
def test_flags_equal_the_reference(name, reference_flags):
    _, argv, main, port_only = CLIS[name]
    mine = _flags(_help(main, argv))
    want = reference_flags[name]
    assert want, f"no flags parsed from the reference's {name} --help"
    assert port_only <= mine
    assert mine - port_only == want, (
        f"port only: {sorted(mine - port_only - want)}, reference only: "
        f"{sorted(want - mine)}")


def _serve(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tserve.main(argv) == 0
    return buf.getvalue()


ENGINE_ARGV = ["--engine", "--arch", "olmo-1b-reduced", "--mode",
               "perforated", "--m", "2", "--slots", "4", "--max-len", "64",
               "--chunk", "16", "--requests", "4", "--device", "cpu"]


def test_engine_invocation_serves_every_request():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = _serve(ENGINE_ARGV)
    finally:
        torch.set_num_threads(n)
    assert "finished 4/4 requests, 2 compiled shapes" in out
    snap = json.loads(out[out.index("\n{") + 1:out.index("\n}") + 2])
    assert snap["requests_finished"] == 4


def test_legacy_wins_over_engine():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = _serve(["--engine", "--legacy", "--arch", "olmo-1b-reduced",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3",
                      "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert "generated 2x3 tokens" in out and "finished" not in out


#: a cell the reference's rules skip (an encoder has no decode): its record
#: comes back without counting a step
SKIP_CELL = ["--arch", "hubert-xlarge", "--shape", "decode_32k",
             "--multi-pod", "single"]


def _dryrun(argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.main(SKIP_CELL + argv)
    return buf.getvalue().splitlines()


def test_dryrun_force_cached_and_variant(tmp_path):
    out = tmp_path / "dryrun"
    rec = out / "hubert-xlarge__decode_32k__singlepod.json"
    lines = _dryrun(["--out", str(out)])
    assert lines[0].startswith("[skip] hubert-xlarge decode_32k "
                               "multi_pod=False")
    assert json.loads(rec.read_text())["status"] == "skip"
    rec.write_text(json.dumps({**json.loads(rec.read_text()), "mark": 1}))
    # a second run reports the cell cached and leaves its record
    lines = _dryrun(["--out", str(out)])
    assert lines[0] == "[cached] hubert-xlarge decode_32k multi_pod=False"
    assert "dry run: 0 cells" in lines[1]
    assert json.loads(rec.read_text())["mark"] == 1
    # --force recomputes it
    lines = _dryrun(["--out", str(out), "--force"])
    assert lines[0].startswith("[skip] hubert-xlarge")
    assert "mark" not in json.loads(rec.read_text())
    # --variant labels the cell and writes beside, in perf/
    lines = _dryrun(["--out", str(out), "--variant", "sp"])
    assert lines[0].startswith("[skip] hubert-xlarge decode_32k "
                               "multi_pod=False variant=sp")
    var = tmp_path / "perf" / "hubert-xlarge__decode_32k__singlepod__sp.json"
    assert json.loads(var.read_text())["status"] == "skip"
    assert sorted(p.name for p in out.iterdir()) == [rec.name]
    assert _dryrun(["--out", str(out), "--variant", "sp"])[0] == (
        "[cached] hubert-xlarge decode_32k multi_pod=False")
