"""The import check: nothing the harness or the references load has the
top-level name ``jax``, ``jaxlib``, ``flax`` or ``repro`` (names compared
whole: ``repro_torch`` is the port), and the references and the frozen
arithmetic load nothing of the program either."""

import json
import subprocess
import sys

from port_bench.tiny import ROOT

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            src=str(ROOT / "src"), body=body)],
        capture_output=True, text=True, timeout=300, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_references_load_nothing_of_the_program_or_jax():
    tops = loaded("import port_bench.ref_lm, port_bench.ref_cnn, "
                  "port_bench.approx_ref, port_bench.weights, "
                  "port_bench.traffic, port_bench.peaks")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_a_run_of_each_cell_loads_no_jax():
    tops = loaded(
        "from port_bench import harness, tiny\n"
        "for name in ('olmo-1b.docs', 'resnet44-c10.eval'):\n"
        "    harness.run_cell(tiny.cell(name, seconds=0.5))\n"
        "assert harness.forbidden_loaded() == []")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_names_are_compared_whole():
    from port_bench import harness

    assert harness.forbidden_loaded(
        ["repro_torch", "repro_torch.serving", "jax_free", "reproducible"]) == []
    assert harness.forbidden_loaded(
        ["repro.core", "jaxlib.xla_client", "flax", "jax"]) == [
            "flax", "jax", "jaxlib", "repro"]
