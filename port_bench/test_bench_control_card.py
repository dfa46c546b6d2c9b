"""The controls of the correctness check, on the card at each cell's own
size: for olmo-1b (bfloat16 stated) the program's int8 KV cache and the
reference with its activations in float8 (e4m3) in the program's place,
for the ResNet (float32 stated) the reference in bfloat16 activations.
Each comes out not correct.  Skipped without a card."""

import time

import pytest

from port_bench import harness
from port_bench.tiny import ROOT

pytestmark = pytest.mark.card


@pytest.mark.parametrize("name,hooks,compared", [
    ("olmo-1b.docs", {"control_cache": "int8"},
     ["control_cache_kv_rel_err"]),
    ("olmo-1b.docs", {"control_ref": "float8_e4m3fn"},
     ["control_ref_kv_rel_err", "control_ref_logit_decorr"]),
    ("resnet44-c10.eval", {"control_dtype": "bfloat16"},
     ["control_logit_gap_rel"])])
def test_control_is_not_correct(card, name, hooks, compared):
    cell = harness.load_cell(ROOT, name, 31_337, 12.0, False, "cuda",
                             time.perf_counter())
    cell.hooks = hooks
    line = harness.run_cell(cell)
    for check in compared:
        c = line["checks"][check]
        assert c["value"] > c["limit"], line["checks"]
