"""The port's request-span tracer, held against the reference's: the span
sequence an engine records (kind, request id and data; times, durations
and the time-derived ``queue_wait_s`` left out, the windowed samples too)
equals the JAX engine's on the same trace and packs, on both KV layouts,
under speculative decode, with the error probe and under ``nan@3``
quarantine; the ring buffer and the Chrome export equal the reference's
byte for byte on the same events; ``tools/trace_report.py`` reads the
port's traces.  olmo-1b-reduced with float32 compute and a float32 KV
cache; the probe's float moments agree to ``RTOL`` (the two packages'
float32 GEMMs sum in different orders), everything else is equal."""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.launch.serve import ServeConfig as JaxServeConfig
from repro.launch.serve import build_serving_params as jax_build_serving_params
from repro.numerics import get_preset as jax_get_preset
from repro.quant.faults import FaultInjector as JaxInjector
from repro.quant.faults import FaultSpec as JaxFaultSpec
from repro.serving import ServingEngine as JaxEngine
from repro.serving import telemetry as jax_telemetry
from repro_torch.configs import EngineConfig
from repro_torch.launch.serve import ServeConfig, build_serving_params
from repro_torch.models import build_model
from repro_torch.numerics import get_preset
from repro_torch.quant.faults import FaultInjector, FaultSpec
from repro_torch.serving import ServingEngine, telemetry

from _torch_port import jax_side, torch_side

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import trace_report  # noqa: E402

#: relative tolerance of the probe spans' error moments
RTOL = 1e-4
SLOTS, MAX_LEN, CHUNK = 2, 48, 16
#: span data fields read off a clock
TIMED = {"queue_wait_s"}


@pytest.fixture(scope="module")
def sides():
    jcfg, _, jparams = jax_side()
    tcfg, _, tparams = torch_side()
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    tcfg = dataclasses.replace(tcfg, compute_dtype="float32")
    packs = {name: (
        jax_build_serving_params(jparams, jcfg, JaxServeConfig(
            spec=jax_get_preset(name))),
        build_serving_params(tparams, tcfg, ServeConfig(
            spec=get_preset(name)), device="cpu"))
        for name in ("serve-default", "int8")}
    return jcfg, tcfg, packs, build_model(tcfg, "cpu")


def _trace(vocab, seed=3):
    """Three requests on two slots (a capacity stall), one prompt past a
    chunk and one sharing its first 16 tokens (a prefix hit when paged)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 20).tolist()
    return [(shared, 6), (rng.integers(0, vocab, 7).tolist(), 5),
            (shared[:16] + rng.integers(0, vocab, 3).tolist(), 4)]


def _engines(sides, pack, layout="contiguous", draft=None, **kw):
    """(port engine, JAX engine), traced, on ``pack`` (and ``draft``)."""
    jcfg, tcfg, packs, api = sides
    ekw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
               cache_dtype="float32", kv_layout=layout, kv_block_size=8,
               trace=True, **{k: kw.pop(k) for k in (
                   "error_probe_every", "detect_faults", "speculative_k")
                   if k in kw})
    inj = kw.pop("inject", None)
    teng = ServingEngine(
        tcfg, packs[pack][1], EngineConfig(**ekw), api=api, numerics=pack,
        draft_params=packs[draft][1] if draft else None,
        draft_numerics=draft,
        fault_injector=FaultInjector(FaultSpec.parse(inj)) if inj else None)
    jeng = JaxEngine(
        jcfg, packs[pack][0], JaxEngineConfig(**ekw), numerics=pack,
        draft_params=packs[draft][0] if draft else None,
        draft_numerics=draft,
        fault_injector=JaxInjector(JaxFaultSpec.parse(inj)) if inj else None)
    return teng, jeng


def _spans(eng):
    """(kind, rid, untimed data) of every span but the windowed samples."""
    return [(e.kind, e.rid, {k: v for k, v in (e.data or {}).items()
                             if k not in TIMED})
            for e in eng.tracer.events() if e.kind != "metrics_window"]


def _assert_same_spans(tspans, jspans):
    assert [(k, r) for k, r, _ in tspans] == [(k, r) for k, r, _ in jspans]
    for (kind, rid, t), (_, _, j) in zip(tspans, jspans):
        assert set(t) == set(j), (kind, rid)
        for key, want in j.items():
            if isinstance(want, float) and kind == "probe":
                assert t[key] == pytest.approx(want, rel=RTOL), (kind, key)
            else:
                assert t[key] == want, (kind, rid, key)


@pytest.mark.parametrize("case", [
    "contiguous", "paged", "speculative", "probe", "nan@3",
    "speculative-paged"])
def test_span_sequence_matches_reference(sides, case):
    layout = "paged" if case.endswith("paged") else "contiguous"
    kw = {}
    if case.startswith("speculative"):
        kw = dict(draft="serve-default", speculative_k=3)
    elif case == "probe":
        kw = dict(error_probe_every=2)
    elif case == "nan@3":
        kw = dict(inject="nan@3")
    pack = "serve-default" if case == "probe" else "int8"
    teng, jeng = _engines(sides, pack, layout, **kw)
    treqs = [teng.submit(p, g) for p, g in _trace(sides[1].vocab)]
    jreqs = [jeng.submit(p, g) for p, g in _trace(sides[1].vocab)]
    teng.run()
    jeng.run()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    tspans, jspans = _spans(teng), _spans(jeng)
    _assert_same_spans(tspans, jspans)
    kinds = {k for k, _, _ in tspans}
    assert set(telemetry.LIFECYCLE_KINDS) <= kinds
    want = {"contiguous": {"capacity_stall"}, "paged": {"prefix_hit"},
            "speculative": {"draft", "verify"}, "probe": {"probe"},
            "nan@3": {"fault_detected", "quarantine"},
            "speculative-paged": {"draft", "verify", "prefix_hit"}}[case]
    assert want <= kinds, kinds


def test_governor_switch_and_rejection_spans(sides):
    """A priority eviction and a queue-full rejection span; and a
    ``governor_switch`` span with the decision's fields."""
    from repro_torch.numerics import resolve_ladder
    from repro_torch.serving import GovernorConfig, NumericsGovernor

    jcfg, tcfg, packs, api = sides
    ecfg = EngineConfig(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
                        cache_dtype="float32", trace=True, max_queue=1)
    eng = ServingEngine(tcfg, packs["int8"][1], ecfg, api=api)
    eng.submit([1, 2, 3], 2, priority=1)
    eng.submit([1, 2, 3], 2, priority=0)  # evicts the first
    eng.submit([1, 2, 3], 2, priority=5)  # rejected: queue full
    kinds = [(e.kind, e.rid, e.data) for e in eng.tracer.events()]
    assert kinds[1] == ("evicted", 0, {"by": 1})
    assert kinds[3][0:2] == ("rejected", 2)
    assert "queue full" in kinds[3][2]["reason"]

    ladder = resolve_ladder([get_preset("serve-default"), "int8", "float"],
                            torch_side()[2])
    gov = NumericsGovernor(ladder, GovernorConfig(
        slo_err_var=1e-12, window_probes=1))
    eng = ServingEngine(
        tcfg, packs["serve-default"][1], dataclasses.replace(
            ecfg, max_queue=8, error_probe_every=1), api=api,
        numerics=ladder[0].name, governor=gov,
        pack_fn=lambda s: packs[s.name][1] if s else torch_side()[2])
    eng.submit(_trace(tcfg.vocab)[1][0], 4)
    eng.run()
    sw = [e for e in eng.tracer.events() if e.kind == "governor_switch"]
    assert sw and sw[0].data == {"step": 1,
                                 **gov.decisions[0].to_dict()}


def _tracers():
    """The same events recorded into a port and a reference tracer, on one
    epoch and clock."""
    out = []
    for mod in (telemetry, jax_telemetry):
        tr = mod.SpanTracer(capacity=6, engine="eng0", pid=3)
        tr.t0 = 100.0
        tr.record("queued", rid=3, t=100.5, prompt_len=7)
        tr.record("prefill_chunk", rid=3, t=100.75, dur=0.004, n_valid=7)
        tr.record("metrics_window", t=101.0, gen_tok_per_s=123.4,
                  numerics="int8", steps=9, ok=True)
        tr.record("cow_copy", t=101.25, copies=2)
        for i in range(5):  # past the capacity: the oldest evicted
            tr.record("decode_step", rid=i, t=102.0 + i, dur=0.001)
        out.append(tr)
    return out


def test_ring_eviction_and_exports_equal_reference(tmp_path):
    ttr, jtr = _tracers()
    assert len(ttr) == len(jtr) == 6 and ttr.dropped == jtr.dropped == 3
    assert [e.rid for e in ttr.events()] == [e.rid for e in jtr.events()]
    assert json.dumps(ttr.chrome_trace()) == json.dumps(jtr.chrome_trace())
    assert ttr.to_jsonl() == jtr.to_jsonl()
    for name in ("t.json", "t.jsonl"):
        ttr.write(str(tmp_path / f"port-{name}"))
        jtr.write(str(tmp_path / f"jax-{name}"))
        assert (tmp_path / f"port-{name}").read_bytes() == \
            (tmp_path / f"jax-{name}").read_bytes()
    assert telemetry.SPAN_KINDS == jax_telemetry.SPAN_KINDS
    assert len(telemetry.SPAN_KINDS) == 20
    assert telemetry.LIFECYCLE_KINDS == jax_telemetry.LIFECYCLE_KINDS
    with pytest.raises(ValueError, match="unknown span kind"):
        ttr.record("not-a-kind")
    with pytest.raises(ValueError, match="capacity"):
        telemetry.SpanTracer(capacity=0)
    ttr.clear()
    assert len(ttr) == 0 and ttr.dropped == 0


def test_chrome_trace_schema():
    ttr, _ = _tracers()
    doc = ttr.chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"] == {"engine": "eng0", "dropped_events": 3}
    for e in doc["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(e) and e["pid"] == 3
        if e["ph"] != "M":
            assert isinstance(e["ts"], float) and e["ts"] >= 0
    by = {e["name"]: e for e in doc["traceEvents"] if e["ph"] != "M"}
    assert by["cow_copy"]["ph"] == "i" and by["cow_copy"]["tid"] == 0
    assert by["decode_step"]["ph"] == "X"
    assert by["decode_step"]["dur"] == pytest.approx(1000.0)
    assert by["decode_step"]["tid"] == 5  # rid 4 + 1


@pytest.mark.parametrize("fmt", ["json", "jsonl"])
def test_trace_report_reads_port_traces(sides, tmp_path, fmt, capsys):
    """An engine trace with windowed samples (windows of 1 ms) through
    ``tools/trace_report.py``: every lifecycle stage, every request, the
    window counters; JSONL and Chrome load to the same events."""
    jcfg, tcfg, packs, api = sides
    eng = ServingEngine(tcfg, packs["int8"][1], EngineConfig(
        slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
        cache_dtype="float32", trace=True, metrics_window_s=0.001),
        api=api, numerics="int8")
    for p, g in _trace(tcfg.vocab):
        eng.submit(p, g)
    eng.run()
    assert eng.snapshot()["timeseries_samples"] == \
        len(eng.metrics.timeseries) > 0
    path = tmp_path / f"trace.{fmt}"
    eng.tracer.write(str(path))
    assert trace_report.main([str(path), "--assert-lifecycle"]) == 0
    capsys.readouterr()
    assert trace_report.main([str(path), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["events"] == len(eng.tracer)
    assert len(rep["requests"]) == 3
    assert rep["kinds"]["metrics_window"] == len(eng.metrics.timeseries)
    events = trace_report.load_events(str(path))
    assert [e["kind"] for e in events] == [e.kind for e in
                                           eng.tracer.events()]
