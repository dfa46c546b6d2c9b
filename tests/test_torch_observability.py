"""The port's metrics windows, fleet merge, OpenMetrics export and A/B
shadow serving, held against the reference on olmo-1b-reduced (float32
compute and KV cache):

* ``EngineMetrics.merge`` and ``to_openmetrics`` of the port equal the
  reference's on the reference's own engine snapshots (the merged dicts
  equal, the exposition text byte for byte), and the port engine's
  snapshot has the reference's keys, nested sections too;
* merge is associative (floats to ``1e-12`` relative: a flat merge and a
  merge of merges associate their sums differently);
* the windowed samples of the same recording sequence, on one fake clock,
  equal the reference's, and the per-window probe series resets at every
  roll;
* the serve CLI's ``--assert-layer-breach``, ``--prom-out`` and the
  snapshot's key set against the JAX CLI's;
* the shadow verdict against the JAX engine's (token match and power
  equal, the logit-delta moments to ``RTOL``: the two packages' float32
  GEMMs sum in different orders), the shadow control exact, and the
  refusals."""

import dataclasses
import json

import numpy as np
import pytest

from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.launch.serve import ServeConfig as JaxServeConfig
from repro.launch.serve import build_serving_params as jax_build_serving_params
from repro.launch.serve import main as jax_serve_main
from repro.numerics import get_preset as jax_get_preset
from repro.serving import ServingEngine as JaxEngine
from repro.serving import metrics as jax_metrics
from repro.serving import prom as jax_prom
from repro_torch.configs import EngineConfig
from repro_torch.launch.serve import ServeConfig, build_serving_params
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.numerics import get_preset
from repro_torch.serving import EngineMetrics, ServingEngine, prom
from repro_torch.serving import metrics as port_metrics

from _torch_port import RWKV_ARCH, jax_side, torch_side

#: relative tolerance of the shadow's logit-delta moments
RTOL = 1e-4
SLOTS, MAX_LEN, CHUNK = 2, 48, 16
CLI = ["--requests", "4", "--slots", "2", "--max-len", "48", "--chunk", "8"]


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


def _trace(vocab, n=4, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(4, 20))).tolist(), 5)
            for _ in range(n)]


#: (primary pack, engine config fields, engine keyword packs)
CONFIGS = {
    "probe+shadow": ("serve-default", dict(error_probe_every=2,
                                           shadow_fraction=0.5),
                     {"shadow_params": "int8"}),
    "paged speculative": ("int8", dict(kv_layout="paged", speculative_k=3),
                          {"draft_params": "serve-default"}),
    "plain": ("int8", {}, {}),
}


def _pair(sides, name):
    """(port engine, JAX engine) of one CONFIGS entry, served."""
    jcfg, tcfg, packs, api = sides
    pack, fields, kwpacks = CONFIGS[name]
    ekw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
               cache_dtype="float32", kv_block_size=8, **fields)
    labels = {"shadow_params": "shadow_numerics",
              "draft_params": "draft_numerics"}
    out = []
    for side, cls, ecls in ((1, ServingEngine, EngineConfig),
                            (0, JaxEngine, JaxEngineConfig)):
        kw = {k: packs[v][side] for k, v in kwpacks.items()}
        kw.update({labels[k]: v for k, v in kwpacks.items()})
        if side:
            kw["api"] = api
        eng = cls((tcfg, jcfg)[side == 0], packs[pack][side], ecls(**ekw),
                  numerics=pack, **kw)
        reqs = [eng.submit(p, g) for p, g in _trace(tcfg.vocab)]
        eng.run()
        assert all(r.finished for r in reqs)
        out.append((eng, [r.generated for r in reqs]))
    (teng, ttoks), (jeng, jtoks) = out
    assert ttoks == jtoks
    return teng, jeng


@pytest.fixture(scope="module")
def served(sides):
    return {name: _pair(sides, name) for name in CONFIGS}


def _close(a, b, rel=1e-12):
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rel)
                                            for k in a)
    if isinstance(a, float) and isinstance(b, float):
        return a == pytest.approx(b, rel=rel)
    return a == b


def _keys(snap, prefix=""):
    """Every key path of a snapshot, nested sections included (the
    layer-keyed maps by their first entry's keys)."""
    out = set()
    for k, v in snap.items():
        path = f"{prefix}/{k}" if prefix else k
        out.add(path)
        if isinstance(v, dict) and k not in ("tokens_by_numerics",):
            if k in ("layers", "per_tier", "per_layer") and v:
                out |= {f"{path}/*/{kk}" for kk in next(iter(v.values()))}
            elif k not in ("layers", "per_tier", "per_layer"):
                out |= _keys(v, path)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_snapshot_keys_and_counters_match_reference(served, name):
    teng, jeng = served[name]
    ts, js = teng.snapshot(), jeng.metrics.snapshot()
    assert _keys(ts) == _keys(js)
    for key, want in js.items():
        if key in ("elapsed_s", "gen_tok_per_s", "total_tok_per_s") \
                or key.startswith(("ttft_", "itl_", "latency_mean")):
            continue  # read off the clock
        if isinstance(want, dict) or key == "error_probe":
            continue  # moments: below and in test_torch_faults_probe.py
        assert ts[key] == want, key


def test_merge_and_openmetrics_equal_reference(served):
    """The reference's own snapshots through both packages' merge and
    exporter: equal dicts, byte-equal text, one snapshot at a time and
    merged."""
    snaps = [served[n][1].metrics.snapshot() for n in CONFIGS]
    pm, jm = EngineMetrics.merge(snaps), jax_metrics.EngineMetrics.merge(
        snaps)
    assert json.dumps(pm) == json.dumps(jm)
    assert pm["numerics"] == "mixed" and pm["engines"] == 3
    for s in snaps + [pm]:
        for labels in (None, {"engine": "a\"b"}):
            text = prom.to_openmetrics(s, labels=labels)
            assert text == jax_prom.to_openmetrics(s, labels=labels)
            assert prom.parse_openmetrics(text) == \
                jax_prom.parse_openmetrics(text)
    assert EngineMetrics.merge([]) == {}
    assert EngineMetrics.merge([snaps[0]]) == \
        jax_metrics.EngineMetrics.merge([snaps[0]])


def test_merge_is_associative(served):
    a, b, c = (served[n][0].snapshot() for n in CONFIGS)
    merge = EngineMetrics.merge
    flat = merge([a, b, c])
    assert _close(merge([merge([a, b]), c]), flat)
    assert _close(merge([a, merge([b, c])]), flat)
    assert flat["generated_tokens"] == sum(
        s["generated_tokens"] for s in (a, b, c))
    assert flat["shadow"]["sampled_requests"] == a["shadow"][
        "sampled_requests"]
    assert flat["acceptance_by_draft_spec"] == b["acceptance_by_draft_spec"]


class _Clock:
    """One fake clock for both packages' metrics modules."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now

    time = perf_counter


def _record(m, clock):
    """A recording sequence touching every window field: steps with block
    stats, probes, a shadow replay, drafts, a governor switch."""
    m.set_power_profile("sd", {"blocks/0/q": {"mac_per_token": 64.0,
                                              "saving_pct": 30.0}})
    blocks = {"block_util": 0.5, "block_frag": 0.25, "blocks_total": 8,
              "peak_blocks_in_use": 4, "prefix_cache_entries": 1,
              "cow_copies": 0, "prefix_evictions": 0}
    report = lambda v, p: {"row": 0,  # noqa: E731
                           "layers": {p: {"n": 4, "mean": 0.1, "var": v}},
                           "logits": {"n": 8, "mean": 0.0, "var": v,
                                      "max_abs": 1.0}}
    m.start_clock()
    m.record_step("prefill", 0.5, 2, prompt_tokens=16, block_stats=blocks)
    m.record_probe(report(2.0, "blocks/0/q"))
    m.record_shadow({"tokens": 4, "matches": 3,
                     "logits_err": {"n": 40, "mean": 0.1, "var": 0.5,
                                    "max_abs": 2.0}})
    clock.now += 0.6
    m.record_step("spec", 1.0, 1, generated_tokens=3, block_stats=blocks,
                  drafted=4, accepted=2, draft_calls=3)
    m.governor_switches += 1
    m.record_probe(report(8.0, "blocks/1/k"))
    clock.now += 0.7
    m.record_step("decode", 1.0, 0, generated_tokens=2, block_stats=blocks)
    clock.now += 0.1


def test_windowed_samples_equal_reference(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(port_metrics, "time", clock)
    monkeypatch.setattr(jax_metrics, "time", clock)
    seen = []
    ms = [EngineMetrics(numerics="sd", window_s=0.5, speculative_k=3,
                        draft_numerics="d", shadow_numerics="sh",
                        on_window_sample=seen.append),
          jax_metrics.EngineMetrics(numerics="sd", window_s=0.5,
                                    speculative_k=3, draft_numerics="d",
                                    shadow_numerics="sh")]
    for m in ms:
        clock.now = 1000.0
        _record(m, clock)
    port, ref = ms
    assert list(port.timeseries) == list(ref.timeseries)
    assert seen == list(port.timeseries) and len(seen) == 2
    assert port.snapshot() == ref.snapshot()
    # each window carries its own probes only: moments are not diffable
    w1, w2 = seen
    assert set(w1["probe_layers"]) == {"blocks/0/q"}
    assert set(w2["probe_layers"]) == {"blocks/1/k"}
    assert w2["probe_layers"]["blocks/1/k"] == pytest.approx(8.0)
    assert w2["governor_switches"] == 1 and w1["spec_rounds"] == 1
    assert set(port.snapshot()["error_probe"]["layers"]) == {
        "blocks/0/q", "blocks/1/k"}
    assert port.snapshot()["timeseries_samples"] == 2


def test_reservoir_capped_and_samples_keys():
    r = port_metrics.Reservoir(cap=16)
    for i in range(1000):
        r.push(float(i))
    assert r.n == 1000 and len(r.samples) == 16 and r.capped == 984
    assert r.mean == pytest.approx(499.5) and r.max == 999.0
    m = EngineMetrics()
    for _ in range(3):
        m.ttfts.push(0.5)
    snap = m.snapshot()
    assert snap["ttft_samples"] == 3 and snap["ttft_samples_capped"] == 0
    assert snap["metrics_window_s"] is None


def _json_block(out: str) -> dict:
    return json.loads(out[out.index("\n{") + 1:out.index("\n}") + 2])


def test_cli_snapshot_keys_and_prom_match_jax_cli(tmp_path, capsys):
    """``--prom-out`` and ``--metrics-window``: the JSON snapshot's keys
    and the schedule's counters equal the JAX CLI's, and both exposition
    files name the same series."""
    flags = CLI + ["--metrics-window", "0.01"]
    serve_main(["--device", "cpu"] + flags + [
        "--prom-out", str(tmp_path / "port.prom")])
    tsnap = _json_block(capsys.readouterr().out)
    jax_serve_main(flags + ["--prom-out", str(tmp_path / "jax.prom")])
    jsnap = _json_block(capsys.readouterr().out)
    assert _keys(tsnap) == _keys(jsnap)
    for key in ("requests_finished", "prompt_tokens", "generated_tokens",
                "prefill_steps", "mixed_steps", "decode_steps",
                "metrics_window_s", "decode_specialized"):
        assert tsnap[key] == jsnap[key], key
    names = [{n for n, _ in prom.parse_openmetrics(
        (tmp_path / f"{side}.prom").read_text())} for side in ("port", "jax")]
    assert names[0] == names[1]
    assert prom.main([str(tmp_path / "port.prom"), "--require",
                      "repro_generated_tokens"]) == 0
    assert prom.main([str(tmp_path / "port.prom"), "--require",
                      "repro_no_such_series"]) == 1


def test_cli_assert_layer_breach(tmp_path, capsys):
    """A per-layer ceiling every layer breaches: the governor escalates
    with reason ``layer_slo_breach`` and the layer is in the windowed
    per-layer series; the trace holds the windows and the switch."""
    serve_main(["--device", "cpu"] + CLI + [
        "--mode", "perforated", "--m", "2", "--governor", "--slo-err-var",
        "1e6", "--layer-slo", "blocks/*=1e-12", "--error-probe-every", "1",
        "--metrics-window", "0.0001", "--assert-layer-breach", "blocks/*",
        "--trace-out", str(tmp_path / "t.jsonl")])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if "layer-SLO breach:" in ln]
    assert line and "escalated" in line[0]
    kinds = {json.loads(ln)["kind"]
             for ln in (tmp_path / "t.jsonl").read_text().splitlines()}
    assert {"metrics_window", "governor_switch", "probe"} <= kinds


def test_shadow_verdict_matches_reference(served):
    teng, jeng = served["probe+shadow"]
    tv, jv = teng.shadow_verdict(), jeng.shadow_verdict()
    assert tv is not None and tv["sampled_requests"] == 2
    for key, want in jv.items():
        if key in ("logits_err_var", "logits_err_max_abs"):
            assert tv[key] == pytest.approx(want, rel=RTOL), key
        else:
            assert tv[key] == want, key
    ts, js = teng.snapshot()["shadow"], jeng.metrics.snapshot()["shadow"]
    for key in ("sampled_requests", "tokens", "token_matches",
                "token_match_rate", "logits_err_n", "numerics"):
        assert ts[key] == js[key], key
    assert ts["logits_err_var"] == pytest.approx(js["logits_err_var"],
                                                 rel=RTOL)
    assert teng.compile_count() == 2  # replays are not engine dispatches


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_shadow_control_is_exact(sides, layout):
    """The int8 pack shadows itself: the primary's tokens unperturbed,
    every replayed token matched, a logit delta of exactly 0."""
    _, tcfg, packs, api = sides
    trace = _trace(tcfg.vocab, n=3, seed=11)

    def run(shadow):
        eng = ServingEngine(tcfg, packs["int8"][1], EngineConfig(
            slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
            cache_dtype="float32", kv_layout=layout, kv_block_size=8,
            shadow_fraction=1.0 if shadow else 0.0), api=api,
            numerics="int8",
            shadow_params=packs["int8"][1] if shadow else None,
            shadow_numerics="int8" if shadow else None)
        reqs = [eng.submit(p, g) for p, g in trace]
        eng.run()
        return [r.generated for r in reqs], eng

    baseline, _ = run(False)
    shadowed, eng = run(True)
    assert shadowed == baseline
    v = eng.shadow_verdict()
    assert v["sampled_requests"] == 3 and v["token_match_rate"] == 1.0
    assert v["logits_err_var"] == 0.0 and v["logits_err_max_abs"] == 0.0
    assert v["power_delta_pct"] == 0.0 and v["verdict"] == "keep-primary"
    assert eng.snapshot()["shadow"]["token_match_rate"] == 1.0


def test_shadow_refusals(sides, capsys):
    from repro_torch.numerics import resolve_ladder
    from repro_torch.serving import GovernorConfig, NumericsGovernor

    _, tcfg, packs, api = sides
    base = dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
                cache_dtype="float32")
    pk = packs["int8"][1]
    with pytest.raises(ValueError, match="needs shadow_params"):
        ServingEngine(tcfg, pk, EngineConfig(**base, shadow_fraction=0.5),
                      api=api)
    with pytest.raises(ValueError, match="speculative decode"):
        ServingEngine(tcfg, pk, EngineConfig(
            **base, shadow_fraction=0.5, speculative_k=2), api=api,
            draft_params=pk, shadow_params=pk)
    ladder = resolve_ladder([get_preset("serve-default"), "int8", "float"],
                            torch_side()[2])
    with pytest.raises(ValueError, match="governor"):
        ServingEngine(tcfg, pk, EngineConfig(
            **base, shadow_fraction=0.5, error_probe_every=1), api=api,
            governor=NumericsGovernor(ladder, GovernorConfig(
                slo_err_var=1.0)), pack_fn=lambda s: pk, shadow_params=pk)
    with pytest.raises(ValueError, match=r"\(0, 1\]"):
        ServingEngine(tcfg, pk, EngineConfig(**base, shadow_fraction=2.0),
                      api=api, shadow_params=pk)
    rcfg, rapi, rparams = torch_side(RWKV_ARCH)
    with pytest.raises(NotImplementedError, match="recurrent RWKV"):
        ServingEngine(rcfg, rparams, EngineConfig(
            **base, shadow_fraction=0.5), api=rapi, shadow_params=rparams)
    for flags, match in ((["--speculative-k", "2"], "--speculative-k"),
                         (["--governor", "--slo-err-var", "1"],
                          "--governor")):
        with pytest.raises(SystemExit, match=match):
            serve_main(["--device", "cpu"] + CLI + [
                "--shadow-spec", "int8"] + flags)


def test_cli_shadow(capsys):
    serve_main(["--device", "cpu"] + CLI + [
        "--shadow-spec", "int8", "--shadow-fraction", "0.5",
        "--assert-shadow"])
    out = capsys.readouterr().out
    assert "shadow A/B [" in out and "vs int8]" in out
    snap = _json_block(out)
    assert snap["shadow"]["sampled_requests"] == 2
    assert snap["shadow"]["numerics"] == "int8"
