"""The port's robustness bookkeeping held against the reference package on
the same inputs: the accuracy-SLO governor (every scenario of the
reference's unit tests, decisions' ``to_dict()`` equal and validation
errors of the same type), the degradation ladder on olmo-1b-reduced, the
fault spec, row planning, logits corruption, the detector and the dense
noise (value for value), and the Chan merges of the probe's moments."""

import dataclasses
import json
import zlib

import numpy as np
import pytest
import torch

import repro.numerics.ladder as jax_ladder
import repro.quant.faults as jax_faults
import repro.serving.governor as jax_governor
import repro.serving.metrics as jax_metrics
import repro_torch.numerics.ladder as port_ladder
import repro_torch.quant.faults as port_faults
import repro_torch.serving.governor as port_governor
import repro_torch.serving.metrics as port_metrics

from _torch_port import jax_side, torch_side

SIDES = {"jax": (jax_governor, jax_ladder), "port": (port_governor, port_ladder)}


def _rungs(ladder, savings=(40.0, 10.0, 0.0)):
    return [ladder.LadderRung(name=f"rung{i}", spec=None, power_saving_pct=s)
            for i, s in enumerate(savings)]


def _probe(n=4, mean=0.0, var=0.0):
    return {"row": 0, "layers": {}, "logits": {"n": n, "mean": mean,
                                               "var": var, "max_abs": 1.0}}


def _layer_report(var, path="blocks/0/q"):
    return {"row": 0,
            "layers": {path: {"n": 4, "mean": 0.0, "var": var}},
            "logits": {"n": 4, "mean": 0.0, "var": var, "max_abs": 1.0}}


def _cfg(gov, **kw):
    kw.setdefault("slo_err_var", 1.0)
    kw.setdefault("window_probes", 2)
    kw.setdefault("clean_windows_to_relax", 2)
    return gov.GovernorConfig(**kw)


def _chunks():
    rng = np.random.default_rng(0)
    return [rng.normal(size=8) for _ in range(3)]


# (name, config kwargs, start rung, inputs): an input is a probe report, or
# "fault" for note_fault().  Together these are the scenarios of the
# reference's governor and layer-SLO unit tests.
SCENARIOS = [
    ("escalate_on_breach", {}, 0, [_probe(var=9.0)] * 2),
    ("relax_after_clean_windows", {}, 1, [_probe(var=0.0)] * 4),
    ("hysteresis_parks", {"relax_headroom": 0.25}, 1, [_probe(var=0.5)] * 10),
    ("severe_jumps_to_clearing_rung", {"severe_factor": 4.0}, 0,
     [_probe(var=9.0)] * 2),
    ("severe_stops_at_first_clearing_rung", {"severe_factor": 3.0}, 0,
     [_probe(var=3.9)] * 2),
    ("non_severe_walks_one_rung", {"severe_factor": 4.0}, 0,
     [_probe(var=2.0)] * 2),
    ("severe_fault_path_unchanged", {"severe_factor": 2.0}, 0, ["fault"]),
    ("fault_escalates_immediately", {}, 0,
     [_probe(var=0.0), "fault", "fault", "fault"]),
    ("zero_sample_probes_noop", {}, 0,
     [None, {}, {"logits": None}, _probe(n=0, var=99.0)]),
    ("estimate_chan_merges", {"window_probes": 1, "slo_err_var": 100.0}, 0,
     [_probe(n=len(c), mean=float(np.mean(c)), var=float(np.var(c)))
      for c in _chunks()]),
    ("history_resets_on_switch", {}, 0, [_probe(var=9.0)] * 2),
    ("breach_relax_cycle", {"relax_headroom": 0.5}, 0,
     [_probe(var=9.0)] * 2 + [_probe(var=0.1)] * 4 + [_probe(var=9.0)] * 2),
    ("layer_slo_names_layer",
     {"slo_err_var": 1e9, "layer_slo": {"blocks/0/*": 1e-4}}, 0,
     [_layer_report(1.0)] * 2),
    ("layer_slo_ignores_unwatched",
     {"slo_err_var": 1e9, "window_probes": 1,
      "layer_slo": {"blocks/7/*": 1e-4}}, 0,
     [_layer_report(50.0, path="blocks/0/q")]),
    ("layer_slo_first_match_wins",
     {"slo_err_var": 1e9, "window_probes": 1,
      "layer_slo": (("blocks/0/q", 100.0), ("blocks/0/*", 1e-6))}, 0,
     [_layer_report(1.0, path="blocks/0/q"),
      _layer_report(1.0, path="blocks/0/k")]),
]


def _play(side, kw, start, inputs):
    gov_mod, ladder = SIDES[side]
    gov = gov_mod.NumericsGovernor(_rungs(ladder), _cfg(gov_mod, **kw),
                                   start=start)
    trace = []
    for item in inputs:
        d = gov.note_fault() if item == "fault" else gov.observe_probe(item)
        trace.append((None if d is None else d.to_dict(), gov.rung.name,
                      gov.err_var_estimate, gov.windows_closed,
                      gov.first_breach_window, gov._win_probes,
                      sorted(gov.layer_err_estimates.items())))
    return trace


@pytest.mark.parametrize("name,kw,start,inputs", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_governor_scenarios_match_reference(name, kw, start, inputs):
    port = _play("port", kw, start, inputs)
    ref = _play("jax", kw, start, inputs)
    assert port == ref
    if name in ("escalate_on_breach", "severe_jumps_to_clearing_rung",
                "layer_slo_names_layer", "breach_relax_cycle"):
        assert any(d is not None for d, *_ in port)  # the scenario moves


INVALID = [
    {"slo_err_var": 0.0},
    {"slo_err_var": 1.0, "window_probes": 0},
    {"slo_err_var": 1.0, "relax_headroom": 1.5},
    {"slo_err_var": 1.0, "clean_windows_to_relax": 0},
    {"slo_err_var": 1.0, "severe_factor": 0.5},
    {"slo_err_var": 1.0, "layer_slo": {"": 1.0}},
    {"slo_err_var": 1.0, "layer_slo": {"blocks/*": -1.0}},
]


@pytest.mark.parametrize("kw", INVALID, ids=range(len(INVALID)))
def test_governor_config_validation_matches_reference(kw):
    errs = []
    for gov_mod, _ in SIDES.values():
        with pytest.raises(Exception) as e:
            gov_mod.GovernorConfig(**kw)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1] and errs[0][0] is ValueError


@pytest.mark.parametrize("case", ["one_rung", "start_past_end"])
def test_governor_construction_errors_match_reference(case):
    errs = []
    for gov_mod, ladder in SIDES.values():
        rungs = _rungs(ladder)
        with pytest.raises(ValueError) as e:
            if case == "one_rung":
                gov_mod.NumericsGovernor(rungs[:1], _cfg(gov_mod))
            else:
                gov_mod.NumericsGovernor(rungs, _cfg(gov_mod), start=3)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_decision_to_dict_and_power_delta():
    for gov_mod, ladder in SIDES.values():
        r = _rungs(ladder)
        d = gov_mod.GovernorDecision("relax", "clean_windows", r[1], r[0], 3,
                                     0.5, layer="blocks/0/q")
        assert d.power_delta_pct == 30.0
        assert d.to_dict() == {"action": "relax", "reason": "clean_windows",
                               "from": "rung1", "to": "rung0", "window": 3,
                               "err_var": 0.5, "power_delta_pct": 30.0,
                               "layer": "blocks/0/q"}


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------


def test_resolve_ladder_matches_reference_on_olmo_reduced():
    _, _, jparams = jax_side()
    _, _, tparams = torch_side()
    import repro.numerics as jn
    import repro_torch.numerics as tn

    ref = jn.resolve_ladder(jn.DEFAULT_LADDER, jparams)
    port = tn.resolve_ladder(tn.DEFAULT_LADDER, tparams)
    assert [(r.name, r.power_saving_pct) for r in port] == \
        [(r.name, r.power_saving_pct) for r in ref]
    assert port[0].power_saving_pct > 0 and port[-1].spec is None
    assert [r.spec.to_json() for r in port[:-1]] == \
        [r.spec.to_json() for r in ref[:-1]]
    for names in (["float", "serve-default"], ["int8"]):
        errs = []
        for mod, params in ((jn, jparams), (tn, tparams)):
            with pytest.raises(ValueError) as e:
                mod.resolve_ladder(names, params)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    assert tn.ladder_spec("float") == ("float", None)
    assert tn.ladder_spec("int8")[1].to_json() == \
        jn.ladder_spec("int8")[1].to_json()


def test_ladder_spec_reads_a_json_file(tmp_path):
    import repro.numerics as jn
    import repro_torch.numerics as tn

    path = tmp_path / "spec.json"
    path.write_text(jn.get_preset("serve-default").to_json())
    name, spec = tn.ladder_spec(str(path))
    assert (name, spec.to_json()) == (jn.ladder_spec(str(path))[0],
                                      jn.ladder_spec(str(path))[1].to_json())


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

GOOD_SPECS = ["nan@8", "nan@5", "inf@3", "spike@4", "spike@7@20-60",
              "dense-noise@2@10-50", "dense-noise@1@10-30",
              "dense-noise@1@blocks/0/*", "dense-noise@1@10-30@blocks/0/o",
              "nan@2@5-", "nan@2@-9"]
BAD_SPECS = ["bogus@2", "nan", "nan@0", "nan@2@9-3", "nan@1@1-2@a@b",
             "dense-noise@1@x@y"]


@pytest.mark.parametrize("text", GOOD_SPECS)
def test_fault_spec_parse_matches_reference(text):
    a = dataclasses.asdict(port_faults.FaultSpec.parse(text, seed=5))
    b = dataclasses.asdict(jax_faults.FaultSpec.parse(text, seed=5))
    assert a == b
    assert (port_faults.FaultSpec.parse(text).surface
            == jax_faults.FaultSpec.parse(text).surface)


@pytest.mark.parametrize("text", BAD_SPECS)
def test_fault_spec_bad_forms_match_reference(text):
    errs = []
    for mod in (jax_faults, port_faults):
        with pytest.raises(ValueError) as e:
            mod.FaultSpec.parse(text)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_fault_spec_validation_matches_reference():
    for kw in ({"kind": "nan", "every": 0}, {"rows": 0},
               {"start": 4, "stop": 4}):
        errs = []
        for mod in (jax_faults, port_faults):
            with pytest.raises(ValueError) as e:
                mod.FaultSpec(**kw)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_plan_rows_and_fires_match_reference():
    for rows, seed in ((1, 0), (2, 11), (3, 12)):
        spec = dict(kind="nan", every=4, rows=rows, seed=seed, start=2,
                    stop=40)
        a = port_faults.FaultInjector(port_faults.FaultSpec(**spec))
        b = jax_faults.FaultInjector(jax_faults.FaultSpec(**spec))
        live = [0, 1, 2, 3, 5]
        for step in range(48):
            assert a.fires(step) == b.fires(step)
            assert a.plan_rows(step, live) == b.plan_rows(step, live[::-1])
        assert a.plan_rows(0, []) == b.plan_rows(0, []) == []


@pytest.mark.parametrize("kind", ["nan", "inf", "spike"])
def test_corrupt_logits_and_suspect_rows_match_reference(kind):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 3, 16)).astype(np.float32)
    a = port_faults.FaultInjector(port_faults.FaultSpec(kind=kind, every=1,
                                                        scale=1e4))
    b = jax_faults.FaultInjector(jax_faults.FaultSpec(kind=kind, every=1,
                                                      scale=1e4))
    t = torch.from_numpy(logits.copy())
    out_p = a.corrupt_logits(2, t, [1, 3])
    out_j = b.corrupt_logits(2, logits, [1, 3])
    np.testing.assert_array_equal(out_p.numpy(), out_j)
    assert torch.equal(t, torch.from_numpy(logits))  # input untouched
    assert a.log == b.log == [("step", 2, kind, (1, 3))]
    assert (a.injected_rows, a.injected_steps) == (b.injected_rows,
                                                  b.injected_steps)
    cols = out_j[:, -1]
    np.testing.assert_array_equal(port_faults.suspect_rows(torch.from_numpy(cols)),
                                  jax_faults.suspect_rows(cols))
    assert port_faults.suspect_rows(cols).tolist() == [False, True, False, True]


def test_suspect_rows_edges_match_reference():
    d = port_faults.DIVERGENCE_ABS
    assert d == jax_faults.DIVERGENCE_ABS
    cols = np.array([[d / 2, 0.0], [d * 1.01, 0.0], [-np.inf, 1.0],
                     [1e39, 0.0], [np.nan, np.nan], [-d, 0.0]])
    np.testing.assert_array_equal(port_faults.suspect_rows(cols),
                                  jax_faults.suspect_rows(cols))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corrupt_dense_noise_value_for_value(dtype):
    import jax.numpy as jnp

    spec = dict(kind="dense-noise", every=2, seed=3, scale=0.5,
                layers="blocks/1/*")
    a = port_faults.FaultInjector(port_faults.FaultSpec(**spec))
    b = jax_faults.FaultInjector(jax_faults.FaultSpec(**spec))
    y = np.random.default_rng(2).normal(size=(1, 3, 24)).astype(np.float32)
    ty = torch.from_numpy(y).to(getattr(torch, dtype))
    jy = jnp.asarray(y).astype(getattr(jnp, dtype))
    with a.armed(4), b.armed(4):
        assert port_faults.active() is a and jax_faults.active() is b
        for path, name in (("blocks/1", "q|k|v"), ("blocks/0", "o"),
                           ("blocks/1", "down")):
            out_p = a.corrupt_dense(path, name, ty)
            out_j = b.corrupt_dense(path, name, jy)
            np.testing.assert_array_equal(
                out_p.to(torch.float32).numpy(),
                np.asarray(out_j, np.float32))
    assert port_faults.active() is None
    assert a.log == b.log == [("dense", 4, "blocks/1/q|k|v"),
                              ("dense", 4, "blocks/1/down")]
    # the noise is the reference generator's, salted by the layer key
    rng = np.random.default_rng((3, 4, zlib.crc32(b"blocks/1/down")))
    assert rng.normal(0.0, 0.5, (1, 3, 24)).shape == (1, 3, 24)
    with a.armed(5):  # does not fire on step 5: not armed
        assert port_faults.active() is None


def test_armed_refuses_nesting():
    a = port_faults.FaultInjector(port_faults.FaultSpec(kind="dense-noise",
                                                        every=1))
    with a.armed(0):
        with pytest.raises(RuntimeError, match="nested"):
            with a.armed(0):
                pass


# ---------------------------------------------------------------------------
# moment merges
# ---------------------------------------------------------------------------


def test_merge_moments_match_reference():
    rng = np.random.default_rng(4)
    chunks = [rng.normal(i, 1 + i, size=5 + 3 * i) for i in range(4)]
    moms = [(len(c), float(c.mean()), float(c.var())) for c in chunks]
    for mod in (port_metrics, jax_metrics):
        assert mod._merge_moments(moms[0], (0, 0.0, 0.0)) == moms[0]
        assert mod._merge_moments((0, 0.0, 0.0), moms[0]) == moms[0]
    acc_p = acc_j = (0, 0.0, 0.0)
    for m in moms:
        acc_p = port_metrics._merge_moments(acc_p, m)
        acc_j = jax_metrics._merge_moments(acc_j, m)
    assert acc_p == acc_j
    pooled = np.concatenate(chunks)
    assert acc_p[2] == pytest.approx(float(pooled.var()))
    maps = [{"a": moms[0], "b": moms[1]}, {"b": moms[2]}, {"c": moms[3],
                                                           "a": moms[1]}]
    assert port_metrics.merge_layer_moments(*maps) == \
        jax_metrics.merge_layer_moments(*maps)
    left = port_metrics.merge_layer_moments(
        port_metrics.merge_layer_moments(*maps[:2]), maps[2])
    right = port_metrics.merge_layer_moments(
        maps[0], port_metrics.merge_layer_moments(*maps[1:]))
    for k in left:
        assert left[k][0] == right[k][0]
        assert left[k][1:] == pytest.approx(right[k][1:], rel=1e-12)


def test_record_probe_and_snapshot_match_reference():
    reports = [_layer_report(0.25, "blocks/0/q"), _layer_report(4.0, "x"),
               _layer_report(1.0, "blocks/0/q")]
    snaps = []
    for mod in (port_metrics, jax_metrics):
        m = mod.EngineMetrics(numerics="int8")
        for r in reports:
            m.record_probe(r)
        m.governor_switches, m.faults_injected, m.quarantine_replays = 2, 3, 1
        snap = m.snapshot()
        snaps.append((snap["error_probe"], snap["governor_switches"],
                      snap["faults_injected"], snap["quarantine_replays"]))
    assert json.dumps(snaps[0], sort_keys=True) == \
        json.dumps(snaps[1], sort_keys=True)
