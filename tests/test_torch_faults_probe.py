"""The port's robustness layer in the engine, held against the JAX engine
on olmo-1b-reduced with float32 compute and a float32 KV cache: the error
probe's reports (thin and chunk-shaped probes, both KV layouts), a probe
leaving the live cache byte-equal and the tokens unchanged, quarantine
replay under injected NaNs (tokens, counters, logs), the governor's
decisions under dense noise, the modeled power attribution, the
refusals, and the serve CLI's robustness flags.  ``err_var`` agrees with
the reference's to ``RTOL`` (the two packages' float32 GEMMs sum in
different orders), ``err_mean`` to ``RTOL`` of the error's standard
deviation; counts, keys, decisions and tokens are equal."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.launch.serve import ServeConfig as JaxServeConfig
from repro.launch.serve import build_serving_params as jax_build_serving_params
from repro.numerics import get_preset as jax_get_preset
from repro.numerics import resolve_ladder as jax_resolve_ladder
from repro.quant.faults import FaultInjector as JaxInjector
from repro.quant.faults import FaultSpec as JaxFaultSpec
from repro.serving import GovernorConfig as JaxGovernorConfig
from repro.serving import NumericsGovernor as JaxGovernor
from repro.serving import ServingEngine as JaxEngine
from repro.serving.engine import power_profile_from_params as jax_profile
from repro_torch.configs import EngineConfig
from repro_torch.launch.serve import ServeConfig, build_serving_params
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.numerics import get_preset, resolve_ladder
from repro_torch.quant import error_probe
from repro_torch.quant.faults import FaultInjector, FaultSpec
from repro_torch.serving import (GovernorConfig, NumericsGovernor,
                                 ServingEngine, power_profile_from_params)

from _torch_port import RWKV_ARCH, jax_side, torch_side

#: relative tolerance of the probe's error variances against the reference
RTOL = 1e-4
SLOTS, MAX_LEN, CHUNK = 2, 48, 16


@pytest.fixture(scope="module")
def sides():
    """f32-compute configs, float params and the serve-default and int8
    packs of both packages (the same weights through the bridge)."""
    jcfg, _, jparams = jax_side()
    tcfg, _, tparams = torch_side()
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    tcfg = dataclasses.replace(tcfg, compute_dtype="float32")
    packs = {}
    for name in ("serve-default", "int8"):
        packs[name] = (
            jax_build_serving_params(jparams, jcfg, JaxServeConfig(
                spec=jax_get_preset(name))),
            build_serving_params(tparams, tcfg, ServeConfig(
                spec=get_preset(name)), device="cpu"))
    return jcfg, tcfg, jparams, tparams, packs, build_model(tcfg, "cpu")


def _trace(vocab, n=3, seed=3, gen=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(4, 12))).tolist(), gen)
            for _ in range(n)]


def _ecfg(cls, layout="contiguous", **kw):
    return cls(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
               cache_dtype="float32", kv_layout=layout, kv_block_size=8, **kw)


def _serve(eng, trace):
    reqs = [eng.submit(p, g) for p, g in trace]
    eng.run()
    assert all(r.finished for r in reqs)
    return [r.generated for r in reqs]


def _port(sides, pack, layout="contiguous", numerics="int8", **kw):
    _, tcfg, _, _, packs, api = sides
    ekw = {k: kw.pop(k) for k in ("error_probe_every", "detect_faults")
           if k in kw}
    return ServingEngine(tcfg, packs[pack][1] if isinstance(pack, str)
                         else pack, _ecfg(EngineConfig, layout, **ekw),
                         api=api, numerics=numerics, **kw)


def _jax(sides, pack, layout="contiguous", numerics="int8", **kw):
    jcfg, _, _, _, packs, _ = sides
    ekw = {k: kw.pop(k) for k in ("error_probe_every", "detect_faults")
           if k in kw}
    return JaxEngine(jcfg, packs[pack][0] if isinstance(pack, str) else pack,
                     _ecfg(JaxEngineConfig, layout, **ekw),
                     numerics=numerics, **kw)


def _assert_probe_equal(tsnap, jsnap):
    assert tsnap["runs"] == jsnap["runs"] > 0
    assert set(tsnap["layers"]) == set(jsnap["layers"])
    for key, j in jsnap["layers"].items():
        t = tsnap["layers"][key]
        assert t["n"] == j["n"], key
        assert t["err_var"] == pytest.approx(j["err_var"], rel=RTOL), key
        # a mean near zero is held to RTOL of the layer's error spread
        assert abs(t["err_mean"] - j["err_mean"]) <= \
            RTOL * np.sqrt(j["err_var"]), key
    assert tsnap["logits_err_n"] == jsnap["logits_err_n"]
    assert tsnap["logits_err_var"] == pytest.approx(jsnap["logits_err_var"],
                                                    rel=RTOL)


# ---------------------------------------------------------------------------
# the error probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_probe_reports_match_reference(sides, layout):
    """Every second step probed: a 20-token prompt keeps steps 1-3
    chunk-shaped, so the first probe runs the fused groups (``q|k|v`` and
    ``gate|up`` keys) and the later, thin ones the members (``q``, ``k``
    ...)."""
    rng = np.random.default_rng(3)
    trace = [(rng.integers(0, sides[1].vocab, n).tolist(), 4)
             for n in (20, 5)]
    teng = _port(sides, "serve-default", layout, "sd", error_probe_every=2)
    jeng = _jax(sides, "serve-default", layout, "sd", error_probe_every=2)
    ttoks, jtoks = _serve(teng, trace), _serve(jeng, trace)
    assert ttoks == jtoks
    tsnap = teng.snapshot()["error_probe"]
    _assert_probe_equal(tsnap, jeng.metrics.snapshot()["error_probe"])
    keys = set(tsnap["layers"])
    assert {"blocks/0/q|k|v", "blocks/0/gate|up", "blocks/0/q",
            "blocks/1/down", "blocks/1/o"} <= keys
    assert tsnap["logits_err_var"] > 0


def test_probe_on_int8_is_at_float_ulp_level(sides):
    teng = _port(sides, "int8", error_probe_every=2)
    _serve(teng, _trace(sides[1].vocab, n=2))
    snap = teng.snapshot()["error_probe"]
    assert snap["runs"] > 0
    assert snap["max_layer_err_var"] < 1e-10
    assert snap["logits_err_var"] < 1e-4


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_probe_leaves_live_cache_and_tokens_untouched(sides, layout):
    """A probed and an unprobed engine step in lock step: after every
    step (a probe included) their live caches are byte-equal, and so are
    the tokens; the probe also reads a cache it leaves byte-equal."""
    trace = _trace(sides[1].vocab, n=3, seed=4)
    probed = _port(sides, "serve-default", layout, error_probe_every=1)
    plain = _port(sides, "serve-default", layout)
    preqs = [probed.submit(p, g) for p, g in trace]
    qreqs = [plain.submit(p, g) for p, g in trace]
    steps = 0
    while not (probed.idle and plain.idle):
        probed.step()
        plain.step()
        steps += 1
        for k in plain.pool.cache:
            assert torch.equal(probed.pool.cache[k], plain.pool.cache[k]), k
    assert probed.metrics.probe_runs == steps
    assert [r.generated for r in preqs] == [r.generated for r in qreqs]

    # one probe by hand, mid-decode: the live cache is byte-equal after
    eng = _port(sides, "serve-default", layout, error_probe_every=1)
    for p, g in trace:
        eng.submit(p, g)
    for _ in range(3):
        eng.step()
    batch = eng.scheduler.next_batch(eng.active)
    tables = eng.pool.block_tables_array() if layout == "paged" else None
    before = {k: v.clone() for k, v in eng.pool.cache.items()}
    report = eng._probe.run(eng.params, batch.tokens, batch.n_valid,
                            eng.pool.cache, eng.pool.lengths(),
                            block_tables=tables)
    assert report is not None and report["layers"]
    for k, v in before.items():
        assert torch.equal(eng.pool.cache[k], v), k
    assert error_probe.active() is None


def test_probe_of_speculative_verify_row(sides):
    """Under speculation the probe re-runs a verify row on the exact
    verify pack: the noise floor, and no change to the tokens."""
    _, tcfg, _, _, packs, api = sides
    ekw = dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
               cache_dtype="float32", speculative_k=3)
    trace = _trace(tcfg.vocab, n=2)
    toks = []
    for every in (0, 1):
        eng = ServingEngine(tcfg, packs["int8"][1], EngineConfig(
            **ekw, error_probe_every=every), api=api,
            draft_params=packs["serve-default"][1])
        toks.append(_serve(eng, trace))
    assert toks[0] == toks[1]
    snap = eng.snapshot()["error_probe"]
    # the int8 pack's folded float32 operands against the integer
    # reference: ulp-level layer deltas (a re-quantization code flip can
    # still reach the logits)
    assert snap["runs"] > 0 and snap["max_layer_err_var"] < 1e-10
    assert snap["logits_err_var"] < 1e-4


# ---------------------------------------------------------------------------
# faults and quarantine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_quarantine_matches_reference(sides, layout):
    trace = _trace(sides[1].vocab)
    clean = _serve(_port(sides, "int8", layout), trace)
    tinj = FaultInjector(FaultSpec(kind="nan", every=3, rows=1, seed=7))
    jinj = JaxInjector(JaxFaultSpec(kind="nan", every=3, rows=1, seed=7))
    teng = _port(sides, "int8", layout, fault_injector=tinj)
    jeng = _jax(sides, "int8", layout, fault_injector=jinj)
    ttoks, jtoks = _serve(teng, trace), _serve(jeng, trace)
    assert ttoks == clean == jtoks
    m = teng.metrics
    assert m.faults_injected > 0
    assert m.faults_detected == m.faults_injected == m.quarantine_replays
    assert m.faults_injected == len(tinj.log)
    for key in ("faults_injected", "faults_detected", "quarantines",
                "quarantine_replays"):
        assert getattr(m, key) == getattr(jeng.metrics, key), key
    assert tinj.log == jinj.log
    assert teng.quarantine_log == jeng.quarantine_log
    assert teng.compile_count() == 2  # the replay reuses the live pack


def test_spike_on_approx_pack_replays_on_exact_pack(sides):
    trace = _trace(sides[1].vocab)
    tinj = FaultInjector(FaultSpec(kind="spike", every=5, seed=1))
    teng = _port(sides, "serve-default", fault_injector=tinj,
                 exact_params=sides[4]["int8"][1])
    toks = _serve(teng, trace)
    assert all(0 <= t < sides[1].vocab for r in toks for t in r)
    m = teng.metrics
    assert m.faults_detected >= m.faults_injected > 0
    assert teng.compile_count() == 4  # + the exact pack's thin and chunk


def test_detection_without_faults_is_a_no_op(sides):
    trace = _trace(sides[1].vocab)
    clean = _serve(_port(sides, "serve-default"), trace)
    eng = _port(sides, "serve-default", detect_faults=True)
    assert _serve(eng, trace) == clean
    assert eng.metrics.faults_detected == 0 and not eng.quarantine_log


# ---------------------------------------------------------------------------
# the governor
# ---------------------------------------------------------------------------


def test_governor_decisions_match_reference(sides):
    """Dense noise on steps 1-3 breaches the SLO twice (serve-default ->
    int8 -> float: the float rung has no packed layer to corrupt); the
    clean windows after it relax back down (a one-window history, so the
    estimate is each window's own)."""
    jcfg, tcfg, jparams, tparams, packs, api = sides
    trace = _trace(tcfg.vocab, n=3, gen=8)
    gkw = dict(slo_err_var=0.02, window_probes=1, clean_windows_to_relax=1,
               history_windows=1)
    fkw = dict(kind="dense-noise", every=1, seed=3, scale=5.0, start=1,
               stop=4)
    engines = []
    for side in ("port", "jax"):
        built = []
        if side == "port":
            ladder = resolve_ladder([get_preset("serve-default"), "int8",
                                     "float"], tparams)
            gov = NumericsGovernor(ladder, GovernorConfig(**gkw))
            inj = FaultInjector(FaultSpec(**fkw))
            pk, fl, mk = 1, tparams, _port
        else:
            ladder = jax_resolve_ladder([jax_get_preset("serve-default"),
                                         "int8", "float"], jparams)
            gov = JaxGovernor(ladder, JaxGovernorConfig(**gkw))
            inj = JaxInjector(JaxFaultSpec(**fkw))
            pk, fl, mk = 0, jparams, _jax

        def pack_fn(s, built=built, pk=pk, fl=fl):
            built.append("float" if s is None else s.name)
            return fl if s is None else packs[s.name][pk]

        eng = mk(sides, "serve-default", numerics=ladder[0].name,
                 error_probe_every=1, governor=gov, pack_fn=pack_fn,
                 fault_injector=inj, exact_params=packs["int8"][pk])
        engines.append((eng, _serve(eng, trace), gov, built, inj))
    (teng, ttoks, tgov, tbuilt, tinj), (jeng, jtoks, jgov, jbuilt, jinj) = \
        engines
    tdec = [d.to_dict() for d in tgov.decisions]
    jdec = [d.to_dict() for d in jgov.decisions]
    key = lambda d: (d["action"], d["from"], d["to"], d["reason"],  # noqa: E731
                     d["window"], d["power_delta_pct"])
    assert [key(d) for d in tdec] == [key(d) for d in jdec]
    assert [(d["action"], d["window"]) for d in tdec] == [
        ("escalate", 1), ("escalate", 2), ("relax", 3), ("relax", 4)]
    for t, j in zip(tdec, jdec):
        assert t["err_var"] == pytest.approx(j["err_var"], rel=RTOL)
    assert tbuilt == jbuilt == ["int8", "float"]  # once per rung reached
    assert teng.numerics == jeng.numerics == tgov.rung.name
    assert ttoks == jtoks
    assert tinj.log == jinj.log
    snap, jsnap = teng.snapshot(), jeng.metrics.snapshot()
    for k in ("governor_switches", "governor_escalations", "governor_relaxes",
              "faults_injected"):
        assert snap[k] == jsnap[k], k
    assert json.dumps(snap["power_attribution"], sort_keys=True) == \
        json.dumps(jsnap["power_attribution"], sort_keys=True)
    assert len(snap["power_attribution"]["tokens_by_numerics"]) == 3


def test_power_profile_matches_reference(sides):
    _, _, jparams, tparams, packs, _ = sides
    for name, (jp, tp) in packs.items():
        assert power_profile_from_params(tp) == jax_profile(jp), name
    assert power_profile_from_params(tparams) == jax_profile(jparams)
    prof = power_profile_from_params(packs["serve-default"][1])
    assert {"blocks/attn/qkv", "blocks/mlp/gateup"} <= set(prof)
    assert all(e["saving_pct"] > 0 for e in prof.values())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _refusal(make, exc=ValueError):
    with pytest.raises(exc) as e:
        make()
    return str(e.value)


def test_refusals_match_reference(sides):
    jcfg, tcfg, jparams, tparams, packs, api = sides
    tl = resolve_ladder(["int8", "float"], tparams)
    jl = jax_resolve_ladder(["int8", "float"], jparams)
    tgov = lambda: NumericsGovernor(tl, GovernorConfig(slo_err_var=1.0))  # noqa: E731
    jgov = lambda: JaxGovernor(jl, JaxGovernorConfig(slo_err_var=1.0))  # noqa: E731
    pairs = [
        (lambda: _port(sides, "int8", error_probe_every=1, governor=tgov()),
         lambda: _jax(sides, "int8", error_probe_every=1, governor=jgov())),
        (lambda: _port(sides, "int8", governor=tgov(),
                       pack_fn=lambda s: None),
         lambda: _jax(sides, "int8", governor=jgov(),
                      pack_fn=lambda s: None)),
    ]
    spec = dict(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
                speculative_k=2, error_probe_every=1)
    tdraft, jdraft = packs["serve-default"][1], packs["serve-default"][0]
    pairs += [
        (lambda: ServingEngine(tcfg, packs["int8"][1], EngineConfig(**spec),
                               api=api, draft_params=tdraft, governor=tgov(),
                               pack_fn=lambda s: None),
         lambda: JaxEngine(jcfg, packs["int8"][0], JaxEngineConfig(**spec),
                           draft_params=jdraft, governor=jgov(),
                           pack_fn=lambda s: None)),
        (lambda: ServingEngine(tcfg, packs["int8"][1], EngineConfig(**spec),
                               api=api, draft_params=tdraft,
                               fault_injector=FaultInjector(FaultSpec())),
         lambda: JaxEngine(jcfg, packs["int8"][0], JaxEngineConfig(**spec),
                           draft_params=jdraft,
                           fault_injector=JaxInjector(JaxFaultSpec()))),
    ]
    for make_port, make_jax in pairs:
        # the messages name their own package's serve module
        assert (_refusal(make_port).replace("repro_torch.", "repro.")
                == _refusal(make_jax))


@pytest.fixture(scope="module")
def rwkv_sides():
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model

    jcfg = dataclasses.replace(jax_get_config(RWKV_ARCH),
                               compute_dtype="float32")
    tcfg, _, tparams = torch_side(RWKV_ARCH)
    tcfg = dataclasses.replace(tcfg, compute_dtype="float32")
    _, _, jparams = jax_side(RWKV_ARCH)
    return (jcfg, jax_build_model(jcfg), jparams, tcfg,
            build_model(tcfg, "cpu"), tparams)


def test_probe_refuses_rwkv_as_the_reference(rwkv_sides):
    jcfg, _, jparams, tcfg, api, tparams = rwkv_sides
    ek = dict(slots=2, max_len=32, prefill_chunk=8, error_probe_every=1)
    port = _refusal(lambda: ServingEngine(tcfg, tparams, EngineConfig(**ek),
                                          api=api))
    ref = _refusal(lambda: JaxEngine(jcfg, jparams, JaxEngineConfig(**ek)))
    assert port == ref and "unroll_layers" in port


def test_reference_quarantine_on_rwkv_diverges_and_the_port_refuses(
        rwkv_sides):
    """The reference rolls a quarantined RWKV row back by its cursor only:
    the recurrent state has already consumed the corrupted step, so its
    replay is not the clean step and the tokens leave the clean run's
    (ROADMAP queue 3).  The port refuses detection and injection on a
    recurrent arch instead."""
    jcfg, _, jparams, tcfg, api, tparams = rwkv_sides
    int8 = jax_build_serving_params(jparams, jcfg, JaxServeConfig(
        spec=jax_get_preset("int8")))
    trace = _trace(jcfg.vocab)
    ek = dict(slots=2, max_len=48, prefill_chunk=8, cache_dtype="float32")
    clean = _serve(JaxEngine(jcfg, int8, JaxEngineConfig(**ek),
                             numerics="int8"), trace)
    inj = JaxInjector(JaxFaultSpec.parse("nan@3"))
    faulty = JaxEngine(jcfg, int8, JaxEngineConfig(**ek, detect_faults=True),
                       numerics="int8", fault_injector=inj)
    toks = _serve(faulty, trace)
    assert faulty.metrics.quarantine_replays == len(inj.log) > 0
    assert toks != clean
    for kw in ({"fault_injector": FaultInjector(FaultSpec.parse("nan@3"))},
               {}):
        ecfg = EngineConfig(**ek, detect_faults=not kw)
        msg = _refusal(lambda: ServingEngine(tcfg, tparams, ecfg, api=api,
                                             **kw), NotImplementedError)
        assert "recurrent RWKV state" in msg


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--requests", "4", "--slots", "2", "--max-len",
       "48", "--chunk", "8"]


def test_cli_governor_under_dense_noise(capsys):
    serve_main(CLI + ["--governor", "--slo-err-var", "1e-3",
                      "--governor-window", "1", "--governor-relax-after", "1",
                      "--inject-faults", "dense-noise@1@0-6",
                      "--fault-seed", "2"])
    out = capsys.readouterr().out
    assert "governor: defaulting --error-probe-every to 4" in out
    assert ("governor=[serve-default[perforated(m=2)+cv(g=1)] -> int8 -> "
            "float] slo_err_var=0.001") in out
    assert "inject=dense-noise@1 seed=2" in out
    assert "  faults: injected=" in out
    assert "  governor: rung=" in out
    assert "escalate serve-default[perforated(m=2)+cv(g=1)] -> int8 " \
        "[slo_breach]" in out
    snap = json.loads(out[out.index("\n{") + 1:out.index("\n}") + 2])
    assert snap["governor_escalations"] >= 1
    assert snap["error_probe"]["runs"] >= 1
    assert snap["power_attribution"]["tokens_attributed"] > 0


def test_cli_nan_quarantine(capsys):
    serve_main(CLI + ["--inject-faults", "nan@3", "--detect-faults"])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("  faults:")][0]
    nums = dict(kv.split("=") for kv in line.split()[1:])
    assert int(nums["injected"]) > 0
    assert nums["injected"] == nums["detected"] == nums["replays"]


@pytest.mark.parametrize("flags,match", [
    (["--metrics-window", "-1"], "windowed metrics"),
    (["--assert-layer-breach"], "windowed metrics"),
    (["--governor"], "--slo-err-var"),
    (["--governor", "--slo-err-var", "1", "--mode", "float"],
     "approximate serving spec"),
    (["--layer-slo", "blocks/0/*", "--governor", "--slo-err-var", "1"],
     "PATTERN=VAR"),
])
def test_cli_refusals(flags, match):
    with pytest.raises(SystemExit, match=match):
        serve_main(CLI + flags)
