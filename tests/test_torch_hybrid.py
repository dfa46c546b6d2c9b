"""hymba-1.5b (every layer: sliding-window GQA attention and a parallel
mamba SSM head, averaged after their own RMS norms) in the port against
the JAX package, ``-reduced`` (window 8) with float32 compute, on weights
initialised once in JAX (norm scales and biases seeded) and carried across
by repro_torch.bridge: the config, the SSM functions, the forward, the
ring-cache prefill and decode (the ring wraps twice), prefill past the
window, the int8 ring cache, the serving packs with the SSM projections,
the packed logits on both backends, the CLI's ``plan`` and ``--legacy``,
and the engine, paged, fleet and speculative refusals.

Tolerances: SSM functions and states 1e-5 (float32 scans summed in the
same order, GEMMs in others); logits 1e-4 with equal argmax, as the other
archs (tests/test_torch_archs.py); the port's decode against its own full
forward 1e-4 (tests/test_decode_consistency.py holds the reference to
1e-3 in float32); tokens, packs, int8 ring codes and the CLI's output
equal.
"""

import argparse
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.nn import ssm as jssm
from repro.numerics import get_preset as jax_get_preset
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.launch.serve import ServeConfig as JaxServeConfig
from repro.launch.serve import build_serving_params as jax_build
from repro.quant import observers as jobs
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import EngineConfig, get_config
from repro_torch.core.policy import ApproxPolicy
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import ServeConfig, build_serving_params
from repro_torch.models import lm as tlm
from repro_torch.nn import ssm as tssm
from repro_torch.numerics import get_preset
from repro_torch.numerics.presets import uniform_spec
from repro_torch.quant import observers as tobs
from repro_torch.serving import ServingEngine

from _torch_port import (_jax_node, _packs, assert_packs_byte_equal,
                         seeded_packed, seeded_sides, to_np, torch_side)
from test_torch_moe_serving import _assert_trees_byte_equal

ARCH = "hymba-1.5b-reduced"
PALLAS = ("perforated", 2, True, "pallas")
ATOL = 1e-4
SSM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's side: on these reduced models
    torch's thread pool costs more than it saves (a 64-wide matmul takes
    milliseconds with 8 threads on a shared host, microseconds with one)
    and competes with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sides():
    """(jax cfg, jax api, jax params, port cfg, port api, port params)."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    japi, jparams, tapi, tparams = seeded_sides(jcfg, tcfg)
    return jcfg, japi, jparams, tcfg, tapi, tparams


def _params(name):
    if name == "float":
        s = _sides()
        return s[2], s[5]
    return seeded_packed(jax_get_config(ARCH), get_config(ARCH), PALLAS)


def _prompt(vocab, b=2, t=12, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


def test_config_fields_counts_and_ssm_config_equal_jax():
    for name in ("hymba-1.5b", ARCH):
        jc, tc = jax_get_config(name), get_config(name)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), (name, f.name)
        assert tc.param_count() == jc.param_count()
        assert tc.sub_quadratic == jc.sub_quadratic is True
        assert dataclasses.asdict(tc.ssm_config()) == dataclasses.asdict(
            jc.ssm_config())
        assert tc.ssm_config().dtr == jc.ssm_config().dtr
    full = get_config("hymba-1.5b")
    assert (full.ssm_config().dtr, full.ssm_config().d_inner,
            full.window, full.family) == (100, 3200, 1024, "hybrid")
    assert get_config(ARCH).window == 8
    assert not get_config("olmo-1b").sub_quadratic
    assert get_config("rwkv6-1.6b").sub_quadratic


@functools.lru_cache(maxsize=None)
def _ssm_params():
    """Layer 0's SSM leaves of the shared init with seeded conv_b, d_skip,
    a_log and dt_proj bias (zeros, ones and log(1..16) at init), as numpy."""
    _, _, jparams, *_ = _sides()
    rng = np.random.default_rng(11)
    out = {}
    for k, v in jparams["blocks"]["ssm"].items():
        if isinstance(v, dict):
            out[k] = {kk: np.asarray(vv[0]) for kk, vv in v.items()}
        else:
            out[k] = np.asarray(v[0])
    out["conv_b"] = (0.1 * rng.standard_normal(out["conv_b"].shape)
                     ).astype(np.float32)
    out["d_skip"] = (1 + 0.2 * rng.standard_normal(out["d_skip"].shape)
                     ).astype(np.float32)
    out["a_log"] = (out["a_log"] + 0.1 * rng.standard_normal(
        out["a_log"].shape)).astype(np.float32)
    return out


def _assert_exact_packs_byte_equal(jax_tree, port_tree) -> None:
    """``assert_packs_byte_equal`` for packs without a blocked layout (the
    ``int8`` preset's exact packs, which the kernel does not read): the
    codes, quant params, CV constants and bias of every pack, layer by
    layer, and no blocked layout on either side."""
    seen = 0
    for path, mod in _packs(port_tree):
        jmod, layer = _jax_node(jax_tree, path)
        assert jmod.blocked is None and mod.blocked is None, path
        for f in ("w_q", "w_scale", "w_zp", "sum_qw", "c", "c0", "bias"):
            want, got = getattr(jmod.pack, f), getattr(mod.pack, f)
            assert (want is None) == (got is None), (path, f)
            if want is not None:
                want = np.asarray(want)
                want = want if layer is None else want[layer]
                assert want.tobytes() == to_np(got).tobytes(), (path, f)
        seen += 1
    assert seen


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(np.array(v))
            for k, v in p.items()}


@pytest.mark.parametrize("t,chunk", [(1, 256), (2, 256), (11, 256),
                                     (11, 4)])
def test_ssm_prefill_state_and_decode_vs_jax(t, chunk, monkeypatch):
    """``ssm_prefill``, the final state (the reference's ``_ssm_with_state``,
    a second scan; the port's single ``ssm_scan``), then three
    ``ssm_decode_step``s from that state: outputs and states within 1e-5;
    with ``SCAN_CHUNK`` 4 the scan crosses chunk boundaries (the card's
    2048-token prefill runs 8 chunks of 256).  t < conv_kernel - 1 leaves
    the reference a short conv state; the port pads its cache leaf with the
    zero history (``prefill``), so the decode steps start from t >= 3
    here."""
    monkeypatch.setattr(tssm, "SCAN_CHUNK", chunk)
    scfg_j, scfg_t = jax_get_config(ARCH).ssm_config(), \
        get_config(ARCH).ssm_config()
    p = _ssm_params()
    jp, tp = _tree(p, jnp.asarray), _tree(p, torch.from_numpy)
    x = np.random.default_rng(t).standard_normal((2, t, 64)).astype(
        np.float32)
    jy = jssm.ssm_prefill(jp, jnp.asarray(x), scfg_j)
    ty = tssm.ssm_prefill(tp, torch.from_numpy(x), scfg_t)
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), atol=SSM_TOL,
                               rtol=0)
    jy2, jst = jlm._ssm_with_state(jp, jnp.asarray(x), scfg_j)
    ty2, tst = tssm.ssm_scan(tp, torch.from_numpy(x), scfg_t)
    np.testing.assert_array_equal(to_np(ty2), to_np(ty))
    for k in ("conv", "h"):
        assert tuple(tst[k].shape) == jst[k].shape, k
        np.testing.assert_allclose(to_np(tst[k]), np.asarray(jst[k]),
                                   atol=SSM_TOL, rtol=0, err_msg=k)
    if t < 3:
        return
    jstate = {"conv": jst["conv"].astype(jnp.float32), "h": jst["h"]}
    tstate = {"conv": tst["conv"].float().clone(), "h": tst["h"].clone()}
    for i in range(3):
        xt = np.random.default_rng(100 + i).standard_normal(
            (2, 1, 64)).astype(np.float32)
        jo, jstate = jssm.ssm_decode_step(jp, jnp.asarray(xt), jstate, scfg_j)
        to, tstate = tssm.ssm_decode_step(tp, torch.from_numpy(xt), tstate,
                                          scfg_t)
        np.testing.assert_allclose(to_np(to), np.asarray(jo), atol=SSM_TOL,
                                   rtol=0)
        for k in ("conv", "h"):
            np.testing.assert_allclose(to_np(tstate[k]),
                                       np.asarray(jstate[k]), atol=SSM_TOL,
                                       rtol=0, err_msg=k)


def test_forward_logits_vs_jax():
    """Float weights (the packs: ``test_packed_logits_vs_jax_backends``)."""
    _, japi, jparams, tcfg, tapi, tparams = _sides()
    toks = _prompt(tcfg.vocab, t=20)  # longer than the window of 8
    jf = np.asarray(jax.jit(japi.forward)(jparams,
                                          {"tokens": jnp.asarray(toks)}))
    tf = to_np(tapi.forward(tparams, {"tokens": torch.from_numpy(toks)}))
    assert tf.shape == (2, 20, tcfg.vocab) and tf.dtype == np.float32
    np.testing.assert_allclose(tf, jf, rtol=0, atol=ATOL)
    assert (tf.argmax(-1) == jf.argmax(-1)).all()


@pytest.mark.parametrize("name", ["float", "packed"])
def test_ring_decode_tracks_forward_and_jax_tokens(name):
    """A 4-token prefill, then decode to 20 tokens on the float32 ring
    cache (W = 8: the ring wraps twice): every step's logits within 1e-4
    of the port's own full forward at that position, as
    tests/test_decode_consistency.py does for the reference; then (float)
    greedy decode from a prompt gives the JAX decode's logits and tokens
    (packed: ``test_run_legacy_prints_the_jax_sample``)."""
    _, japi, _, tcfg, tapi, _ = _sides()
    jparams, tparams = _params(name)
    toks = torch.from_numpy(_prompt(tcfg.vocab, t=20, seed=4))
    full = tapi.forward(tparams, {"tokens": toks})
    logits, cache = tapi.prefill(tparams, {"tokens": toks[:, :4]}, 24,
                                 cache_dtype=torch.float32)
    assert cache["k"].shape[-2] == tcfg.window
    errs = [float((logits - full[:, 3]).abs().max())]
    for t in range(4, 20):
        logits, cache = tapi.decode_step(tparams, toks[:, t:t + 1], cache)
        errs.append(float((logits - full[:, t]).abs().max()))
    assert max(errs) < ATOL, errs
    assert cache["pos"] == 20
    if name == "packed":  # packed greedy tokens: the --legacy test
        return

    prompt = _prompt(tcfg.vocab, t=6, seed=5)
    gen = 14
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                          max_len=6 + gen, cache_dtype=jnp.float32)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(prompt)},
                          6 + gen, cache_dtype=torch.float32)
    jstep = jax.jit(japi.decode_step)
    jtok, ttok = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
    jout, tout = [jtok], [ttok]
    for _ in range(gen - 1):
        jl, jc = jstep(jparams, jtok, jc)
        tl, tc = tapi.decode_step(tparams, ttok, tc)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        jtok, ttok = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
        jout.append(jtok)
        tout.append(ttok)
    assert np.concatenate([np.asarray(a) for a in jout], 1).tolist() == \
        torch.cat(tout, 1).tolist()


@pytest.mark.parametrize("t,s", [(5, 8), (8, 8), (13, 8), (19, 8)])
def test_ring_align_equals_jax(t, s):
    x = np.random.default_rng(t).standard_normal((2, 3, t, 4)).astype(
        np.float32)
    want = np.asarray(jlm._ring_align(jnp.asarray(x), s, t))
    got = to_np(tlm._ring_align(torch.from_numpy(x), s, t))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t", [13, 16])
def test_prefill_past_the_window_vs_jax(t):
    """t > W: the ring leaves keep the last W positions rolled by t mod W,
    as the JAX prefill's; the SSM state within 1e-5; then three decode
    steps on both continue to agree."""
    _, japi, jparams, tcfg, tapi, tparams = _sides()
    toks = _prompt(tcfg.vocab, t=t, seed=6)
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                          max_len=t + 4, cache_dtype=jnp.float32)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                          t + 4, cache_dtype=torch.float32)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=ATOL)
    assert set(tc) == set(jc)
    for key in ("k", "v", "ssm_conv", "ssm_h"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert tc[key].dtype == torch.float32
        np.testing.assert_allclose(to_np(tc[key]), np.asarray(jc[key]),
                                   rtol=0, atol=SSM_TOL, err_msg=key)
    tok = jnp.argmax(jl, -1)[:, None]
    for _ in range(3):
        jl, jc = japi.decode_step(jparams, tok, jc)
        tl, tc = tapi.decode_step(tparams, torch.from_numpy(
            np.asarray(tok)).long(), tc)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        tok = jnp.argmax(jl, -1)[:, None]


def test_int8_ring_cache_vs_jax_prefill_and_the_reference_decode_cast():
    """An int8 cache: after a prefill past the window the ring leaves equal
    the JAX prefill's code for code (both through ``_to_cache``), the SSM
    leaves stay float32 (within 1e-5).  Decoding, the port writes and reads
    the ring through the same fixed point and tracks its float32 decode;
    the reference's ``attention_decode_ring`` writes a raw cast (ROADMAP
    queue 3): its slot holds ``k.astype(int8)``, which truncates most of
    the O(1) keys to 0, and reads the 16x fixed point back unscaled."""
    _, japi, jparams, tcfg, tapi, tparams = _sides()
    toks = _prompt(tcfg.vocab, t=13, seed=7)
    _, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=20,
                         cache_dtype=jnp.int8)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 20,
                          cache_dtype=torch.int8)
    for key in ("k", "v"):
        assert tc[key].dtype == torch.int8
        np.testing.assert_array_equal(to_np(tc[key]), np.asarray(jc[key]))
    for key in ("ssm_conv", "ssm_h"):
        assert tc[key].dtype == torch.float32 and jc[key].dtype == jnp.float32
        np.testing.assert_allclose(to_np(tc[key]), np.asarray(jc[key]),
                                   rtol=0, atol=SSM_TOL, err_msg=key)
    _, fc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 20,
                         cache_dtype=torch.float32)
    tok = tl.argmax(-1)[:, None]
    gaps = []
    for _ in range(4):
        tl, tc = tapi.decode_step(tparams, tok, tc)
        fl, fc = tapi.decode_step(tparams, tok, fc)
        gaps.append(float((tl - fl).abs().max() / fl.abs().max()))
        tok = fl.argmax(-1)[:, None]
    assert max(gaps) < 0.05, gaps  # steps of 1/16 on O(1) keys
    slot = 13 % tcfg.window
    jk_before = np.asarray(jc["k"])
    _, jc2 = japi.decode_step(jparams, jnp.asarray(toks[:, :1]), jc)
    raw = np.asarray(jc2["k"])[:, :, :, slot]
    assert not np.array_equal(raw, jk_before[:, :, :, slot])
    assert np.abs(raw).max() <= 2  # a raw cast of O(1) keys, not 16 k
    assert (raw == 0).mean() > 0.5


def test_serving_packs_byte_equal_ssm_projections():
    """serve-default (``pallas``) and ``int8`` packs byte-equal to the
    reference's, calibrated.  The reference's ``_ssm_with_state`` runs
    in_proj, x_proj and dt_proj a second time to re-derive the SSM state;
    the port's one ``ssm_scan`` records the same ranges under the
    recorder (rtol 1e-5); the port's prefill ranges then go into both
    builds.  in_proj and out_proj pack, x_proj and dt_proj stay bf16 (the
    serving keep-float rules); under a uniform spec every SSM projection
    packs, dt_proj with its bias."""
    jcfg, japi, jparams, tcfg, tapi, tparams = _sides()
    p = _ssm_params()
    x = np.random.default_rng(8).standard_normal((2, 6, 64)).astype(
        np.float32)
    with jobs.CalibrationRecorder() as jrec:
        jlm._ssm_with_state(_tree(p, jnp.asarray), jnp.asarray(x),
                            jcfg.ssm_config())
    with tobs.CalibrationRecorder() as trec:
        tssm.ssm_scan(_tree(p, torch.from_numpy), torch.from_numpy(x),
                      tcfg.ssm_config())
    want_r, got_r = jrec.ranges(), trec.ranges()
    assert set(got_r) == set(want_r) == {"in_proj", "x_proj", "dt_proj",
                                         "out_proj"}
    for k in want_r:
        np.testing.assert_allclose(got_r[k], want_r[k], rtol=1e-5, err_msg=k)
    toks = _prompt(tcfg.vocab, t=6, seed=8)
    with tobs.CalibrationRecorder() as trec:
        tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 8,
                     cache_dtype=torch.float32)
    ranges = trec.ranges()
    policy = JaxPolicy("perforated", 2, use_cv=True, backend="pallas")
    specs = [(jax_get_preset("serve-default", policy=policy),
              get_preset("serve-default", policy=ApproxPolicy(
                  "perforated", 2, use_cv=True, backend="pallas"))),
             (jax_get_preset("int8"), get_preset("int8"))]
    from repro.numerics.presets import uniform_spec as jax_uniform

    specs.append((jax_uniform(policy), uniform_spec(ApproxPolicy(
        "perforated", 2, use_cv=True, backend="pallas"))))
    for i, (jspec, tspec) in enumerate(specs):
        jp = jax_build(jparams, jcfg, JaxServeConfig(spec=jspec),
                       act_ranges=ranges)
        tp = build_serving_params(tparams, tcfg, ServeConfig(spec=tspec),
                                  act_ranges=ranges, device="cpu")
        if i == 1:
            _assert_exact_packs_byte_equal(jp, tp)
        else:
            assert_packs_byte_equal(jp, tp)
        ssm = tp["blocks"]["ssm"]
        for name in ("in_proj", "out_proj"):
            assert isinstance(ssm[name], torch.nn.Module), name
        for name in ("x_proj", "dt_proj"):
            if i < 2:
                assert ssm[name]["w"].dtype == torch.bfloat16, name
            else:
                assert isinstance(ssm[name], torch.nn.Module), name
        for leaf in ("conv_w", "conv_b", "a_log", "d_skip"):
            np.testing.assert_array_equal(
                to_np(ssm[leaf].float()),
                np.asarray(jp["blocks"]["ssm"][leaf]).astype(np.float32))
    assert tp["blocks"]["ssm"]["dt_proj"][0].pack.bias is not None


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_build_by_layer_byte_equal_to_whole_build(backend):
    cfg = get_config(ARCH)
    api = tserve.build_model(cfg, "cpu")
    scfg = ServeConfig(policy=ApproxPolicy("perforated", 2, backend=backend))
    want = build_serving_params(api.init(0), cfg, scfg, device="cpu")
    got = tserve.build_serving_params_by_layer(cfg, scfg, device="cpu")
    _assert_trees_byte_equal(got, want)
    assert isinstance(got["blocks"]["ssm"]["in_proj"], torch.nn.Module)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_packed_logits_vs_jax_backends(backend):
    """serve-default packs on each backend: the port's plain versions
    against the JAX kernel in interpret mode (``pallas``) or the JAX jnp
    path, logits within 1e-4 with equal argmax, prefill and a decode step
    on the ring."""
    jcfg, japi, jparams, tcfg, tapi, tparams = _sides()
    pol = ("perforated", 2, True, backend)
    jp, tp = seeded_packed(jcfg, tcfg, pol)
    toks = _prompt(tcfg.vocab, t=10, seed=9)
    jl, jc = japi.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=12,
                          cache_dtype=jnp.float32)
    tl, tc = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)}, 12,
                          cache_dtype=torch.float32)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=ATOL)
    tok = jnp.argmax(jl, -1)[:, None]
    jl, _ = jax.jit(japi.decode_step)(jp, tok, jc)
    tl, _ = tapi.decode_step(tp, torch.from_numpy(np.asarray(tok)).long(), tc)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=ATOL)
    assert (to_np(tl).argmax(-1) == np.asarray(jl).argmax(-1)).all()


def test_plan_table_byte_equal_to_jax_cli(capsys):
    """The full-width ``plan`` (meta-device shapes), table and JSON, byte
    for byte, with the four SSM projections' rows."""
    for extra in ([], ["--json"]):
        tserve.main(["plan", "--arch", "hymba-1.5b"] + extra)
        got = capsys.readouterr().out
        jserve.main(["plan", "--arch", "hymba-1.5b"] + extra)
        want = capsys.readouterr().out
        assert got == want
    for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        assert f"blocks/ssm/{name}" in got


def _legacy_args(spec_json=None, cache_dtype=None):
    ns = argparse.Namespace(arch=ARCH, batch=2, prompt_len=12, gen=10,
                            mode="perforated", m=2, no_cv=False, preset=None,
                            spec_json=spec_json, device="cpu")
    if cache_dtype:
        ns.cache_dtype = cache_dtype
    return ns


def _sample(out: str) -> str:
    return [ln for ln in out.splitlines() if ln.startswith("sample:")][-1]


@pytest.mark.parametrize("name", ["float", "packed"])
def test_run_legacy_prints_the_jax_sample(name, tmp_path, capsys):
    """``--legacy`` serves hymba (12-token prompt past the window, 10
    tokens): the printed sample equals the JAX CLI's, on the JAX init
    carried across; with ``--cache-dtype int8`` the port's loop keeps the
    ring in int8 (the reference's loop always keeps bf16)."""
    spec_json = None
    if name == "packed":
        spec = jax_get_preset("serve-default", policy=JaxPolicy(
            "perforated", 2, use_cv=True, backend="pallas"))
        spec_json = tmp_path / "spec.json"
        spec_json.write_text(spec.to_json())
    jserve.run_legacy(_legacy_args(spec_json))
    want = _sample(capsys.readouterr().out)
    tparams = torch_side(ARCH)[2]  # the JAX CLI's PRNGKey(0) init
    res = tserve.run_legacy(_legacy_args(spec_json), params=tparams)
    got = _sample(capsys.readouterr().out)
    assert got == want
    assert json.loads(got.split(":", 1)[1]) == res["tokens"][0].tolist()
    res8 = tserve.run_legacy(_legacy_args(spec_json, "int8"), params=tparams)
    capsys.readouterr()
    assert res8["tokens"].shape == (2, 10)


def test_engine_paged_fleet_and_speculative_refuse_like_the_reference():
    """The reference refuses hymba in its slot engine
    (``_slot_unsupported``: the ring caches have no per-slot phase, the
    SSM state is not slot-managed); so does the port, on every surface
    built on it: the engine, the paged layout, the fleet, speculative
    decode, the model API's slot functions, the CLI."""
    jcfg, japi, jparams, tcfg, tapi, tparams = _sides()
    assert not tapi.supports_slots and not tapi.supports_paged
    assert tapi.init_slot_cache is None and tapi.decode_slots is None
    assert tapi.init_paged_cache is None
    assert "sliding-window" in tapi.slot_refusal
    ecfgs = [dict(slots=2, max_len=32, prefill_chunk=8),
             dict(slots=2, max_len=32, prefill_chunk=8, kv_layout="paged",
                  kv_block_size=4)]
    for kw in ecfgs:
        with pytest.raises(NotImplementedError):
            JaxEngine(jcfg, jparams, JaxEngineConfig(**kw))
        with pytest.raises(NotImplementedError, match="sliding-window"):
            ServingEngine(tcfg, tparams, EngineConfig(**kw), api=tapi)
    with pytest.raises(NotImplementedError):
        JaxEngine(jcfg, jparams, JaxEngineConfig(
            slots=2, max_len=32, prefill_chunk=8, speculative_k=2),
            draft_params=jparams)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        ServingEngine(tcfg, tparams, EngineConfig(
            slots=2, max_len=32, prefill_chunk=8, speculative_k=2),
            api=tapi, draft_params=tparams)
    for fn, what in ((tlm.init_slot_cache, "slot"),
                     (tlm.init_paged_slot_cache, "paged")):
        args = (2, 16) if what == "slot" else (4, 4, 2)
        with pytest.raises(NotImplementedError, match=f"{what} decode"):
            fn(tcfg, *args)
    from repro.serving import TierConfig as JaxTier
    from repro.serving import build_fleet as jax_build_fleet
    from repro_torch.serving import TierConfig, build_fleet

    with pytest.raises(NotImplementedError):
        jax_build_fleet(jcfg, jparams, [JaxTier("float", "float")],
                        JaxEngineConfig(slots=2, max_len=32),
                        lambda n: (jparams, n, None))
    with pytest.raises(NotImplementedError, match="sliding-window"):
        build_fleet(tcfg, tparams, [TierConfig("float", "float")],
                    EngineConfig(slots=2, max_len=32),
                    lambda n: (tparams, n, None), api=tapi)
    for argv in ([], ["--fleet"], ["--speculative-k", "2"]):
        with pytest.raises(NotImplementedError):
            tserve.main(["--device", "cpu", "--arch", ARCH] + argv)
