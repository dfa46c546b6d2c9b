"""deepseek-v2-lite-16b (MLA, a leading dense layer, routed and shared
experts) and moonshot-v1-16b-a3b (GQA, every layer MoE) in the port
against the JAX package, ``-reduced`` with float32 compute, on weights
initialised once in JAX and carried across by repro_torch.bridge: the
forward, the lock-step prefill and decode, the slot step on the
contiguous and paged layouts, the serving packs (byte-equal, the 4-D
expert stacks left float as the reference leaves them), the engine's
tokens on ``mixed_trace`` under float and ``serve-default`` (``backend:
"pallas"``: the kernels' plain versions here, interpret mode on the JAX
side), speculative decode and the error probe on deepseek, the serve CLI
against the JAX CLI, the ``plan`` table, and the int8-cache refusal.

Tolerances as ``tests/test_torch_archs.py``: logits and caches atol 1e-4
(ulps of float32 GEMMs summed in different orders, through the layers);
tokens, counts and packs equal; probe variances rtol 1e-4.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.core.approx_linear import packed_layer_paths as jax_layer_paths
from repro.launch.serve import ServeConfig as JaxServeConfig
from repro.launch.serve import build_serving_params as jax_build
from repro.launch.serve import main as jax_serve_main
from repro.launch.serve import mixed_trace as jax_mixed_trace
from repro.numerics import get_preset as jax_get_preset
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import EngineConfig
from repro_torch.core.approx_linear import QuantizedDense, packed_layer_paths
from repro_torch.core.policy import ApproxPolicy
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import ServeConfig, build_serving_params
from repro_torch.launch.serve import mixed_trace
from repro_torch.models import lm as tlm
from repro_torch.numerics import get_preset
from repro_torch.serving import ServingEngine

from _torch_port import (assert_packs_byte_equal, jax_side, packed_pair,
                         to_np, torch_side)

DSV2, MOON = "deepseek-v2-lite-16b-reduced", "moonshot-v1-16b-a3b-reduced"
ARCHS = [DSV2, MOON]
PALLAS = ("perforated", 2, True, "pallas")
ATOL = 1e-4
SLOTS, MAX_LEN, CHUNK = 2, 48, 8


@functools.lru_cache(maxsize=None)
def _params(arch, name):
    """(jax params, port params): float, or serve-default on the approx
    kernel's backend."""
    return packed_pair(None if name == "float" else PALLAS, arch)


def _apis(arch):
    jcfg, japi, _ = jax_side(arch)
    tcfg, tapi, _ = torch_side(arch)
    return jcfg, japi, tcfg, tapi


@functools.lru_cache(maxsize=None)
def _jit(arch, fn, static=()):
    """The JAX API's ``fn`` for ``arch`` under one ``jax.jit`` shared by the
    tests (compiled once a shape, where the eager calls compile every
    primitive of the interpret-mode kernel)."""
    return jax.jit(getattr(jax_side(arch)[1], fn), static_argnames=static)


def _prompt(vocab, b=2, t=11, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


@pytest.mark.parametrize("name", ["float", "serve-default"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_vs_jax(arch, name):
    tcfg, tapi = torch_side(arch)[:2]
    jp, tp = _params(arch, name)
    toks = _prompt(tcfg.vocab)
    jf = np.asarray(_jit(arch, "forward")(jp, {"tokens": jnp.asarray(toks)}))
    tf = to_np(tapi.forward(tp, {"tokens": torch.from_numpy(toks)}))
    assert tf.shape == (2, 11, tcfg.vocab) and tf.dtype == np.float32
    np.testing.assert_allclose(tf, jf, rtol=0, atol=ATOL)
    assert (tf.argmax(-1) == jf.argmax(-1)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_step_vs_jax(arch):
    """The lock-step surface on the serve-default packs: prefill's logits
    and cache (``latent``/``rope`` and ``dense_*`` for MLA), then 4 greedy
    decode steps."""
    tcfg, tapi = torch_side(arch)[:2]
    jp, tp = _params(arch, "serve-default")
    toks = _prompt(tcfg.vocab, seed=2)
    jl, jc = _jit(arch, "prefill", ("max_len", "cache_dtype"))(
        jp, {"tokens": jnp.asarray(toks)}, max_len=16,
        cache_dtype=jnp.float32)
    tl, tc = tapi.prefill(tp, {"tokens": torch.from_numpy(toks)}, 16,
                          cache_dtype=torch.float32)
    assert set(tc) == set(jc)
    step = _jit(arch, "decode_step")
    for i in range(5):
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        for key in set(tc) - {"pos"}:
            np.testing.assert_allclose(to_np(tc[key]), np.asarray(jc[key]),
                                       rtol=0, atol=ATOL, err_msg=key)
        if i == 4:
            break
        jt, tt = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
        assert np.asarray(jt).tolist() == tt.tolist()
        jl, jc = step(jp, jt, jc)
        tl, tc = tapi.decode_step(tp, tt, tc)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_slots_vs_jax(arch, layout):
    """A mixed chunk call (a prompt chunk, a shorter one) then two thin
    calls, on the same layout in both packages: logits and every cache
    leaf (the paged pools compared block by block)."""
    _, japi, tcfg, tapi = _apis(arch)
    jp, tp = _params(arch, "serve-default")
    bs = 4
    if layout == "paged":
        jc = japi.init_paged_cache(9, bs, 2, jnp.float32)
        tc = tapi.init_paged_cache(9, bs, 2, torch.float32)
        bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
        jkw, tkw = {"block_tables": jnp.asarray(bt)}, {"block_tables": bt}
    else:
        jc = japi.init_slot_cache(2, 16, jnp.float32)
        tc = tapi.init_slot_cache(2, 16, torch.float32)
        jkw = tkw = {}
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    calls = [(_prompt(tcfg.vocab, t=6, seed=3), [6, 4])] + [
        (_prompt(tcfg.vocab, t=1, seed=4 + i), [1, 1]) for i in range(2)]
    for toks, nv in calls:
        jl, jc = _jit(arch, "decode_slots")(
            jp, jnp.asarray(toks), jc, jnp.asarray(nv, jnp.int32), **jkw)
        tl, tc = tapi.decode_slots(tp, torch.from_numpy(toks), tc, nv, **tkw)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        for key in tc:
            np.testing.assert_allclose(to_np(tc[key]), np.asarray(jc[key]),
                                       rtol=0, atol=ATOL, err_msg=key)
    assert tc["lengths"].tolist() == [8, 6]


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_packs_byte_equal_and_expert_stacks_float(arch):
    """Every pack byte-equal to the reference's (q, o, the shared and the
    dense layer's gate|up groups and down, the untied head), kv_a, kv_b and
    the router float by the serving rules; and the reference fault
    (ROADMAP queue 3): the model's 4-D (L, E, k, n) expert stacks are no
    linear leaves, so the reference serves them float (bf16) on every
    preset, and the port's serving tree equals it."""
    jp, tp = _params(arch, "serve-default")
    tcfg = torch_side(arch)[0]
    assert packed_layer_paths(tp) == jax_layer_paths(jp)
    assert not [p for p in packed_layer_paths(tp) if "experts" in p]
    assert "gateup" in assert_packs_byte_equal(jp, tp)
    assert isinstance(tp["lm_head"], QuantizedDense)
    for name in ("gate", "up", "down"):
        jw = jp["blocks"]["mlp"]["experts"][name]["w"]
        tw = tp["blocks"]["mlp"]["experts"][name]["w"]
        assert jw.dtype == jnp.bfloat16 and tw.dtype == torch.bfloat16
        assert jw.ndim == tw.ndim == 4 and tuple(tw.shape) == jw.shape
        assert to_np(tw.float()).tobytes() == np.asarray(
            jw, np.float32).tobytes()
    assert tp["blocks"]["mlp"]["router"]["w"].dtype == torch.bfloat16
    if tcfg.attn == "mla":
        assert tp["blocks"]["attn"]["kv_b"]["w"].dtype == torch.bfloat16
        assert tp["dense_blocks"][0]["attn"]["kv_a"]["w"].dtype == \
            torch.bfloat16
        assert "gateup" in tp["dense_blocks"][0]["mlp"]


def _assert_trees_byte_equal(got, want, path="params"):
    """Two port serving trees: the same structure, every tensor and pack
    buffer byte-equal in the same dtype and shape, the packs' metadata
    equal."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_trees_byte_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_byte_equal(g, w, f"{path}/{i}")
    elif isinstance(want, torch.nn.Module):
        gb, wb = (dict(m.named_buffers(remove_duplicate=False))
                  for m in (got, want))
        assert list(gb) == list(wb), path
        for name in wb:
            _assert_trees_byte_equal(gb[name], wb[name], f"{path}:{name}")
        for mod_g, mod_w in zip(got.modules(), want.modules()):
            for attr in ("policy", "_blocked_dims", "_fold_keys", "names",
                         "splits"):
                assert getattr(mod_g, attr, None) == getattr(
                    mod_w, attr, None), (path, attr)
    elif isinstance(want, torch.Tensor):
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert to_np(got.reshape(-1).view(torch.uint8)).tobytes() == to_np(
            want.reshape(-1).view(torch.uint8)).tobytes(), path
    else:
        assert got == want, path


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_by_layer_byte_equal_to_whole_build(arch, backend):
    """The layer-at-a-time build (the CLI's where the float32 init and its
    serving copy do not fit on the card together) equals
    ``build_serving_params(api.init(0))`` byte for byte: the packs (with
    folds on the ``jnp`` backend, blocked codes on ``pallas``), the bf16
    leaves, the 4-D float expert stacks and the dense layers."""
    cfg = tserve.get_config(arch)
    api = tserve.build_model(cfg, "cpu")
    scfg = ServeConfig(policy=ApproxPolicy("perforated", 2, backend=backend))
    want = build_serving_params(api.init(0), cfg, scfg, device="cpu")
    got = tserve.build_serving_params_by_layer(cfg, scfg, device="cpu")
    assert got["blocks"]["mlp"]["experts"]["gate"]["w"].ndim == 4
    _assert_trees_byte_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_builds_by_layer_where_float_tree_does_not_fit(
        arch, capsys, monkeypatch):
    """Where the float init and its serving copy would not fit together,
    the CLI builds the serving params a layer at a time and serves the
    same tokens, engine and ``--legacy``; the flags that repack the float
    init are refused there."""
    flags = ["--device", "cpu", "--arch", arch, "--requests", "3",
             "--slots", "2", "--max-len", "48", "--chunk", "8", "--mode",
             "perforated"]
    legacy = ["--legacy", "--batch", "2", "--prompt-len", "9", "--gen", "4"]

    def sample(out):
        return [ln for ln in out.splitlines() if ln.startswith("sample:")]

    tserve.main(flags)
    want = _samples(capsys.readouterr().out)
    tserve.main(flags + legacy)
    want_legacy = sample(capsys.readouterr().out)
    monkeypatch.setattr(tserve, "_float_tree_fits", lambda cfg, dev: False)
    tserve.main(flags)
    out = capsys.readouterr().out
    assert "a layer at a time" in out
    assert _samples(out) == want and want[0].startswith("finished 3/3")
    tserve.main(flags + legacy)
    out = capsys.readouterr().out
    assert "a layer at a time" in out
    assert sample(out) == want_legacy and len(want_legacy) == 1
    with pytest.raises(SystemExit, match="--governor repack the float"):
        tserve.main(flags + ["--governor", "--slo-err-var", "1"])


def _run(eng, trace):
    reqs = [eng.submit(p, g) for p, g in trace]
    eng.run()
    assert all(r.finished for r in reqs)
    return [r.generated for r in reqs]


def _ecfg(cls, layout="contiguous", **kw):
    return cls(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
               cache_dtype="float32", kv_layout=layout, kv_block_size=8, **kw)


@pytest.mark.parametrize("name", ["float", "serve-default"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_vs_jax_engine(arch, name):
    """``mixed_trace`` (chat turns and long documents) through both
    engines, paged for serve-default: equal tokens and step counts."""
    jcfg, _, tcfg, tapi = _apis(arch)
    jp, tp = _params(arch, name)
    trace = mixed_trace(tcfg, 5, MAX_LEN, CHUNK, seed=0)
    assert trace == jax_mixed_trace(jcfg, 5, MAX_LEN, CHUNK, seed=0)
    layout = "paged" if name == "serve-default" else "contiguous"
    teng = ServingEngine(tcfg, tp, _ecfg(EngineConfig, layout), api=tapi)
    jeng = JaxEngine(jcfg, jp, _ecfg(JaxEngineConfig, layout))
    assert _run(teng, trace) == _run(jeng, trace)
    js, ts = jeng.metrics.snapshot(), teng.snapshot()
    for key in ("prefill_steps", "mixed_steps", "decode_steps",
                "generated_tokens", "prompt_tokens"):
        assert ts[key] == js[key], key


def test_speculative_and_probe_on_deepseek_vs_jax_engine():
    """Speculative decode (the int8 pack verifies, serve-default drafts,
    k=2) and, separately, the error probe every 2 steps on the
    serve-default pack: tokens, speculation counts and the probe's
    per-layer moments (``dense_blocks/0/...`` and ``blocks/i/...``, the
    shared experts' ``gate|up`` and ``down``) equal the JAX engine's."""
    jcfg, _, tcfg, tapi = _apis(DSV2)
    jf, tf = _params(DSV2, "float")
    jverify = jax_build(jf, jcfg, JaxServeConfig(spec=jax_get_preset("int8")))
    tverify = build_serving_params(tf, tcfg, ServeConfig(
        spec=get_preset("int8")), device="cpu")
    jdraft, tdraft = _params(DSV2, "serve-default")
    trace = mixed_trace(tcfg, 2, MAX_LEN, CHUNK, seed=1)
    teng = ServingEngine(tcfg, tverify, _ecfg(EngineConfig, speculative_k=2),
                         api=tapi, draft_params=tdraft, draft_numerics="d")
    jeng = JaxEngine(jcfg, jverify, _ecfg(JaxEngineConfig, speculative_k=2),
                     draft_params=jdraft, draft_numerics="d")
    assert _run(teng, trace) == _run(jeng, trace)
    js, ts = jeng.metrics.snapshot(), teng.snapshot()
    for key in ("drafted_tokens", "accepted_draft_tokens", "spec_rounds",
                "draft_calls"):
        assert ts[key] == js[key] > 0, key

    teng = ServingEngine(tcfg, tdraft, _ecfg(EngineConfig,
                                             error_probe_every=2), api=tapi)
    jeng = JaxEngine(jcfg, jdraft, _ecfg(JaxEngineConfig,
                                         error_probe_every=2))
    assert _run(teng, trace) == _run(jeng, trace)
    tsnap = teng.snapshot()["error_probe"]
    jsnap = jeng.metrics.snapshot()["error_probe"]
    assert tsnap["runs"] == jsnap["runs"] > 0
    assert set(tsnap["layers"]) == set(jsnap["layers"])
    assert {"dense_blocks/0/q", "dense_blocks/0/down", "blocks/1/o",
            "blocks/0/down"} <= set(tsnap["layers"])
    for key, j in jsnap["layers"].items():
        t = tsnap["layers"][key]
        assert t["n"] == j["n"], key
        assert t["err_var"] == pytest.approx(j["err_var"], rel=1e-4), key
    assert tsnap["logits_err_var"] == pytest.approx(jsnap["logits_err_var"],
                                                    rel=1e-4)


def _samples(out: str) -> list[str]:
    """The CLI's finish line and per-request sample lines."""
    return [ln.strip() for ln in out.splitlines()
            if re.match(r"\s*(req \d+:|finished )", ln)]


@pytest.mark.parametrize("mode", ["float", "perforated"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_tokens_equal_jax_cli(arch, mode, capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --device cpu --arch ...`` and
    the JAX CLI's ``--engine`` on the same weights (the port's init swapped
    for the JAX init carried by the bridge: the two packages' random
    generators differ), trace and numerics: every request finishes, with
    the JAX CLI's tokens."""
    _, _, tparams = torch_side(arch)
    monkeypatch.setattr(tlm, "init_params", lambda cfg, seed, dev: tparams)
    flags = ["--arch", arch, "--requests", "4", "--slots", "2", "--max-len",
             "48", "--chunk", "8", "--mode", mode]
    tserve.main(["--device", "cpu"] + flags)
    got = _samples(capsys.readouterr().out)
    jax_serve_main(["--engine"] + flags)
    want = _samples(capsys.readouterr().out)
    assert got[0].startswith("finished 4/4 requests")
    assert got == want and len(got) == 5


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "moonshot-v1-16b-a3b"])
def test_plan_table_byte_equal_to_jax_cli(arch, capsys):
    """The full-width ``plan`` table (meta-device shapes), byte for byte:
    no ``experts`` row, since the 4-D stacks are not linear leaves."""
    tserve.main(["plan", "--arch", arch])
    got = capsys.readouterr().out
    jax_serve_main(["plan", "--arch", arch])
    want = capsys.readouterr().out
    assert got == want and "experts" not in got
    assert "blocks/mlp/shared/gate" in got and "blocks/mlp/router" in got


def test_int8_cache_refused_on_mla():
    """An int8 cache on an MLA arch raises in every constructor (engine,
    lock-step prefill, CLI); a GQA MoE arch keeps it."""
    jcfg, _, tcfg, tapi = _apis(DSV2)
    _, tp = _params(DSV2, "float")
    with pytest.raises(ValueError, match="int8 cache is refused on an MLA"):
        ServingEngine(tcfg, tp, EngineConfig(slots=2, max_len=16,
                                             cache_dtype="int8"), api=tapi)
    with pytest.raises(ValueError, match="int8 cache is refused on an MLA"):
        tapi.prefill(tp, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                     8, cache_dtype=torch.int8)
    with pytest.raises(SystemExit, match="ROADMAP queue 3"):
        tserve.main(["--device", "cpu", "--arch", DSV2, "--cache-dtype",
                     "int8"])
    mcfg, mapi = torch_side(MOON)[:2]
    cache = mapi.init_slot_cache(2, 16, torch.int8)
    assert cache["k"].dtype == torch.int8
