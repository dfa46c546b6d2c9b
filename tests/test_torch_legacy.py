"""The port's lock-step serving path (prefill, greedy decode_step, forward,
run_legacy) against the JAX package, for olmo-1b-reduced and
rwkv6-1.6b-reduced on weights initialised once in JAX and carried across
by repro_torch.bridge; float and packed (perforated m=2 + CV,
``backend: "pallas"``: the plain kernel versions here, the Pallas kernels
in interpret mode on the JAX side).

Tolerances.  Logits are held to atol=1e-4 with equal argmax, as the slot
model's are (tests/test_torch_model.py): the measured gap is ulps, and the
bound leaves room for what re-quantization between layers does to a
ulp-level difference.  Caches are held to the same atol.  Greedy tokens
must be identical.
"""

import argparse
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.approx_linear import pack_params as jax_pack_params
from repro.core.approx_linear import packed_layer_paths as jax_layer_paths
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.launch import serve as jserve
from repro.nn import attention as jattn
from repro.numerics import get_preset as jax_get_preset
from repro_torch.core.approx_linear import (LayerStack, QuantizedDenseGroup,
                                            layer_params, pack_params,
                                            packed_layer_paths)
from repro_torch.core.policy import ApproxPolicy
from repro_torch.launch import serve as tserve
from repro_torch.nn import attention as tattn
from repro_torch.numerics import NumericsSpec

from _torch_port import ARCH, RWKV_ARCH, jax_side, packed_pair, to_np, torch_side

ARCHS = [ARCH, RWKV_ARCH]
POLICIES = {"float": None, "packed": ("perforated", 2, True, "pallas")}
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _pair(arch, name):
    return packed_pair(POLICIES[name], arch)


def _prompt(vocab, b=2, t=12, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


def _cache_leaves(arch):
    return ("k", "v") if arch == ARCH else ("shift_tm", "shift_cm", "wkv")


@pytest.mark.parametrize("name", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_forward_vs_jax(arch, name):
    jparams, tparams = _pair(arch, name)
    jcfg, japi, _ = jax_side(arch)
    tcfg, tapi, _ = torch_side(arch)
    toks = _prompt(tcfg.vocab)
    t = toks.shape[1]
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=t + 8,
                          cache_dtype=jnp.float32)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)}, t + 8,
                          cache_dtype=torch.float32)
    assert tl.shape == (2, tcfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=ATOL)
    assert (to_np(tl).argmax(-1) == np.asarray(jl).argmax(-1)).all()
    assert int(tc["pos"]) == int(jc["pos"]) == t
    for key in _cache_leaves(arch):
        got, want = to_np(tc[key].float()), np.asarray(jc[key], np.float32)
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=key)
    jf = japi.forward(jparams, {"tokens": jnp.asarray(toks)})
    tf = tapi.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(to_np(tf), np.asarray(jf), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(to_np(tf).argmax(-1), np.asarray(jf).argmax(-1))


@pytest.mark.parametrize("name", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_tokens_vs_jax(arch, name):
    """8 greedy tokens after the prefill, each side from its own argmax."""
    jparams, tparams = _pair(arch, name)
    _, japi, _ = jax_side(arch)
    tcfg, tapi, _ = torch_side(arch)
    toks = _prompt(tcfg.vocab, seed=2)
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=24)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 24)
    jtok, ttok = jnp.argmax(jl, -1)[:, None], torch.argmax(tl, -1)[:, None]
    jout, tout = [np.asarray(jtok)], [to_np(ttok)]
    for _ in range(7):
        jl, jc = japi.decode_step(jparams, jtok, jc)
        tl, tc = tapi.decode_step(tparams, ttok, tc)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=ATOL)
        jtok, ttok = jnp.argmax(jl, -1)[:, None], torch.argmax(tl, -1)[:, None]
        jout.append(np.asarray(jtok))
        tout.append(to_np(ttok))
    np.testing.assert_array_equal(np.concatenate(tout, 1),
                                  np.concatenate(jout, 1))
    assert int(tc["pos"]) == int(jc["pos"]) == toks.shape[1] + 7


@pytest.mark.parametrize("name", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch, name):
    """The port's own serving path reproduces its forward logits token by
    token (tests/test_decode_consistency.py's check, held to the same
    1e-3)."""
    _, tparams = _pair(arch, name)
    tcfg, tapi, _ = torch_side(arch)
    toks = torch.from_numpy(_prompt(tcfg.vocab, seed=3))
    t = toks.shape[1]
    full = tapi.forward(tparams, {"tokens": toks})
    logits, cache = tapi.prefill(tparams, {"tokens": toks[:, :t - 2]}, t + 4,
                                 cache_dtype=torch.float32)
    assert float((logits - full[:, t - 3]).abs().max()) < 1e-3
    for i in (t - 2, t - 1):
        logits, cache = tapi.decode_step(tparams, toks[:, i:i + 1], cache)
        assert float((logits - full[:, i]).abs().max()) < 1e-3, i


def test_attention_decode_step_vs_jax():
    """One layer's decode step against the reference's, on a cache that
    init_kv_cache made and a prefix wrote; the port writes in place."""
    jparams, tparams = _pair(ARCH, "float")
    jcfg, _, _ = jax_side(ARCH)
    tcfg, _, _ = torch_side(ARCH)
    jp = {k: {"w": v["w"][0]} for k, v in jparams["blocks"]["attn"].items()}
    tp = layer_params(tparams["blocks"], 0)["attn"]
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 1, tcfg.d_model)).astype(np.float32)
    kv = rng.normal(0, 1, (2, tcfg.kv_heads, 16, tcfg.head_dim)).astype(np.float32)
    jc = jattn.init_kv_cache(jcfg.attn_config(), 2, 16, jnp.float32)
    tc = tattn.init_kv_cache(tcfg.attn_config(), 2, 16, torch.float32)
    jc = dict(jc, k=jc["k"].at[:, :, :5].set(kv[:, :, :5]),
              v=jc["v"].at[:, :, :5].set(kv[:, :, 5:10]), pos=jnp.int32(5))
    tc["k"][:, :, :5] = torch.from_numpy(kv[:, :, :5])
    tc["v"][:, :, :5] = torch.from_numpy(kv[:, :, 5:10])
    tc["pos"] = 5
    jy, jc2 = jattn.attention_decode_step(jp, jnp.asarray(x), jc,
                                          jcfg.attn_config())
    ty, tc2 = tattn.attention_decode_step(tp, torch.from_numpy(x), tc,
                                          tcfg.attn_config())
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert tc2["k"] is tc["k"] and int(tc2["pos"]) == int(jc2["pos"]) == 6
    for key in ("k", "v"):
        np.testing.assert_allclose(to_np(tc[key]), np.asarray(jc2[key]),
                                   rtol=1e-5, atol=1e-5)


def test_rwkv_packs_byte_equal_and_plan():
    """serve-default on rwkv6 packs r, k, v, g, out, key, value, receptance
    and the lm head (nothing fuses: no projection group shares an input),
    byte-equal to the reference's packs; the plan resolves the same."""
    _, _, jparams = jax_side(RWKV_ARCH)
    _, _, tparams = torch_side(RWKV_ARCH)
    pol = ("perforated", 2)
    jp = jax_pack_params(jparams, lambda p: JaxPolicy(*pol, backend="pallas"))
    tp = pack_params(tparams, lambda p: ApproxPolicy(*pol, backend="pallas"))
    paths = packed_layer_paths(tp)
    assert paths == jax_layer_paths(jp)
    assert sorted(p.split("/")[-1] for p in paths) == sorted(
        ["r", "k", "v", "g", "out", "key", "value", "receptance", "lm_head"])
    for path in paths:
        *parents, leaf = path.split("/")
        jn, tn = jp, tp
        for key in parents:
            jn, tn = jn[key], tn[key]
        jn, tn = jn[leaf], tn[leaf]
        layers = list(tn) if isinstance(tn, LayerStack) else [tn]
        for i, mod in enumerate(layers):
            assert not isinstance(mod, QuantizedDenseGroup)
            for f in ("w_qb", "epilogue", "meta"):
                want = np.asarray(getattr(jn.blocked, f))
                want = want[i] if isinstance(tn, LayerStack) else want
                assert want.tobytes() == to_np(getattr(mod.blocked, f)).tobytes(), (
                    path, i, f)
            assert np.asarray(jn.pack.w_q)[i if isinstance(tn, LayerStack)
                                           else ...].tobytes() == \
                to_np(mod.w_q).tobytes(), path
    pallas = jax_get_preset("serve-default", policy=JaxPolicy(
        *pol, backend="pallas"))
    for jspec in (jax_get_preset("serve-default"), jax_get_preset("int8"),
                  pallas):
        tspec = NumericsSpec.from_json(jspec.to_json())
        jplan, tplan = jspec.resolve(jparams), tspec.resolve(tparams)
        assert [(e.path, e.label, e.rule, e.w_shape) for e in jplan.entries] \
            == [(e.path, e.label, e.rule, e.w_shape) for e in tplan.entries]
        # packed bytes: the canonical pack plus the blocked layout
        # (pallas-backend packs) or the folded operands (the others)
        assert [e.packed_bytes for e in jplan.entries] == [
            e.packed_bytes for e in tplan.entries]


def _args(arch, spec_json=None):
    return argparse.Namespace(arch=arch, batch=2, prompt_len=12, gen=6,
                              mode="perforated", m=2, no_cv=False, preset=None,
                              spec_json=spec_json, device="cpu")


def _sample(out: str) -> str:
    return [ln for ln in out.splitlines() if ln.startswith("sample:")][-1]


@pytest.mark.parametrize("name", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS + ["qwen2-vl-2b-reduced",
                                          "hubert-xlarge-reduced"])
def test_run_legacy_prints_the_jax_sample(arch, name, tmp_path, capsys):
    """The same CLI flags give the same printed sample tokens; the port
    serves the JAX init carried across (the JAX CLI initialises with
    PRNGKey(0), as the shared set-up does).  The loop prefills a token
    prompt (qwen2-vl-2b: M-RoPE with the three ids equal; hubert-xlarge:
    bidirectional) and decodes greedily."""
    spec_json = None
    if name == "packed":
        spec = jax_get_preset("serve-default", policy=JaxPolicy(
            "perforated", 2, use_cv=True, backend="pallas"))
        spec_json = tmp_path / "spec.json"
        spec_json.write_text(spec.to_json())
    jserve.run_legacy(_args(arch, spec_json))
    want = _sample(capsys.readouterr().out)
    _, _, tparams = torch_side(arch)
    res = tserve.run_legacy(_args(arch, spec_json), params=tparams)
    got = _sample(capsys.readouterr().out)
    assert got == want
    assert res["tokens"].shape == (2, 6)
    assert json.loads(got.split(":", 1)[1]) == res["tokens"][0].tolist()


def test_engine_refuses_an_arch_without_slot_cache():
    import dataclasses

    from repro_torch.configs import EngineConfig
    from repro_torch.serving import ServingEngine

    tcfg, tapi, tparams = torch_side(RWKV_ARCH)
    assert tapi.init_slot_cache is not None and tapi.decode_slots is not None
    bare = dataclasses.replace(tapi, init_slot_cache=None, decode_slots=None)
    with pytest.raises(NotImplementedError, match="--legacy"):
        ServingEngine(tcfg, tparams, EngineConfig(slots=2, max_len=16),
                      api=bare)


@pytest.mark.parametrize("arch", ["qwen3-4b-reduced", "granite-8b-reduced",
                                  "deepseek-67b-reduced"])
def test_run_legacy_new_dense_archs_print_the_jax_sample(arch, tmp_path,
                                                         capsys):
    """The lock-step CLI loop for the dense archs beyond olmo-1b, packed
    under the same spec file in both packages."""
    spec = jax_get_preset("serve-default", policy=JaxPolicy(
        "perforated", 2, use_cv=True, backend="pallas"))
    spec_json = tmp_path / "spec.json"
    spec_json.write_text(spec.to_json())
    jserve.run_legacy(_args(arch, spec_json))
    want = _sample(capsys.readouterr().out)
    _, _, tparams = torch_side(arch)
    res = tserve.run_legacy(_args(arch, spec_json), params=tparams)
    assert _sample(capsys.readouterr().out) == want
    assert res["tokens"].shape == (2, 6)
