"""The dense archs beyond olmo-1b in the port against the JAX package:
qwen3-4b (rmsnorm, per-head qk-norm, GQA 32/8, RoPE theta 1e6), granite-8b
(theta 1e7), deepseek-67b (untied head), qwen3-4b with QKV biases and
with q_dim != d_model, and qwen2-vl-2b's token paths (M-RoPE with the
three ids equal, QKV biases, GQA 12/2), all ``-reduced``, on weights
initialised once in JAX and carried across by repro_torch.bridge.  The norm scales and biases
are ones and zeros at init; the tests give them seeded values on both
sides, so that every leaf is seen to be carried and applied.

Tolerances.  Logits are held to atol=1e-4 with equal argmax, as for
olmo-1b-reduced (tests/test_torch_model.py): the measured gap is ulps,
and the bound leaves room for what re-quantization between layers does to
a ulp-level difference.  Greedy and engine tokens must be identical, packs
byte-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.core.approx_linear import packed_layer_paths as jax_layer_paths
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.nn import layers as jlayers
from repro.numerics import get_preset as jax_get_preset
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import EngineConfig, get_config
from repro_torch.core.approx_linear import QuantizedDense, packed_layer_paths
from repro_torch.core.policy import ApproxPolicy
from repro_torch.nn import layers as tlayers
from repro_torch.numerics import get_preset
from repro_torch.serving import ServingEngine

from _torch_port import (assert_packs_byte_equal, seeded_packed, seeded_sides,
                         to_np)

#: arch id, "+qkv_bias" for the variant with Q/K/V biases, "+wide_heads"
#: for heads of 32 (q_dim 128 against d_model 64, as qwen3-4b's 4096
#: against 2560; the reduced configs otherwise have q_dim == d_model)
VARIANTS = ["qwen3-4b-reduced", "granite-8b-reduced", "deepseek-67b-reduced",
            "qwen3-4b-reduced+qkv_bias", "qwen3-4b-reduced+wide_heads",
            "qwen2-vl-2b-reduced"]
EXTRAS = {"": {}, "qkv_bias": {"qkv_bias": True},
          "wide_heads": {"head_dim": 32}}
PALLAS = ("perforated", 2, True, "pallas")
ATOL = 1e-4


def _cfgs(variant):
    arch, _, extra = variant.partition("+")
    return (dataclasses.replace(jax_get_config(arch), **EXTRAS[extra]),
            dataclasses.replace(get_config(arch), **EXTRAS[extra]))


def _sides(variant):
    """(jax cfg, jax api, jax params, port cfg, port api, port params)."""
    jcfg, tcfg = _cfgs(variant)
    japi, jparams, tapi, tparams = seeded_sides(jcfg, tcfg)
    return jcfg, japi, jparams, tcfg, tapi, tparams


def _packed(variant):
    """serve-default packs (perforated m=2 + CV, ``backend: "pallas"``) of
    the same weights in both packages."""
    return seeded_packed(*_cfgs(variant), PALLAS)


def _params(variant, name):
    if name == "float":
        return _sides(variant)[2], _sides(variant)[5]
    return _packed(variant)


def _prompt(vocab, b=2, t=12, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, t))


@pytest.mark.parametrize("name", ["float", "packed"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_logits_vs_jax(variant, name):
    _, japi, _, tcfg, tapi, _ = _sides(variant)
    jparams, tparams = _params(variant, name)
    toks = _prompt(tcfg.vocab)
    jf = np.asarray(jax.jit(japi.forward)(jparams,
                                          {"tokens": jnp.asarray(toks)}))
    tf = to_np(tapi.forward(tparams, {"tokens": torch.from_numpy(toks)}))
    assert tf.shape == (2, 12, tcfg.vocab) and tf.dtype == np.float32
    np.testing.assert_allclose(tf, jf, rtol=0, atol=ATOL)
    assert (tf.argmax(-1) == jf.argmax(-1)).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_decode_greedy_tokens_vs_jax(variant):
    """The served path: serve-default packs, prefill then greedy decode
    steps (float logits are held by test_forward_logits_vs_jax)."""
    _, japi, _, tcfg, tapi, _ = _sides(variant)
    jparams, tparams = _packed(variant)
    toks = _prompt(tcfg.vocab, seed=2)
    t, gen = toks.shape[1], 6
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                          max_len=t + gen, cache_dtype=jnp.float32)
    jstep = jax.jit(japi.decode_step)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                          t + gen, cache_dtype=torch.float32)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_np(tc[key]), np.asarray(jc[key]),
                                   rtol=0, atol=ATOL, err_msg=key)
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


@pytest.mark.parametrize("variant", VARIANTS)
def test_serving_packs_byte_equal_to_jax(variant):
    """Every pack of the serve-default tree (fused q|k|v and gate|up groups
    and their members, with the QKV biases in the variant's epilogue; the
    untied head) byte-equal to the reference's; q_norm and k_norm stay
    float, as the keep-float ``*norm`` rule says, in both plans."""
    jcfg, _, jparams, tcfg, _, tparams = _sides(variant)
    jp, tp = _packed(variant)
    assert packed_layer_paths(tp) == jax_layer_paths(jp)
    assert {"qkv", "gateup"} <= assert_packs_byte_equal(jp, tp)
    if tcfg.qkv_bias:
        qkv = tp["blocks"]["attn"]["qkv"][0]
        assert qkv.pack.bias is not None and float(
            qkv.pack.bias.abs().max()) > 0
    if not tcfg.tie_embeddings:
        assert isinstance(tp["lm_head"], QuantizedDense)
    if tcfg.qk_norm:
        for key in ("q_norm", "k_norm"):
            leaf = tp["blocks"]["attn"][key]["scale"]
            assert leaf.dtype == torch.bfloat16
            assert to_np(leaf.float()).tobytes() == np.asarray(
                jp["blocks"]["attn"][key]["scale"], np.float32).tobytes()
    spec = get_preset("serve-default", policy=ApproxPolicy(*PALLAS[:2],
                                                           backend="pallas"))
    jspec = jax_get_preset("serve-default", policy=JaxPolicy(
        *PALLAS[:2], backend="pallas"))
    tplan, jplan = spec.resolve(tparams), jspec.resolve(jparams)
    rows = [(e.path, e.policy.to_dict() if e.policy else None, e.rule)
            for e in tplan.entries]
    assert rows == [(e.path, e.policy.to_dict() if e.policy else None, e.rule)
                    for e in jplan.entries]
    assert not [r for r in rows if r[0].endswith("norm")]  # none packed
    norms = [("blocks", "attn_norm"), ("final_norm",)]
    if tcfg.qk_norm:
        norms += [("blocks", "attn", "q_norm"), ("blocks", "attn", "k_norm")]
    for path in norms:
        action, rule = spec.action_for(path)
        assert action is None and rule == "*norm", path  # FLOAT
        assert jspec.action_for(path) == (action, rule), path


def _trace(vocab, n, seed=3):
    rng = np.random.default_rng(seed)
    lens = [3, 17, 9, 25, 5]
    return [(rng.integers(0, vocab, lens[i % 5]).tolist(),
             int(rng.integers(2, 7))) for i in range(n)]


def _sequential(api, params, prompt, gen, max_len):
    """One request alone: the whole prompt in one call, then thin steps."""
    cache = api.init_slot_cache(1, max_len, torch.float32)
    logits, _ = api.decode_slots(params, torch.tensor([prompt]), cache,
                                 [len(prompt)])
    out = [int(logits[0, -1].argmax())]
    for _ in range(gen - 1):
        logits, _ = api.decode_slots(params, torch.tensor([[out[-1]]]), cache,
                                     [1])
        out.append(int(logits[0, 0].argmax()))
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_tokens_vs_jax_engine_and_sequential(variant):
    jcfg, _, _, tcfg, tapi, _ = _sides(variant)
    jp, tp = _packed(variant)
    trace = _trace(tcfg.vocab, 4)
    ek = dict(slots=2, max_len=48, prefill_chunk=8, cache_dtype="float32")
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(**ek))
    teng = ServingEngine(tcfg, tp, EngineConfig(**ek), api=tapi)
    jreqs = [jeng.submit(p, g) for p, g in trace]
    treqs = [teng.submit(p, g) for p, g in trace]
    jeng.run()
    teng.run()
    for j, t, (prompt, gen) in zip(jreqs, treqs, trace):
        assert t.finished and j.finished
        assert t.generated == j.generated, (t.rid, t.generated, j.generated)
        assert t.generated == _sequential(tapi, tp, prompt, gen,
                                          ek["max_len"])
    assert teng.snapshot()["mixed_steps"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_vs_reference(dtype):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 5, 48)) * 3).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(48)).astype(np.float32)
    want = np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                                      jnp.asarray(x).astype(dtype)),
                      np.float32)
    got = tlayers.apply_norm("rmsnorm", {"scale": torch.from_numpy(scale)},
                             torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(to_np(got.float()), want, rtol=2e-6,
                               atol=2e-6 if dtype == "float32" else 0)
    assert tlayers.init_norm("rmsnorm", 48)["scale"].tolist() == [1.0] * 48


@pytest.mark.parametrize("theta", [1e4, 1e6, 1e7])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_rope_tables_at_large_theta(theta, head_dim):
    """Inverse frequencies (to one float32 ulp) and the cos/sin tables
    against the reference's formula at qwen3's (1e6) and granite's (1e7)
    theta, out to position 32k."""
    want_f = np.asarray(jlayers.rope_freqs(head_dim, theta))
    got_f = to_np(tlayers.rope_freqs(head_dim, theta))
    np.testing.assert_allclose(got_f, want_f, rtol=2 ** -23, atol=0)
    pos = np.array([[0, 1, 7, 1023, 4095, 32767]], np.int32)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), head_dim, theta)
    tc, ts = tlayers.rope_angles(torch.from_numpy(pos).long(), head_dim,
                                 theta)
    # float32 pow differs between the two libraries by one ulp on one
    # frequency at theta 1e6 (2.9e-11); times position 32767 that moves
    # an angle by 9.5e-7, so the tables agree to 2e-6 and no closer
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(to_np(ts), np.asarray(js), rtol=0, atol=2e-6)
