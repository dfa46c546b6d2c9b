"""The port's vlm and audio archs against the JAX package: qwen2-vl-2b
(M-RoPE, embedding-input prefill with (3, B, T) position ids, then token
decode) and hubert-xlarge (encoder-only: parametric layernorm, gelu MLP
with biases, no positional rotation, bidirectional attention, untied
head), both ``-reduced``, on weights initialised once in JAX with seeded
norm scales and biases and linear biases, carried across by
repro_torch.bridge; float and packed (perforated m=2 + CV,
``backend: "pallas"``).

Tolerances.  Logits and caches are held to atol=1e-4 with equal argmax,
as the other archs' (tests/test_torch_archs.py): the measured gap is
ulps, and the bound leaves room for what re-quantization between layers
does to a ulp-level difference.  Greedy tokens must be identical, packs
byte-equal.  The M-RoPE tables and the gelu MLP: see their tests.  The
lock-step CLI loop of both archs is held to the reference's printed
tokens in tests/test_torch_legacy.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import EngineConfig as JaxEngineConfig
from repro.core.approx_linear import packed_layer_paths as jax_layer_paths
from repro.nn import layers as jlayers
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import EngineConfig, get_config
from repro_torch.core.approx_linear import QuantizedDense, packed_layer_paths
from repro_torch.nn import layers as tlayers
from repro_torch.serving import ServingEngine
from repro_torch.serving.kv_pool import SlotPool

from _torch_port import (assert_packs_byte_equal, seeded_packed, seeded_sides,
                         to_np)

VLM, AUDIO = "qwen2-vl-2b-reduced", "hubert-xlarge-reduced"
PALLAS = ("perforated", 2, True, "pallas")
ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    return jax_get_config(arch), get_config(arch)


def _pair(arch, name):
    """(jax params, port params), float or serve-default packed."""
    if name == "float":
        _, jparams, _, tparams = seeded_sides(*_cfgs(arch))
        return jparams, tparams
    return seeded_packed(*_cfgs(arch), PALLAS)


def _apis(arch):
    japi, _, tapi, _ = seeded_sides(*_cfgs(arch))
    return japi, tapi


def _embeds(b, t, d, seed):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def _mrope_ids(b, t, patch=(2, 3), start=2):
    """(3, B, T) ids: text positions on all three axes, with a block of
    ``patch`` = (rows, cols) image patches from ``start`` whose temporal id
    stays at the block's first position and whose height and width ids
    walk its rows and columns; text after the block resumes past the
    largest id, as qwen2-vl lays out an image in a prompt."""
    rows, cols = patch
    n = rows * cols
    ids = np.zeros((3, b, t), np.int32)
    for axis in range(3):
        ids[axis] = np.arange(t)
    r, c = np.divmod(np.arange(n), cols)
    ids[0, :, start:start + n] = start
    ids[1, :, start:start + n] = start + r
    ids[2, :, start:start + n] = start + c
    resume = start + max(rows, cols)
    ids[:, :, start + n:] = resume + np.arange(t - start - n)
    # rows of the batch differ: the second row's block starts one later
    if b > 1:
        ids[:, 1:, 1:] = ids[:, :1, :-1] + 1
    return ids


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("head_dim,sections", [(16, (2, 3, 3)),
                                               (128, (16, 24, 24))])
def test_mrope_angles_vs_reference(head_dim, sections, theta):
    """cos/sin tables for distinct temporal / height / width ids, sections
    concatenated in [t | h | w] order, against the reference's; float32
    pow differs between the two libraries by one ulp on some frequencies
    (as for plain RoPE, tests/test_torch_archs.py), so the tables agree to
    2e-6 at ids up to 4k; three equal ids give plain RoPE."""
    ids = _mrope_ids(2, 40)
    ids[:, :, -1] = [[4095], [3000], [2047]]
    jc, js = jlayers.mrope_angles(jnp.asarray(ids), head_dim, sections, theta)
    tc, ts = tlayers.mrope_angles(torch.from_numpy(ids).long(), head_dim,
                                  sections, theta)
    assert tc.shape == (2, 40, head_dim // 2) and tc.dtype == torch.float32
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(to_np(ts), np.asarray(js), rtol=0, atol=2e-6)
    text = torch.from_numpy(np.broadcast_to(ids[:1], ids.shape).copy()).long()
    rc, rs = tlayers.rope_angles(text[0], head_dim, theta)
    mc, ms = tlayers.mrope_angles(text, head_dim, sections, theta)
    assert torch.equal(mc, rc) and torch.equal(ms, rs)
    with pytest.raises(ValueError, match="sections"):
        tlayers.mrope_angles(text, head_dim, (1, 1, 1), theta)


def test_gelu_mlp_vs_reference():
    """The tanh form of gelu (``jax.nn.gelu``'s default) against the
    reference, on weights and biases made with numpy; the two libraries'
    tanh differ in the last ulps, so 1e-6 on outputs of order 1.  The
    exact erf form is farther from the reference than that bound."""
    rng = np.random.default_rng(3)
    p = {"up": {"w": rng.standard_normal((32, 96)) * 32 ** -0.5,
                "b": rng.standard_normal(96) * 0.1},
         "down": {"w": rng.standard_normal((96, 32)) * 96 ** -0.5,
                  "b": rng.standard_normal(32) * 0.1}}
    p = {k: {n: a.astype(np.float32) for n, a in v.items()}
         for k, v in p.items()}
    x = (rng.standard_normal((3, 7, 32)) * 2).astype(np.float32)
    want = np.asarray(jlayers.gelu_mlp(
        {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in p.items()},
        jnp.asarray(x)))
    tp = {k: {n: torch.from_numpy(a) for n, a in v.items()}
          for k, v in p.items()}
    got = to_np(tlayers.gelu_mlp(tp, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    up = torch.from_numpy(x) @ tp["up"]["w"] + tp["up"]["b"]
    erf = to_np(torch.nn.functional.gelu(up) @ tp["down"]["w"]
                + tp["down"]["b"])
    assert np.abs(erf - want).max() > 1e-4
    init = tlayers.init_gelu_mlp(8, 24, generator=torch.Generator())
    assert sorted(init) == ["down", "up"]
    assert init["up"]["b"].shape == (24,) and init["down"]["b"].shape == (8,)


@pytest.mark.parametrize("name", ["float", "packed"])
def test_vlm_embeds_prefill_then_decode_vs_jax(name):
    """qwen2-vl's multimodal prefill: (B, T, d_model) embeddings with
    (3, B, T) M-RoPE ids whose axes differ inside an image block, then
    greedy token decode steps, whose positions continue from the cache's
    and are broadcast to the three axes (the reference's rule).  Logits
    and caches within ATOL, tokens identical."""
    japi, tapi = _apis(VLM)
    jparams, tparams = _pair(VLM, name)
    tcfg = _cfgs(VLM)[1]
    b, t, gen = 2, 14, 6
    emb, ids = _embeds(b, t, tcfg.d_model, 5), _mrope_ids(b, t)
    jl, jc = japi.prefill(jparams, {"embeds": jnp.asarray(emb),
                                    "positions": jnp.asarray(ids)},
                          max_len=t + gen, cache_dtype=jnp.float32)
    tl, tc = tapi.prefill(tparams, {"embeds": torch.from_numpy(emb),
                                    "positions": torch.from_numpy(ids)},
                          t + gen, cache_dtype=torch.float32)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0, atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_np(tc[key]), np.asarray(jc[key]),
                                   rtol=0, atol=ATOL, err_msg=key)
    # the M-RoPE ids reached the cache: text-only ids give other keys
    _, tc_text = tapi.prefill(tparams, {"embeds": torch.from_numpy(emb)},
                              t + gen, cache_dtype=torch.float32)
    assert float((tc_text["k"] - tc["k"]).abs().max()) > 1e-3
    jtok, ttok = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
    jout, tout = [np.asarray(jtok)], [to_np(ttok)]
    for _ in range(gen - 1):
        jl, jc = japi.decode_step(jparams, jtok, jc)
        tl, tc = tapi.decode_step(tparams, ttok, tc)
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        jtok, ttok = jnp.argmax(jl, -1)[:, None], tl.argmax(-1)[:, None]
        jout.append(np.asarray(jtok))
        tout.append(to_np(ttok))
    np.testing.assert_array_equal(np.concatenate(tout, 1),
                                  np.concatenate(jout, 1))
    assert int(tc["pos"]) == int(jc["pos"]) == t + gen - 1


@pytest.mark.parametrize("name", ["float", "packed"])
def test_audio_encoder_forward_vs_jax(name):
    """hubert's encoder over frame embeddings: logits within ATOL with
    equal argmax; the attention is bidirectional (a change to the last
    frame moves the first frame's logits)."""
    japi, tapi = _apis(AUDIO)
    jparams, tparams = _pair(AUDIO, name)
    tcfg = _cfgs(AUDIO)[1]
    emb = _embeds(2, 12, tcfg.d_model, 6)
    jf = np.asarray(japi.forward(jparams, {"embeds": jnp.asarray(emb)}))
    tf = to_np(tapi.forward(tparams, {"embeds": torch.from_numpy(emb)}))
    assert tf.shape == (2, 12, tcfg.vocab) and tf.dtype == np.float32
    np.testing.assert_allclose(tf, jf, rtol=0, atol=ATOL)
    assert (tf.argmax(-1) == jf.argmax(-1)).all()
    emb2 = emb.copy()
    emb2[:, -1] = _embeds(2, 1, tcfg.d_model, 7)[:, 0]
    tf2 = to_np(tapi.forward(tparams, {"embeds": torch.from_numpy(emb2)}))
    assert np.abs(tf2[:, 0] - tf[:, 0]).max() > 1e-3


def test_audio_packs_byte_equal_to_jax():
    """hubert's serve-default packs: fused q|k|v (no biases), the gelu MLP's
    up and down with their biases (no gate|up group: there is no gate),
    and the untied (d_model, 504-reduced-to-vocab) head, byte-equal to the
    reference's; the same packed paths."""
    jp, tp = _pair(AUDIO, "packed")
    paths = packed_layer_paths(tp)
    assert paths == jax_layer_paths(jp)
    assert {"blocks/mlp/up", "blocks/mlp/down", "lm_head"} <= set(paths)
    assert "gateup" not in tp["blocks"]["mlp"]
    assert isinstance(tp["lm_head"], QuantizedDense)
    assert assert_packs_byte_equal(jp, tp) == {"qkv"}
    assert float(tp["blocks"]["mlp"]["up"][0].pack.bias.abs().max()) > 0


def test_engine_and_slot_pool_refuse_the_encoder_as_the_reference_does():
    """hubert has no decode step: the reference's engine refuses it, and so
    do the port's engine and slot pool (a slot cache would serve causal
    decoding, a different function)."""
    jcfg, tcfg = _cfgs(AUDIO)
    japi, jparams, tapi, tparams = seeded_sides(jcfg, tcfg)
    assert not tapi.supports_slots and not japi.supports_slots
    ek = dict(slots=2, max_len=16, prefill_chunk=8)
    with pytest.raises(NotImplementedError):
        JaxEngine(jcfg, jparams, JaxEngineConfig(**ek))
    with pytest.raises(NotImplementedError, match="slot engine"):
        ServingEngine(tcfg, tparams, EngineConfig(**ek), api=tapi)
    with pytest.raises(NotImplementedError, match="slot engine"):
        SlotPool(tapi, 2, 16)
    # a decoder keeps its slot surface
    assert _apis(VLM)[1].supports_slots
    assert SlotPool(_apis(VLM)[1], 2, 16).n_free == 2
