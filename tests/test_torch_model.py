"""The port's olmo-1b-reduced slot model against the JAX model, on weights
initialised once in JAX and carried across by repro_torch.bridge.

Tolerances.  Per packed layer the port is held to the reference kernel's
contract, rtol=2e-5 plus four float32 ulps of the epilogue's 255*255*K
terms.  Per model the logits are held to atol=1e-4 with equal argmax: the
measured gap on these seeds is below 1e-6, and the bound leaves room for
what re-quantization between layers does to a ulp-level difference — one
activation code that rounds the other way changes the next layer's output
by about sa*sw*|w|, far below 1e-4 at these widths, but compounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx_linear as jal
from repro_torch.core import approx_linear as tal
from repro_torch.core.policy import ApproxPolicy

from _torch_port import jax_side, packed_pair, to_np, torch_side

POLICIES = {"float": None,
            "perforated-2": ("perforated", 2, True, "pallas"),
            "truncated-5": ("truncated", 5, True, "pallas")}


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(POLICIES))
def test_decode_slots_logits_vs_jax(name, cache_dtype):
    jparams, tparams = packed_pair(POLICIES[name])
    jcfg, japi, _ = jax_side()
    tcfg, tapi, _ = torch_side()
    slots, S, C = 2, 32, 8
    jc = japi.init_slot_cache(slots, S, jnp.dtype(cache_dtype))
    tc = tapi.init_slot_cache(slots, S, getattr(torch, cache_dtype))
    jstep = jax.jit(japi.decode_slots)
    rng = np.random.default_rng(1)
    calls = [(rng.integers(0, tcfg.vocab, (slots, C)), [C, 5])]
    calls += [(rng.integers(0, tcfg.vocab, (slots, 1)), [1, 1])
              for _ in range(4)]
    for toks, nv in calls:
        toks = toks.astype(np.int32)
        nv = np.asarray(nv, np.int32)
        jl, jc = jstep(jparams, jnp.asarray(toks), jc, jnp.asarray(nv))
        tl, tc = tapi.decode_slots(tparams, torch.from_numpy(toks).long(), tc,
                                   nv)
        jl, tl = np.asarray(jl), to_np(tl)
        assert tl.shape == jl.shape and tl.dtype == np.float32
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
        for b in range(slots):  # the column the engine reads per row
            col = nv[b] - 1
            assert tl[b, col].argmax() == jl[b, col].argmax()
    np.testing.assert_array_equal(to_np(tc["lengths"]), np.asarray(jc["lengths"]))


def _atol(k, sa, sw):
    return 4 * float(np.finfo(np.float32).eps) * 255.0 ** 2 * k * sa * sw


@pytest.mark.parametrize("name", ["perforated-2", "truncated-5"])
def test_packed_layers_vs_jax_per_layer(name):
    """Every packed layer (fused groups at prefill rows, members at decode
    rows) within the kernel contract of the reference's Pallas path."""
    jparams, tparams = packed_pair(POLICIES[name])
    rng = np.random.default_rng(2)
    for i in range(2):
        jb = jax.tree.map(lambda a: a[i], jparams["blocks"])
        tb = tal.layer_params(tparams["blocks"], i)
        for mod, key in (("attn", "qkv"), ("attn", "o"), ("mlp", "gateup"),
                         ("mlp", "down")):
            jl, tl = jb[mod][key], tb[mod][key]
            k = tl.w_q.shape[0]
            for rows in (4, 16):  # decode (members) and prefill (fused)
                x = rng.normal(0, 1.5, (1, rows, k)).astype(np.float32)
                if key in ("qkv", "gateup"):
                    jo = jal.dense_group(jl, jnp.asarray(x))
                    to = tal.dense_group(tl, torch.from_numpy(x))
                    pairs = [(jo[n], to[n], mem) for n, mem in
                             zip(tl.names, tl.members)]
                else:
                    pairs = [(jal.dense(jl, jnp.asarray(x)),
                              tal.dense(tl, torch.from_numpy(x)), tl)]
                for j, t, mem in pairs:
                    np.testing.assert_allclose(
                        to_np(t), np.asarray(j), rtol=2e-5,
                        atol=_atol(k, float(mem.a_scale),
                                   float(mem.w_scale.max())))


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("mode,m", [("perforated", 2), ("recursive", 3),
                                    ("truncated", 6), ("exact", 0)])
def test_fused_group_bit_identical_to_members(mode, m, backend):
    _, _, tparams = torch_side()
    packed = tal.pack_params(tparams, lambda p: ApproxPolicy(
        mode, m, backend=backend))
    rng = np.random.default_rng(3)
    for mod, key in (("attn", "qkv"), ("mlp", "gateup")):
        g = tal.layer_params(packed["blocks"], 1)[mod][key]
        x = torch.from_numpy(rng.normal(0, 2, (2, 7, g.w_q.shape[0])).astype(
            np.float32))  # 14 rows: the wide fused call
        fused = tal.dense_group(g, x)
        for name, member in zip(g.names, g.members):
            assert torch.equal(fused[name], tal.dense(member, x)), (key, name)


def test_high_cursor_write_lands_at_cursor():
    """A decode row whose cursor is past max_len - chunk rides a
    chunk-shaped call: its K/V land at exactly lengths[b], history and the
    rest of the stripe untouched; values match the thin call."""
    _, tparams = packed_pair(None)
    tcfg, tapi, _ = torch_side()
    S, CH = 64, 16
    rng = np.random.default_rng(3)
    cache = tapi.init_slot_cache(2, S, torch.float32)
    for _ in range(3):
        toks = np.zeros((2, CH), np.int64)
        toks[0] = rng.integers(0, tcfg.vocab, CH)
        tapi.decode_slots(tparams, torch.from_numpy(toks), cache, [CH, 0])
    for _ in range(12):
        toks = np.zeros((2, 1), np.int64)
        toks[0] = rng.integers(0, tcfg.vocab)
        tapi.decode_slots(tparams, torch.from_numpy(toks), cache, [1, 0])
    assert int(cache["lengths"][0]) == 60
    before = {k: v.clone() for k, v in cache.items()}

    tok0 = int(rng.integers(0, tcfg.vocab))
    mixed = np.zeros((2, CH), np.int64)
    mixed[0, 0] = tok0
    mixed[1] = rng.integers(0, tcfg.vocab, CH)
    mixed_cache = {k: v.clone() for k, v in before.items()}
    ml, _ = tapi.decode_slots(tparams, torch.from_numpy(mixed), mixed_cache,
                              [1, CH])
    thin = np.zeros((2, 1), np.int64)
    thin[0, 0] = tok0
    thin_cache = {k: v.clone() for k, v in before.items()}
    tl, _ = tapi.decode_slots(tparams, torch.from_numpy(thin), thin_cache,
                              [1, 0])
    assert mixed_cache["lengths"].tolist() == [61, CH]
    for key in ("k", "v"):
        got, want, old = (c[key][:, 0] for c in (mixed_cache, thin_cache,
                                                 before))
        assert torch.equal(got[..., :60, :], old[..., :60, :]), key
        assert torch.equal(got[..., 61:, :], old[..., 61:, :]), key
        assert not torch.equal(got[..., 60, :], old[..., 60, :]), key
        torch.testing.assert_close(got[..., 60, :], want[..., 60, :],
                                   rtol=1e-5, atol=1e-5)
        # slot 1's chunk landed at [0, CH) of its own stripe
        assert not torch.equal(mixed_cache[key][:, 1, :, :CH],
                               before[key][:, 1, :, :CH])
    torch.testing.assert_close(ml[0, 0], tl[0, 0], rtol=1e-5, atol=1e-5)


def test_rollback_slots_is_a_complete_rollback():
    """Retreating a cursor and re-decoding gives the logits of a cache that
    never saw the rolled-back tokens (stale K/V is masked, then
    overwritten)."""
    from repro_torch.models.lm import rollback_slots

    _, tparams = packed_pair(("perforated", 2, True, "pallas"))
    tcfg, tapi, _ = torch_side()
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, tcfg.vocab, (2, 6)))
    junk = torch.from_numpy(rng.integers(0, tcfg.vocab, (2, 3)))
    nxt = torch.from_numpy(rng.integers(0, tcfg.vocab, (2, 1)))

    clean = tapi.init_slot_cache(2, 16, torch.float32)
    tapi.decode_slots(tparams, prompt, clean, [6, 6])
    want, _ = tapi.decode_slots(tparams, nxt, clean, [1, 1])

    cache = tapi.init_slot_cache(2, 16, torch.float32)
    tapi.decode_slots(tparams, prompt, cache, [6, 6])
    tapi.decode_slots(tparams, junk, cache, [3, 3])
    rollback_slots(cache, [6, 6])
    got, _ = tapi.decode_slots(tparams, nxt, cache, [1, 1])
    assert torch.equal(got, want)
    assert cache["lengths"].tolist() == [7, 7]
