"""The port's MLA and MoE modules against the JAX package, at reduced
widths with float32 weights carried from JAX as numpy arrays: DeepSeek-V2's
latent attention (decompressed prefill and weight-absorbed decode), the
router, the dropless MoE layer with float and packed (per-expert) stacks,
the per-expert grouped approximate product, the pack walker on expert
stacks, the MoE/MLA configs, and the reference's raw-cast latent cache.

Tolerances.  Float paths are held to rtol 1e-5 (the two packages' float32
GEMMs sum in different orders; the decode's absorbed einsums reorder the
reference's sums again).  The grouped product's integer sums must be
equal; its float32 outputs are held to rtol 2e-5 (atol 1e-3, as
``tests/test_grouped_approx.py``), the same float32 epilogue.  Router
indices are equal, gates within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import grouped_approx as jga
from repro.core.approx_linear import pack_dense as jax_pack_dense
from repro.core.approx_linear import packed_layer_paths as jax_layer_paths
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.nn import attention as jattn
from repro.nn import moe as jmoe
from repro.numerics import Rule as JaxRule
from repro.numerics import apply_numerics as jax_apply_numerics
from repro.numerics import uniform_spec as jax_uniform_spec
from repro.quant.quantize import QuantParams as JaxQP
from repro.quant.quantize import quantized_linear as jax_quantized_linear
from repro_torch.configs import get_config
from repro_torch.core import grouped_approx as tga
from repro_torch.core.approx_linear import (LayerStack, QuantizedDense,
                                            pack_dense, packed_layer_paths)
from repro_torch.core.policy import ApproxPolicy
from repro_torch.nn import attention as tattn
from repro_torch.nn import moe as tmoe
from repro_torch.numerics import Rule, apply_numerics, uniform_spec

from _torch_port import to_np

ARCHS = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"]
MODES = [("exact", 0), ("perforated", 2), ("recursive", 3), ("truncated", 5)]


def _tree_to_torch(tree):
    """A JAX parameter dict -> the same dict of float32 torch tensors."""
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree, np.float32).copy())


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_counts_equal_reference(arch, reduced):
    name = arch + ("-reduced" if reduced else "")
    jcfg, tcfg = jax_get_config(name), get_config(name)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    # the port has no expert parallelism: no impl, capacity or mesh axis
    tmoe_cfg = dataclasses.asdict(tcfg.moe_config())
    jmoe_cfg = dataclasses.asdict(jcfg.moe_config())
    assert tmoe_cfg == {k: jmoe_cfg[k] for k in tmoe_cfg}
    assert set(jmoe_cfg) - set(tmoe_cfg) == {"impl", "capacity_factor",
                                             "ep_axis"}
    assert dataclasses.asdict(tcfg.mla_config()) == dataclasses.asdict(
        jcfg.mla_config())


def test_deepseek_counts():
    """15.7 B parameters, 2.66 B active a token, 14.4 B in the routed
    experts."""
    cfg = get_config("deepseek-v2-lite-16b")
    assert cfg.param_count() == 15_706_357_760
    assert cfg.active_param_count() == 2_661_023_744
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    assert cfg.n_scan_layers * cfg.n_experts * per_expert == 14_394_851_328


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _mla_pair():
    jcfg = jax_get_config("deepseek-v2-lite-16b-reduced").mla_config()
    tcfg = get_config("deepseek-v2-lite-16b-reduced").mla_config()
    jp = jattn.init_mla(jax.random.PRNGKey(3), jcfg)
    # a seeded latent norm scale, so that it is seen to be applied
    scale = 1 + 0.2 * np.random.default_rng(4).standard_normal(
        jcfg.kv_lora_rank)
    jp["kv_a_norm"]["scale"] = jnp.asarray(scale, jnp.float32)
    return jcfg, tcfg, jp, _tree_to_torch(jp)


def test_mla_prefill_and_absorbed_decode_vs_reference():
    jcfg, tcfg, jp, tp = _mla_pair()
    rng = np.random.default_rng(5)
    b, t, steps, s = 2, 7, 4, 16
    x = rng.standard_normal((b, t, jcfg.d_model)).astype(np.float32)
    _close(tattn.mla_prefill(tp, torch.from_numpy(x), tcfg),
           jattn.mla_prefill(jp, jnp.asarray(x), jcfg))
    jc = jattn.init_mla_cache(jcfg, b, s, jnp.float32)
    tc = tattn.init_mla_cache(tcfg, b, s, torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items() if k != "pos"} == {
        k: v.shape for k, v in jc.items() if k != "pos"}
    for i in range(steps):
        xt = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jattn.mla_decode_step(jp, jnp.asarray(xt), jc, jcfg)
        ty, tc = tattn.mla_decode_step(tp, torch.from_numpy(xt), tc, tcfg)
        _close(ty, jy)
        assert tc["pos"] == int(jc["pos"]) == i + 1
        for key in ("latent", "rope"):
            _close(tc[key], jc[key])


def test_mla_latent_int8_raw_cast_zeroes_most_of_it():
    """The reference fault (ROADMAP queue 3): ``_mla_slots`` and
    ``mla_decode_step`` write the RMS-normed latent with a raw
    ``astype(int8)`` where GQA's cache scales by KV_INT8_SCALE
    (``_to_cache``).  The raw cast truncates every |x| < 1 to 0; the
    fixed-point cast keeps all but |x| < 1/32.  The port refuses an int8
    cache on an MLA arch."""
    jcfg, _, jp, _ = _mla_pair()
    x = np.random.default_rng(6).standard_normal((4, 64, jcfg.d_model))
    pos = jnp.broadcast_to(jnp.arange(64, dtype=jnp.int32), (4, 64))
    latent, _ = jattn._mla_latent(jp, jnp.asarray(x, jnp.float32), jcfg, pos)
    raw = np.asarray(latent.astype(jnp.int8))
    fixed = np.asarray(jattn._to_cache(latent, jnp.int8))
    lat = np.asarray(latent)
    raw_zero, fixed_zero = float((raw == 0).mean()), float((fixed == 0).mean())
    assert raw_zero == pytest.approx(float((np.abs(lat) < 1).mean()))
    assert raw_zero > 0.6 and fixed_zero < 0.05, (raw_zero, fixed_zero)
    # the reference's decode path really writes the raw cast
    jc = jattn.init_mla_cache(jcfg, 4, 8, jnp.int8)
    _, jc = jattn.mla_decode_step(jp, jnp.asarray(x[:, :1], jnp.float32),
                                  jc, jcfg)
    assert np.array_equal(np.asarray(jc["latent"][:, 0]), raw[:, 0])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_pair(n_shared=1, seed=0):
    jcfg = jmoe.MoEConfig(d_model=32, d_ff_expert=16, n_experts=8, top_k=2,
                          n_shared=n_shared)
    tcfg = tmoe.MoEConfig(d_model=32, d_ff_expert=16, n_experts=8, top_k=2,
                          n_shared=n_shared)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _tree_to_torch(jp)


@pytest.mark.parametrize("router_dtype", ["float32", "bfloat16"])
def test_route_equal_to_reference(router_dtype):
    """Indices equal, gates and probabilities within 1e-6; a bf16 router
    leaf (as ``build_serving_params`` leaves it) is promoted to the
    float32 input's type on both sides."""
    jcfg, tcfg, jp, tp = _moe_pair()
    jp = {"router": {"w": jp["router"]["w"].astype(router_dtype)}}
    tp = {"router": {"w": torch.from_numpy(np.asarray(
        jp["router"]["w"], np.float32).copy()).to(
            getattr(torch, router_dtype))}}
    x = np.random.default_rng(1).standard_normal((40, 32)).astype(np.float32)
    for xdt in ("float32", "bfloat16"):
        jg, ji, jpr = jmoe._route(jp, jnp.asarray(x).astype(xdt), jcfg)
        tg, ti, tpr = tmoe._route(tp, torch.from_numpy(x).to(
            getattr(torch, xdt)), tcfg)
        assert tg.dtype == tpr.dtype == torch.float32
        assert np.array_equal(to_np(ti), np.asarray(ji))
        np.testing.assert_allclose(to_np(tg), np.asarray(jg), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(to_np(tpr), np.asarray(jpr), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_apply_float_vs_reference(n_shared):
    jcfg, tcfg, jp, tp = _moe_pair(n_shared)
    x = np.random.default_rng(2).standard_normal((2, 12, 32)).astype(
        np.float32)
    _close(tmoe.moe_apply(tp, torch.from_numpy(x), tcfg),
           jmoe.moe_apply(jp, jnp.asarray(x), jcfg))


def test_moe_expert_rows_independent_of_the_batch():
    """A token's routed output is bit-equal whatever rides beside it: the
    padded batched expert GEMMs fix each row's arithmetic by the call's
    shape alone."""
    _, tcfg, _, tp = _moe_pair()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 12, 32)).astype(np.float32))
    other = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 12, 32)).astype(np.float32))
    mixed = torch.cat([x[:, :5], other[:, 5:]], dim=1)
    assert torch.equal(tmoe.moe_apply(tp, x, tcfg)[:, :5],
                       tmoe.moe_apply(tp, mixed, tcfg)[:, :5])


def _packed_moe(mode, m, backend="jnp"):
    """The reference's own packed-expert MoE test set-up in both packages:
    the router kept float, every other leaf packed."""
    jcfg, tcfg, jp, tp = _moe_pair()
    jspec = jax_uniform_spec(JaxPolicy(mode, m, backend=backend),
                             rules=(JaxRule("router"),))
    tspec = uniform_spec(ApproxPolicy(mode, m, backend=backend),
                         rules=(Rule("router"),))
    jpk = jax_apply_numerics(jp, jspec.resolve(jp), default_range=(-6.0, 6.0))
    tpk = apply_numerics(tp, tspec.resolve(tp), default_range=(-6.0, 6.0))
    return jcfg, tcfg, jpk, tpk


@pytest.mark.parametrize("mode,m", MODES)
def test_moe_apply_packed_stacks_vs_reference(mode, m):
    """Packed 3-D expert stacks: one pack an expert (per-expert quant and
    CV constants, byte-equal to the reference's vmapped pack), no folded
    operands, no fused group inside ``experts`` (the shared swiglu's
    gate|up fuses); moe_apply through the grouped path."""
    jcfg, tcfg, jpk, tpk = _packed_moe(mode, m)
    assert packed_layer_paths(tpk) == jax_layer_paths(jpk)
    assert "gateup" in tpk["shared"] and "gate" in tpk["experts"]
    for name in ("gate", "up", "down"):
        stack, jqd = tpk["experts"][name], jpk["experts"][name]
        assert isinstance(stack, LayerStack) and len(stack) == 8
        assert all(mod.fold is None for mod in stack.layers)
        assert jqd.fold is None
        for e, mod in enumerate(stack.layers):
            for f in ("w_q", "w_scale", "w_zp", "sum_qw", "c", "c0"):
                assert to_np(getattr(mod.pack, f)).tobytes() == np.asarray(
                    getattr(jqd.pack, f)[e]).tobytes(), (name, e, f)
            assert to_np(mod.a_scale).tobytes() == np.asarray(
                jqd.a_qp.scale[e]).tobytes()
    x = np.random.default_rng(7).standard_normal((2, 12, 32)).astype(
        np.float32)
    _close(tmoe.moe_apply(tpk, torch.from_numpy(x), tcfg),
           jmoe.moe_apply(jpk, jnp.asarray(x), jcfg), rtol=2e-5, atol=1e-5)


def test_moe_apply_long_input_in_token_pieces_vs_reference(monkeypatch):
    """300 tokens take the routed experts in TOKEN_CHUNK pieces (128, 128,
    44), so the padded expert buffers stay at E x 128 rows: the output
    equals the reference's whole-call MoE, and a piece's rows are
    bit-equal to the same rows served alone."""
    jcfg, tcfg, jp, tp = _moe_pair()
    x = np.random.default_rng(5).standard_normal((2, 150, 32)).astype(
        np.float32)
    rows = []
    local = tmoe._moe_local
    monkeypatch.setattr(tmoe, "_moe_local", lambda p, xf, c: (
        rows.append(xf.shape[0]), local(p, xf, c))[1])
    got = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert rows == [128, 128, 44]
    _close(got, jmoe.moe_apply(jp, jnp.asarray(x), jcfg))
    head = tmoe.moe_apply(tp, torch.from_numpy(x[:1, :128]), tcfg)
    assert torch.equal(got[:1, :128], head)


# ---------------------------------------------------------------------------
# the per-expert grouped approximate product
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MODES, ids=[m for m, _ in MODES])
def grouped(request):
    """The reference test's set-up: 4 experts (one with no rows), packed
    per expert in both packages."""
    mode, m = request.param
    rng = np.random.default_rng(0)
    e, k, n = 4, 32, 16
    w = rng.normal(0, 0.1, (e, k, n)).astype(np.float32)
    jqd = jax_pack_dense({"w": jnp.asarray(w)}, JaxPolicy(mode, m),
                         (-4.0, 4.0), fold=False)
    tqd = pack_dense({"w": torch.from_numpy(w)}, ApproxPolicy(mode, m),
                     (-4.0, 4.0), fold=False)
    gs = np.array([3, 0, 5, 2], np.int32)
    xs = rng.normal(0, 1.0, (int(gs.sum()), k)).astype(np.float32)
    return mode, m, jqd, tqd, gs, xs


def test_grouped_integer_sums_equal_reference(grouped):
    mode, m, jqd, tqd, gs, xs = grouped
    a = np.random.default_rng(1).integers(0, 256, xs.shape).astype(np.int32)
    w_q = np.asarray(jqd.pack.w_q)
    want = np.asarray(jga._approx_ragged(jnp.asarray(a), jnp.asarray(w_q),
                                         jnp.asarray(gs), mode, m))
    got = tga._approx_ragged(torch.from_numpy(a), torch.from_numpy(w_q),
                             torch.from_numpy(gs).long(), mode, m)
    assert np.array_equal(to_np(got).astype(np.int64), want.astype(np.int64))
    ids = tga._row_expert_ids(torch.from_numpy(gs).long(), len(xs))
    assert np.array_equal(to_np(ids), np.asarray(jga._row_expert_ids(
        jnp.asarray(gs), len(xs))))


def test_grouped_dense_vs_reference_and_per_expert(grouped):
    """Equal to the reference's grouped product, and each expert's rows
    equal to that expert's single-layer quantized path (the reference
    test's check)."""
    mode, m, jqd, tqd, gs, xs = grouped
    tgs = torch.from_numpy(gs).long()
    got = to_np(tga.grouped_quantized_dense(tqd, torch.from_numpy(xs), tgs))
    want = np.asarray(jga.grouped_quantized_dense(jqd, jnp.asarray(xs),
                                                  jnp.asarray(gs)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-3)
    row = 0
    for e, cnt in enumerate(gs):
        if cnt:
            pack_e = jax.tree.map(lambda a, e=e: a[e], jqd.pack)
            qp_e = JaxQP(jqd.a_qp.scale[e], jqd.a_qp.zero_point[e])
            ref = np.asarray(jax_quantized_linear(
                jnp.asarray(xs[row:row + cnt]), pack_e, qp_e, mode, m,
                use_cv=True))
            np.testing.assert_allclose(got[row:row + cnt], ref, rtol=1e-5,
                                       atol=1e-3)
        row += cnt


def test_grouped_swiglu_vs_reference(grouped):
    mode, m, jqd, tqd, gs, xs = grouped
    rng = np.random.default_rng(2)
    wd = rng.normal(0, 0.1, (4, 16, 32)).astype(np.float32)
    jexp = {"gate": jqd, "up": jqd, "down": jax_pack_dense(
        {"w": jnp.asarray(wd)}, JaxPolicy(mode, m), (-4.0, 4.0), fold=False)}
    texp = {"gate": tqd, "up": tqd, "down": pack_dense(
        {"w": torch.from_numpy(wd)}, ApproxPolicy(mode, m), (-4.0, 4.0),
        fold=False)}
    got = tga.grouped_quantized_swiglu(texp, torch.from_numpy(xs),
                                       torch.from_numpy(gs).long())
    want = jga.grouped_quantized_swiglu(jexp, jnp.asarray(xs),
                                        jnp.asarray(gs))
    _close(got, want, rtol=2e-5, atol=1e-3)


def test_pack_walker_expert_stacks():
    """A standalone 3-D expert stack packs per expert and a model's 4-D
    stacks stay float, as ``is_linear_params`` says in both packages; a
    pallas-backend expert stack carries a blocked layout per expert."""
    w3 = torch.randn(4, 32, 16)
    tree = {"experts": {"gate": {"w": w3}, "up": {"w": w3.clone()},
                        "down": {"w": torch.randn(4, 16, 32)}},
            "stacked": {"gate": {"w": torch.randn(2, 4, 32, 16)}}}
    spec = uniform_spec(ApproxPolicy("perforated", 2, backend="pallas"))
    plan = spec.resolve(tree)
    assert [e.path for e in plan.entries] == [
        "experts/gate", "experts/up", "experts/down"]
    packed = apply_numerics(tree, plan)
    assert isinstance(packed["experts"]["gate"], LayerStack)
    assert all(isinstance(mod, QuantizedDense) and mod.blocked is not None
               for mod in packed["experts"]["gate"].layers)
    assert packed["stacked"]["gate"]["w"] is tree["stacked"]["gate"]["w"]
