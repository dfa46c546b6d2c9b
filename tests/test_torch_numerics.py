"""Port numerics core against the JAX reference: multipliers, CV statistic,
quantization, packs, policies and specs — bit- or byte-exact wherever the
arithmetic is integer."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import control_variate as jcv
from repro.core import multipliers as jam
from repro.core.approx_linear import pack_params as jax_pack_params
from repro.core.approx_linear import packed_layer_paths as jax_layer_paths
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.numerics import NumericsSpec as JaxSpec
from repro.numerics import get_preset as jax_get_preset
from repro_torch.core import control_variate as tcv
from repro_torch.core import multipliers as tam
from repro_torch.core.approx_linear import (LayerStack, QuantizedDenseGroup,
                                            pack_params, packed_layer_paths)
from repro_torch.core.policy import ApproxPolicy
from repro_torch.numerics import NumericsSpec, get_preset

from _torch_port import jax_side, to_np, torch_side

jq = importlib.import_module("repro.quant.quantize")
tq = importlib.import_module("repro_torch.quant.quantize")

#: every mode at every m the paper evaluates, plus exact
GRID = [("exact", 0)] + [(mode, m) for mode in tam.APPROX_MODES
                         for m in tam.PAPER_M_RANGE[mode]]

CODES = np.arange(256, dtype=np.int32)
W_ALL, A_ALL = np.meshgrid(CODES, CODES, indexing="ij")  # the full code grid


@pytest.mark.parametrize("mode,m", GRID)
def test_am_and_x_stat_full_code_grid(mode, m):
    got = to_np(tam.am(torch.from_numpy(W_ALL), torch.from_numpy(A_ALL), mode, m))
    want = np.asarray(jam.am(W_ALL, A_ALL, mode, m))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        to_np(tcv.x_stat(torch.from_numpy(A_ALL), mode, m)),
        np.asarray(jcv.x_stat(A_ALL, mode, m)))
    np.testing.assert_array_equal(
        to_np(tcv.sum_x(torch.from_numpy(A_ALL), mode, m)),
        np.asarray(jcv.sum_x(A_ALL, mode, m)))


@pytest.mark.parametrize("mode,m", GRID)
def test_approx_matmul_forms_full_code_grid(mode, m):
    # rows of A and columns of W are permutations of all 256 codes, so every
    # (a, w) pair meets in some product term
    k = np.arange(256)
    a = ((k[None, :] + k[:, None]) % 256).astype(np.int32)  # (256, k)
    w = ((7 * k[:, None] + k[None, :]) % 256).astype(np.int32)  # (k, 256)
    want = np.asarray(jam.approx_matmul_ref(a, w, mode, m))
    np.testing.assert_array_equal(
        to_np(tam.approx_matmul_ref(torch.from_numpy(a), torch.from_numpy(w),
                                    mode, m)), want)
    np.testing.assert_array_equal(
        to_np(tam.approx_matmul(torch.from_numpy(a), torch.from_numpy(w),
                                mode, m)), want)
    np.testing.assert_array_equal(np.asarray(jam.approx_matmul(a, w, mode, m)),
                                  want)


def test_quantize_half_way_values_bit_exact():
    # scale 2^-3: x / scale is exact, so x = (q + 0.5) * scale lands exactly
    # on the rounding tie; both packages must round half to even
    qp_j = jq.calibrate_minmax(-16.0, 15.875)
    qp_t = tq.calibrate_minmax(-16.0, 15.875)
    assert float(qp_t.scale) == float(np.asarray(qp_j.scale))
    assert int(qp_t.zero_point) == int(np.asarray(qp_j.zero_point))
    q = np.arange(-140, 140, dtype=np.float32)
    x = np.concatenate([(q + 0.5) * 0.0625, (q - 0.5) * 0.0625,
                        np.random.default_rng(0).normal(0, 6, 4096)]).astype(
        np.float32)
    for qp in (qp_t, tq.QuantParams(torch.tensor(0.0625), torch.tensor(128,
                                                                       dtype=torch.int32))):
        jqp = jq.QuantParams(jnp.float32(float(qp.scale)),
                             jnp.int32(int(qp.zero_point)))
        np.testing.assert_array_equal(
            to_np(tq.quantize(torch.from_numpy(x), qp)),
            np.asarray(jq.quantize(jnp.asarray(x), jqp)))


@pytest.mark.parametrize("mode,m", GRID)
@pytest.mark.parametrize("k,n", [(64, 128), (200, 48)])
def test_pack_and_blocked_layout_byte_equal(mode, m, k, n):
    rng = np.random.default_rng(k * 31 + m)
    w = rng.normal(0, 0.3, (k, n)).astype(np.float32)
    bias = rng.normal(0, 0.1, (n,)).astype(np.float32)
    jp = jq.pack_linear(jnp.asarray(w), jnp.asarray(bias), mode, m)
    tp = tq.pack_linear(torch.from_numpy(w), torch.from_numpy(bias), mode, m)
    for f in ("w_q", "w_scale", "w_zp", "sum_qw", "c", "c0", "bias"):
        a, b = np.asarray(getattr(jp, f)), to_np(getattr(tp, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    a_lo, a_hi = -3.5, 5.25
    jb = jq.build_blocked_layout(jp, jq.calibrate_minmax(a_lo, a_hi))
    tb = tq.build_blocked_layout(tp, tq.calibrate_minmax(a_lo, a_hi))
    assert (jb.k, jb.n, jb.bk, jb.bn) == (tb.k, tb.n, tb.bk, tb.bn)
    for f in ("w_qb", "epilogue", "meta"):
        assert np.asarray(getattr(jb, f)).tobytes() == to_np(
            getattr(tb, f)).tobytes(), f
    # fan-out-fused pack: per-column quant params, byte-equal too
    w2 = rng.normal(0, 0.7, (k, n // 2)).astype(np.float32)
    jf = jq.concat_packs([jq.pack_linear(jnp.asarray(w), None, mode, m),
                          jq.pack_linear(jnp.asarray(w2), None, mode, m)])
    tf = tq.concat_packs([tq.pack_linear(torch.from_numpy(w), None, mode, m),
                          tq.pack_linear(torch.from_numpy(w2), None, mode, m)])
    jfb = jq.build_blocked_layout(jf, jq.calibrate_minmax(a_lo, a_hi))
    tfb = tq.build_blocked_layout(tf, tq.calibrate_minmax(a_lo, a_hi))
    for f in ("w_qb", "epilogue", "meta"):
        assert np.asarray(getattr(jfb, f)).tobytes() == to_np(
            getattr(tfb, f)).tobytes(), f


def test_model_pack_byte_equal_per_layer():
    """pack_params over the whole reduced model: every fused group, member
    and blocked layout equals the reference's per-layer slice."""
    _, _, jparams = jax_side()
    _, _, tparams = torch_side()
    pol = ("perforated", 2)
    jp = jax_pack_params(jparams, lambda p: JaxPolicy(*pol, backend="pallas"))
    tp = pack_params(tparams, lambda p: ApproxPolicy(*pol, backend="pallas"))
    assert packed_layer_paths(tp) == jax_layer_paths(jp)
    for mod, grp in (("attn", "qkv"), ("mlp", "gateup")):
        jg, tg = jp["blocks"][mod][grp], tp["blocks"][mod][grp]
        assert isinstance(tg, LayerStack)
        for i in range(len(tg)):
            assert isinstance(tg[i], QuantizedDenseGroup)
            pairs = [(jg.blocked, tg[i].blocked)] + [
                (jm.blocked, tm.blocked) for jm, tm in zip(jg.members,
                                                           tg[i].members)]
            for jb, tb in pairs:
                for f in ("w_qb", "epilogue", "meta"):
                    assert np.asarray(getattr(jb, f))[i].tobytes() == to_np(
                        getattr(tb, f)).tobytes(), (mod, grp, i, f)


def test_policy_and_spec_json_round_trip_and_plan():
    pol = JaxPolicy("truncated", 5, use_cv=False, backend="pallas")
    assert ApproxPolicy.from_dict(pol.to_dict()).to_dict() == pol.to_dict()
    jspec = jax_get_preset("serve-default", policy=JaxPolicy(
        "perforated", 2, backend="pallas"))
    tspec = NumericsSpec.from_json(jspec.to_json())
    assert tspec.to_dict() == jspec.to_dict()
    assert JaxSpec.from_json(tspec.to_json()).to_dict() == jspec.to_dict()
    assert get_preset("serve-default", policy=ApproxPolicy(
        "perforated", 2, backend="pallas")).to_dict() == jspec.to_dict()
    _, _, jparams = jax_side()
    _, _, tparams = torch_side()
    jplan, tplan = jspec.resolve(jparams), tspec.resolve(tparams)
    assert [(e.path, e.policy.to_dict() if e.policy else None, e.rule,
             e.w_shape) for e in jplan.entries] == [
        (e.path, e.policy.to_dict() if e.policy else None, e.rule, e.w_shape)
        for e in tplan.entries]
    # pallas-backend packed bytes count the same canonical + blocked layout
    assert [e.packed_bytes for e in jplan.entries] == [
        e.packed_bytes for e in tplan.entries]
