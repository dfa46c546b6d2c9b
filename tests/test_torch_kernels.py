"""The port's two kernel ops, on the CPU (plain versions), against the JAX
kernels in interpret mode and the scalar oracle.

Tolerance: rtol=2e-5 (the reference's own kernel contract,
docs/kernels.md) plus an absolute floor.  The integer accumulators are
exact on both sides; the float32 epilogue adds and subtracts terms of
magnitude up to 255*255*K (accumulator, zero-point corrections) before
scaling by sa*sw, so four float32 ulps of 255*255*K, times sa*sw, bound what
two roundings of the epilogue can differ by (the reference's CPU compile
may contract a multiply-add; its wrapper reorders the terms when it pads K).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.policy import ApproxPolicy
from repro_torch.kernels import approx_matmul as amk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_port import to_np

import importlib

jq = importlib.import_module("repro.quant.quantize")
tq = importlib.import_module("repro_torch.quant.quantize")

RTOL = 2e-5
MODES = [("exact", 0), ("perforated", 1), ("perforated", 3), ("recursive", 2),
         ("recursive", 4), ("truncated", 5), ("truncated", 7)]


def _atol(k, sa, sw):
    """Four float32 ulps of the largest epilogue term, scaled to output."""
    return 4 * float(np.finfo(np.float32).eps) * 255.0 ** 2 * k * sa * sw


def _codes_case(rng, mm, kk, nn):
    a_q = rng.integers(0, 256, (mm, kk)).astype(np.uint8)
    w_q = rng.integers(0, 256, (kk, nn)).astype(np.uint8)
    c = rng.normal(100, 30, (nn,)).astype(np.float32)
    c0 = rng.normal(0, 10, (nn,)).astype(np.float32)
    sqw = w_q.astype(np.int64).sum(0).astype(np.int32)
    bias = rng.normal(0, 1, (nn,)).astype(np.float32)
    return a_q, w_q, c, c0, sqw, bias


@pytest.mark.parametrize("mode,m", MODES)
@pytest.mark.parametrize("shape", [(8, 32, 16), (64, 200, 48), (128, 512, 128),
                                   (4, 300, 40)])
def test_codes_kernel_plain_vs_jax(mode, m, shape):
    rng = np.random.default_rng(sum(shape) + m)
    arrays = _codes_case(rng, *shape)
    scalars = (0.015, 0.02, 7.0, 131.0)
    got = to_np(tops.approx_matmul_cv_op(*map(torch.from_numpy, arrays),
                                         *scalars, mode=mode, m=m))
    want_k = np.asarray(jops.approx_matmul_cv_op(*arrays, *scalars, mode=mode,
                                                 m=m, interpret=True))
    want_r = np.asarray(jref.approx_matmul_cv_ref(*arrays, *scalars, mode=mode,
                                                  m=m))
    atol = _atol(shape[1], scalars[0], scalars[1])
    np.testing.assert_allclose(got, want_k, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(got, want_r, rtol=RTOL, atol=atol)
    port_ref = to_np(tref.approx_matmul_cv_ref(*map(torch.from_numpy, arrays),
                                               *scalars, mode=mode, m=m))
    np.testing.assert_allclose(got, port_ref, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("use_cv", [True, False])
def test_codes_kernel_cv_flag_and_leading_dims(use_cv):
    rng = np.random.default_rng(11)
    a_q, w_q, c, c0, sqw, bias = _codes_case(rng, 15, 40, 24)
    a3 = a_q.reshape(3, 5, 40)
    scalars = (0.01, 0.02, 1.0, 2.0)
    got = to_np(tops.approx_matmul_cv_op(
        torch.from_numpy(a3), *map(torch.from_numpy, (w_q, c, c0, sqw, bias)),
        *scalars, mode="recursive", m=3, use_cv=use_cv))
    want = np.asarray(jops.approx_matmul_cv_op(
        a3, w_q, c, c0, sqw, bias, *scalars, mode="recursive", m=3,
        use_cv=use_cv, interpret=True))
    assert got.shape == (3, 5, 24)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=_atol(40, 0.01, 0.02))


def _blocked_pair(rng, kk, nn, mode, m, members=1):
    """The same float weights packed and blocked by both packages."""
    ws = [rng.normal(0, kk ** -0.5, (kk, nn // members)).astype(np.float32)
          for _ in range(members)]
    jp = [jq.pack_linear(jnp.asarray(w), None, mode, m) for w in ws]
    tp = [tq.pack_linear(torch.from_numpy(w), None, mode, m) for w in ws]
    jp = jp[0] if members == 1 else jq.concat_packs(jp)
    tp = tp[0] if members == 1 else tq.concat_packs(tp)
    return (jq.build_blocked_layout(jp, jq.calibrate_minmax(-4.0, 4.0)),
            tq.build_blocked_layout(tp, tq.calibrate_minmax(-4.0, 4.0)))


@pytest.mark.parametrize("mode,m", MODES)
@pytest.mark.parametrize("mm,kk,nn,members,dtype", [
    (4, 64, 192, 3, "float32"),     # decode M <= 8, fused q|k|v pack
    (16, 200, 48, 1, "float32"),    # ragged K and N
    (40, 128, 256, 2, "bfloat16"),  # prefill-shaped, bf16, fused gate|up
])
def test_fused_kernel_plain_vs_jax(mode, m, mm, kk, nn, members, dtype):
    rng = np.random.default_rng(mm * kk + m)
    jb, tb = _blocked_pair(rng, kk, nn, mode, m, members)
    x = rng.normal(0, 1.5, (mm, kk)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tops.quantized_dense_fused_op(xt, tb, mode=mode, m=m)
    want = jops.quantized_dense_fused_op(xj, jb, mode=mode, m=m, interpret=True)
    assert got.dtype == xt.dtype and tuple(got.shape) == (mm, nn)
    got32 = to_np(got.float())
    want32 = np.asarray(want.astype(jnp.float32))
    atol = _atol(kk, float(tb.meta[0, 0]), float(tb.epilogue[4].max()))
    # bf16 output: one bf16 rounding of float32 values that agree to ulps
    rtol = RTOL if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got32, want32, rtol=rtol, atol=atol)
    # the oracle over the same codes: quantize with the pack's own params
    a_q = tq.quantize(xt.float(), tq.QuantParams(tb.meta[0, 0],
                                                 tb.meta[0, 1].to(torch.int32)))
    epi = tb.epilogue[:, :nn]
    if members == 1:  # per-tensor weight quant params: the scalar oracle
        want_r = to_np(tref.approx_matmul_cv_ref(
            a_q, tb.w_qb[:kk, :nn], epi[0], epi[1], epi[2], epi[3],
            tb.meta[0, 0], epi[4, 0], tb.meta[0, 1], epi[5, 0], mode=mode, m=m))
        np.testing.assert_allclose(got32, want_r, rtol=rtol, atol=atol)


def test_launch_counter_stays_zero_on_cpu():
    before = (amk.approx_matmul_cv_fused.launches, amk.approx_matmul_cv.launches)
    rng = np.random.default_rng(3)
    _, tb = _blocked_pair(rng, 32, 16, "perforated", 2)
    tops.quantized_dense_fused_op(torch.randn(3, 32), tb, mode="perforated", m=2)
    tops.approx_matmul_cv_op(*map(torch.from_numpy, _codes_case(rng, 3, 32, 16)),
                             0.1, 0.1, 1.0, 2.0, mode="perforated", m=2)
    assert (amk.approx_matmul_cv_fused.launches,
            amk.approx_matmul_cv.launches) == before == (0, 0)


class _CudaLike:
    """Stands in for a CUDA tensor where the sandbox has no card: the
    wrapper reads only its device before it needs the kernel library."""

    def __init__(self, t: torch.Tensor):
        self._t = t
        self.device = torch.device("cuda")
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return True


def test_cuda_call_without_the_library_raises(monkeypatch):
    monkeypatch.setattr(amk, "_LIB", None)
    monkeypatch.setattr(amk, "BUILD_DIR", amk.BUILD_DIR.parent / "no-such-build")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    rng = np.random.default_rng(4)
    _, tb = _blocked_pair(rng, 32, 16, "perforated", 2)
    x = _CudaLike(torch.randn(3, 32))
    with pytest.raises(RuntimeError, match="nvcc"):
        amk.approx_matmul_cv_fused(x, tb.w_qb, tb.epilogue, tb.meta, k=32,
                                   n=16, mode="perforated", m=2)
    a = _CudaLike(torch.zeros(3, 32, dtype=torch.uint8))
    with pytest.raises(RuntimeError, match="nvcc"):
        amk.approx_matmul_cv(a, tb.w_qb, tb.epilogue[0], tb.epilogue[1],
                             torch.zeros(16, dtype=torch.int32), None,
                             torch.ones(5), mode="perforated", m=2)
    with pytest.raises(ValueError, match="unsupported device"):
        amk.approx_matmul_cv_fused(torch.empty(3, 32, device="meta"), tb.w_qb,
                                   tb.epilogue, tb.meta, k=32, n=16,
                                   mode="perforated", m=2)
    assert amk.approx_matmul_cv_fused.launches == 0


@pytest.mark.parametrize("mode,m", [("perforated", 2), ("truncated", 5)])
def test_quantized_dense_pallas_dispatch(mode, m):
    """A packed layer without a blocked layout takes the codes-in kernel and
    agrees with the blocked (float-in) path on the same pack."""
    from repro_torch.core.approx_linear import QuantizedDense, pack_dense

    rng = np.random.default_rng(9)
    p = {"w": torch.from_numpy(rng.normal(0, 0.2, (48, 40)).astype(np.float32))}
    qd = pack_dense(p, ApproxPolicy(mode, m, backend="pallas"), (-3.0, 3.0))
    bare = QuantizedDense(qd.pack, qd.a_qp, qd.policy, None)
    x = torch.from_numpy(rng.normal(0, 1, (6, 48)).astype(np.float32))
    np.testing.assert_allclose(
        to_np(tops.quantized_dense_pallas(x, bare)),
        to_np(tops.quantized_dense_pallas(x, qd)), rtol=RTOL,
        atol=_atol(48, float(qd.a_scale), float(qd.w_scale)))
    assert JaxPolicy(mode, m, backend="pallas").to_dict() == \
        dataclasses.asdict(qd.policy)
