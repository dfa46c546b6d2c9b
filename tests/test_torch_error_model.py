"""The port's error model (``repro_torch.core.multipliers``: Eqs. 3, 6, 8,
the partial-product-matrix oracle, ``am_error``, the truncated error
planes, empirical and per-weight error moments) and the control variate's
reference composition and analytic predictions
(``repro_torch.core.control_variate``: ``approx_matmul_cv``, Eqs. 12, 20,
22, 28) against the JAX package's, on seeded numpy codes over every mode
and m.

Tolerances.  Integer results are bit-equal.  Float64 moments: rtol 1e-12
(numpy and the reference's jnp reduce in their own orders; the integer
error sums behind them are exact, so the gap is float64 ulps).  Single-CV
``approx_matmul_cv`` is bit-equal (the same float32 operations in the same
order); grouped CV's rank-g float32 contraction is summed in another order
by torch's matmul: 1e-6 of the output's scale.
"""

import numpy as np
import pytest
import torch

from repro.core import control_variate as jcv
from repro.core import multipliers as jam
from repro_torch.core import control_variate as tcv
from repro_torch.core import multipliers as tam

MODES = ["exact", "perforated", "recursive", "truncated"]
#: every mode at every m the paper and Table 1 use, and m = 0 and 8
POINTS = [(mode, m) for mode in MODES for m in range(9)
          if mode != "exact" or m == 0]
MOMENT_RTOL = 1e-12
GROUPED_RTOL = 1e-6


def _codes(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,m", POINTS)
def test_error_functions_bit_equal(mode, m):
    w, a = _codes(1, 64, 1), _codes(2, 1, 300)  # broadcast to (64, 300)
    _eq(tam.am_error(w, a, mode, m), jam.am_error(w, a, mode, m))
    _eq(tam.am(w, a, mode, m) + tam.am_error(w, a, mode, m),
        np.asarray(w * a, np.int32))
    for name in ("err_perforated", "err_recursive", "err_truncated"):
        _eq(getattr(tam, name)(w, a, m), getattr(jam, name)(w, a, m))
    _eq(tam.truncated_error_planes(w, m), jam.truncated_error_planes(w, m))
    _eq(tam.am_truncated_ppmatrix(w, a, m),
        jam.am_truncated_ppmatrix(w, a, m))


@pytest.mark.parametrize("m", range(9))
def test_ppmatrix_equals_truncated_over_the_code_grid(m):
    w = np.arange(256)[:, None]
    a = np.arange(256)[None, :]
    got = tam.am_truncated_ppmatrix(w, a, m)
    assert tuple(got.shape) == (256, 256)
    assert torch.equal(got, tam.am_truncated(w, a, m))


@pytest.mark.parametrize("dist", ["uniform", "normal"])
@pytest.mark.parametrize("mode,m", POINTS)
def test_empirical_moments_vs_jax(mode, m, dist):
    rng = np.random.default_rng(3)
    if dist == "uniform":
        w, a = rng.integers(0, 256, 20_000), rng.integers(0, 256, 20_000)
    else:
        w, a = (np.clip(np.round(rng.normal(125, 24, 20_000)), 0, 255)
                .astype(np.int64) for _ in range(2))
    got = tam.empirical_error_moments(mode, m, torch.from_numpy(w),
                                      torch.from_numpy(a))
    want = jam.empirical_error_moments(mode, m, w, a)
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=MOMENT_RTOL, atol=0)
    # the integer sums behind them are exact
    err = tam.am_error(w, a, mode, m).to(torch.int64)
    jerr = np.asarray(jam.am_error(w, a, mode, m)).astype(np.int64)
    assert int(err.sum()) == int(jerr.sum())
    assert int((err * err).sum()) == int((jerr * jerr).sum())


@pytest.mark.parametrize("mode,m", POINTS)
def test_per_weight_error_mean_equal(mode, m):
    got = tam.error_mean_per_weight_uniform_a(mode, m)
    want = jam.error_mean_per_weight_uniform_a(mode, m)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert tam.error_mean_per_weight_uniform_a(mode, m) is got  # cached
    # and it is the mean of the exact error over all 256 activation codes
    err = tam.am_error(np.arange(256)[:, None], np.arange(256)[None, :],
                       mode, m).to(torch.float64).mean(1)
    np.testing.assert_allclose(err.numpy(), got, rtol=0, atol=1e-9)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("mode,m", POINTS)
def test_approx_matmul_cv_vs_jax(mode, m, groups):
    a, w = _codes(4, 3, 5, 32), _codes(5, 32, 6)
    got = tcv.approx_matmul_cv(a, w, mode, m, groups=groups)
    want = np.asarray(jcv.approx_matmul_cv(a, w, mode, m, groups=groups))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if groups == 1 or mode == "exact" or m == 0:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GROUPED_RTOL * np.abs(want).max())
    # given constants are used as given
    const = tcv.cv_constants(w, mode, m)
    if groups == 1:
        assert torch.equal(tcv.approx_matmul_cv(a, w, mode, m, const=const),
                           got)


@pytest.mark.parametrize("k", [1, 64, 256])
@pytest.mark.parametrize("mode,m", POINTS)
def test_analytic_predictions_equal(mode, m, k):
    assert tcv.predicted_conv_error_no_cv_uniform(mode, m, k) == \
        jcv.predicted_conv_error_no_cv_uniform(mode, m, k)
    w = _codes(6, k)
    assert tcv.predicted_mean_with_cv(w, mode, m) == \
        jcv.predicted_mean_with_cv(w, mode, m) == 0.0
    if mode == "perforated":
        want = jcv.predicted_var_with_cv_perforated(w, m)
        assert tcv.predicted_var_with_cv_perforated(w, m) == want
        assert tcv.predicted_var_with_cv_perforated(torch.from_numpy(w),
                                                    m) == want
    if mode == "recursive":
        want = jcv.predicted_var_with_cv_recursive(w, m)
        assert tcv.predicted_var_with_cv_recursive(w, m) == want
        assert tcv.predicted_var_with_cv_recursive(torch.from_numpy(w),
                                                   m) == want
