"""Bit-exact models of the paper's approximate multipliers (Sec. 2).

Port of ``repro.core.multipliers``.  Codes are unsigned 8-bit values held
in int32 tensors; products accumulate exactly.  Three families, each with
the knob ``m``:

  perforated  AM_P (Eq. 2):  W * (A - A mod 2^m)
  recursive   AM_R (Eq. 5):  W*A - (W mod 2^m)(A mod 2^m)
  truncated   AM_T (Eq. 7):  W*A - sum_{i<m} (W mod 2^{m-i}) a_i 2^i

Two forms, equal bit for bit: the elementwise scalar definition (oracle)
and the bit-slice matmul algebra.  The exact integer product behind the
matmul form is a float64 ``matmul`` (:func:`_int_matmul`): every partial
sum is at most 255*255*k, below 2^53 for any k the port serves, so the
float64 result is the exact integer on any device.  The error model
(Eqs. 3, 6, 8, the partial-product-matrix oracle, empirical and analytic
moments) backs the paper's Table 1 and the control-variate derivations.
"""

from __future__ import annotations

import functools
from typing import Literal

import numpy as np
import torch

Mode = Literal["perforated", "truncated", "recursive", "exact"]

APPROX_MODES: tuple[str, ...] = ("perforated", "recursive", "truncated")

PAPER_M_RANGE = {
    "perforated": (1, 2, 3),
    "recursive": (2, 3, 4),
    "truncated": (5, 6, 7),
}

NBITS = 8


def _as_i32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def low_bits(x, m: int) -> torch.Tensor:
    """``x mod 2^m`` for non-negative codes."""
    if m <= 0:
        return torch.zeros_like(_as_i32(x))
    return _as_i32(x) & ((1 << m) - 1)


def high_part(x, m: int) -> torch.Tensor:
    """``x - (x mod 2^m)``: the code with its m LSBs zeroed."""
    return _as_i32(x) - low_bits(x, m)


def bit(x, i: int) -> torch.Tensor:
    """Bit i of the code, as int32 in {0, 1}."""
    return (_as_i32(x) >> i) & 1


# -- elementwise (scalar hardware definition) forms -------------------------


def am_exact(w, a) -> torch.Tensor:
    return _as_i32(w) * _as_i32(a)


def am_perforated(w, a, m: int) -> torch.Tensor:
    """AM_P (Eq. 2) with s=0: W * (A - A mod 2^m)."""
    return _as_i32(w) * high_part(a, m)


def am_recursive(w, a, m: int) -> torch.Tensor:
    """AM_R (Eq. 5): prune the W_L x A_L sub-product."""
    return am_exact(w, a) - low_bits(w, m) * low_bits(a, m)


def err_perforated(w, a, m: int) -> torch.Tensor:
    """Eq. 3: eps = W * p,  p = A mod 2^m."""
    return _as_i32(w) * low_bits(a, m)


def err_recursive(w, a, m: int) -> torch.Tensor:
    """Eq. 6: eps = W_L * A_L."""
    return low_bits(w, m) * low_bits(a, m)


def err_truncated(w, a, m: int) -> torch.Tensor:
    """Eq. 8: eps = sum_{i=0}^{m-1} (W mod 2^{m-i}) * a_i * 2^i."""
    w, a = _as_i32(w), _as_i32(a)
    err = torch.zeros(torch.broadcast_shapes(w.shape, a.shape),
                      dtype=torch.int32, device=w.device)
    for i in range(m):
        err = err + low_bits(w, m - i) * bit(a, i) * (1 << i)
    return err


def am_truncated(w, a, m: int) -> torch.Tensor:
    """AM_T (Eq. 7): exact product minus the Eq. 8 error term."""
    return am_exact(w, a) - err_truncated(w, a, m)


def am_truncated_ppmatrix(w, a, m: int) -> torch.Tensor:
    """AM_T from first principles: the sum of the partial-product bits
    w_j & a_i with i + j >= m (the gates with i + j < m are not built).
    O(n^2) bit ops: a test oracle for :func:`am_truncated`."""
    w, a = _as_i32(w), _as_i32(a)
    acc = torch.zeros(torch.broadcast_shapes(w.shape, a.shape),
                      dtype=torch.int32, device=w.device)
    for i in range(NBITS):
        for j in range(NBITS):
            if i + j >= m:
                acc = acc + (bit(w, j) * bit(a, i)) * (1 << (i + j))
    return acc


_ELEMENTWISE = {
    "exact": lambda w, a, m: am_exact(w, a),
    "perforated": am_perforated,
    "recursive": am_recursive,
    "truncated": am_truncated,
}


def _err_exact(w, a, m: int) -> torch.Tensor:
    w, a = _as_i32(w), _as_i32(a)
    return torch.zeros(torch.broadcast_shapes(w.shape, a.shape),
                       dtype=torch.int32, device=w.device)


_ERROR = {
    "exact": _err_exact,
    "perforated": err_perforated,
    "recursive": err_recursive,
    "truncated": err_truncated,
}


def am(w, a, mode: Mode, m: int) -> torch.Tensor:
    """Approximate product of uint8 codes under ``mode``/``m``."""
    return _ELEMENTWISE[mode](w, a, m)


def am_error(w, a, mode: Mode, m: int) -> torch.Tensor:
    """Multiplication error ``w*a - AM(w, a)`` (int32)."""
    return _ERROR[mode](w, a, m)


# -- matmul-algebra forms ----------------------------------------------------

#: Largest contraction depth at which uint8-code products summed in float32
#: stay exact (every partial sum of k products below 2^24): the fan-in
#: limit of the folded serving operands (``quant.quantize.build_fold``).
_F32_EXACT_K = (1 << 24) // (255 * 255)  # 258


def _int_matmul(a, w) -> torch.Tensor:
    """Exact integer matmul (..., k) @ (k, n) -> int32.

    float64 holds every partial sum of uint8-code products exactly
    (255*255*k < 2^53), so the float64 product is the integer result in any
    summation order.  This is the port's counterpart of the reference's
    XLA integer dot; it is plain PyTorch, not a kernel."""
    out = torch.matmul(torch.as_tensor(a).to(torch.float64),
                       torch.as_tensor(w).to(torch.float64))
    return out.to(torch.int32)


def truncated_error_planes(w, m: int) -> torch.Tensor:
    """AM_T's weight error planes, plane[i] = W mod 2^{m-i}: (m, *w.shape)
    int32."""
    w = _as_i32(w)
    if m == 0:
        return torch.zeros((0,) + tuple(w.shape), dtype=torch.int32,
                           device=w.device)
    return torch.stack([low_bits(w, m - i) for i in range(m)])


def approx_matmul_ref(a, w, mode: Mode, m: int) -> torch.Tensor:
    """Oracle: sum of elementwise AM products.  a: (..., k), w: (k, n).
    O(B*K*N) memory — test-scale shapes only."""
    a_e = _as_i32(a)[..., :, None]
    w_e = _as_i32(w)
    prod = am(w_e, a_e, mode, m)
    return prod.sum(dim=-2, dtype=torch.int64).to(torch.int32)


def approx_matmul(a, w, mode: Mode, m: int) -> torch.Tensor:
    """Exact bit-slice matmul form of sum_k AM(w[k, n], a[..., k]).

    perforated: A_hi @ W; recursive: A @ W - A_lo @ W_lo;
    truncated: A @ W - sum_i 2^i bit_i(A) @ (W mod 2^{m-i}); exact: A @ W.
    """
    if mode == "exact" or m == 0:
        return _int_matmul(a, w)
    if mode == "perforated":
        return _int_matmul(high_part(a, m), w)
    if mode == "recursive":
        return _int_matmul(a, w) - _int_matmul(low_bits(a, m), low_bits(w, m))
    if mode == "truncated":
        planes_a = torch.cat([bit(a, i) << i for i in range(m)], dim=-1)
        planes_w = torch.cat([low_bits(w, m - i) for i in range(m)], dim=0)
        return _int_matmul(a, w) - _int_matmul(planes_a, planes_w)
    raise ValueError(f"unknown mode: {mode}")


# -- analytic error moments (Table 1 math) -----------------------------------


def _uniform_code_moments(nbits: int = NBITS) -> tuple[float, float]:
    """Mean and second moment of U{0, ..., 2^nbits - 1}."""
    n = float(2**nbits)
    mean = (n - 1) / 2.0
    second = (n - 1) * (2 * n - 1) / 6.0
    return mean, second


def _mod_moments_uniform(nbits: int, m: int) -> tuple[float, float]:
    """Mean/second moment of (X mod 2^m) for X ~ U{0..2^nbits-1}, m<=nbits."""
    return _uniform_code_moments(m)


def analytic_error_moments_uniform(mode: Mode, m: int) -> tuple[float, float]:
    """(mu, sigma) of the multiplier error for i.i.d. U{0..255} operands:
    the closed forms of Eqs. 3/6/8 (numpy, as the reference computes
    them); the numbers the paper's Table 1 measures empirically."""
    if mode == "exact" or m == 0:
        return 0.0, 0.0
    ew, ew2 = _uniform_code_moments(NBITS)
    if mode == "perforated":
        ep, ep2 = _mod_moments_uniform(NBITS, m)
        mu = ew * ep
        var = ew2 * ep2 - mu * mu
        return mu, float(np.sqrt(var))
    if mode == "recursive":
        el, el2 = _mod_moments_uniform(NBITS, m)
        mu = el * el
        var = el2 * el2 - mu * mu
        return mu, float(np.sqrt(var))
    if mode == "truncated":
        # eps = sum_i (W mod 2^{m-i}) a_i 2^i with a_i ~ Bernoulli(1/2)
        # independent for uniform A; the terms share W, so exhaust W
        w = np.arange(256)
        terms = [((w % (1 << (m - i))) * (1 << i)).astype(np.float64)
                 for i in range(m)]
        mu_w = sum(0.5 * t for t in terms)  # E[eps | W]
        var_w = sum(0.25 * t * t for t in terms)  # Var[eps | W]
        mu = float(mu_w.mean())
        var = float(var_w.mean() + mu_w.var())
        return mu, float(np.sqrt(var))
    raise ValueError(f"unknown mode: {mode}")


def empirical_error_moments(mode: Mode, m: int, w_codes,
                            a_codes) -> tuple[float, float]:
    """Empirical (mu, sigma) of the error over the given code samples, in
    float64 on the samples' device (population sigma, as numpy's ``std``;
    torch's reduction order differs from numpy's, so the two agree to
    float64 ulps, not bit for bit)."""
    err = am_error(w_codes, a_codes, mode, m).to(torch.float64)
    return float(err.mean()), float(err.std(correction=0))


@functools.lru_cache(maxsize=None)
def error_mean_per_weight_uniform_a(mode: Mode, m: int) -> np.ndarray:
    """E_A[eps | W = w] for all 256 codes w, A ~ U{0..255} (numpy): Eq. 23
    for truncated, W * E[A mod 2^m] for perforated, (W mod 2^m) * E[A_L]
    for recursive."""
    w = np.arange(256, dtype=np.float64)
    if mode == "exact" or m == 0:
        return np.zeros(256)
    if mode == "perforated":
        return w * ((1 << m) - 1) / 2.0
    if mode == "recursive":
        return (np.arange(256) % (1 << m)) * ((1 << m) - 1) / 2.0
    if mode == "truncated":
        acc = np.zeros(256)
        for i in range(m):
            acc += (np.arange(256) % (1 << (m - i))) * (1 << i)
        return acc / 2.0  # E[a_i] = 1/2
    raise ValueError(f"unknown mode: {mode}")
