"""Control-variate approximation (the paper's Sec. 3), single-C form.

Port of ``repro.core.control_variate``:

    G* = B + sum_j AM(W_j, A_j) + V,      V = C * sum_j x_j + C0

  perforated:  x_j = A_j mod 2^m,     C = E_j[W_j],           C0 = 0
  truncated :  x_j = OR(A_j[m-1:0]),  C = E_j[W_hat_j],       C0 = 2^-m sum_j W_hat_j
  recursive :  x_j = A_j mod 2^m,     C = E_j[W_j mod 2^m],   C0 = 0

C and C0 are per-output-channel constants from the weight codes; the
runtime statistic is the per-row sum_j x_j.  Grouped CV (beyond the
paper) keeps one C per contiguous slice of the fan-in axis.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import multipliers as am

Mode = am.Mode


def x_stat(a_codes, mode: Mode, m: int) -> torch.Tensor:
    """The control-variate input statistic x_j per activation code (int32)."""
    a = am._as_i32(a_codes)
    if mode == "exact" or m == 0:
        return torch.zeros_like(a)
    if mode in ("perforated", "recursive"):
        return am.low_bits(a, m)
    if mode == "truncated":
        return (am.low_bits(a, m) != 0).to(torch.int32)
    raise ValueError(f"unknown mode: {mode}")


def sum_x(a_codes, mode: Mode, m: int, dim: int = -1) -> torch.Tensor:
    """sum_j x_j along the reduction axis — the MAC+ column's running sum."""
    return x_stat(a_codes, mode, m).sum(dim=dim, dtype=torch.int64).to(
        torch.int32)


def w_hat(w_codes, m: int) -> torch.Tensor:
    """Eq. 24: W_hat = 1/2 sum_{i<m} (W mod 2^{m-i}) * 2^i, as float32."""
    w = am._as_i32(w_codes)
    acc = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for i in range(m):
        acc = acc + (am.low_bits(w, m - i) << i).to(torch.float32)
    return acc / 2.0


@dataclasses.dataclass(frozen=True)
class CVConstants:
    """Offline control-variate constants for one linear layer:
    c, c0 of shape (n_out,) float32."""

    c: torch.Tensor
    c0: torch.Tensor


def cv_constants(w_codes, mode: Mode, m: int, reduce_axis: int = 0) -> CVConstants:
    """(C, C0) from the weight codes of a (k, n) linear layer.

    The sums are integers (or halves, for W_hat) below 2^24, so float32
    holds them exactly in any order; the mean then multiplies by the
    float32 reciprocal of the fan-in, as the reference's compiled
    ``jnp.mean`` does, so both packages store the same bytes."""
    w = am._as_i32(w_codes)
    if mode == "exact" or m == 0:
        shape = [d for i, d in enumerate(w.shape) if i != reduce_axis % w.ndim]
        z = torch.zeros(shape, dtype=torch.float32, device=w.device)
        return CVConstants(c=z, c0=z)
    inv_k = torch.tensor(1.0, device=w.device) / w.shape[reduce_axis]
    if mode == "perforated":
        c = w.to(torch.float32).sum(dim=reduce_axis) * inv_k
        return CVConstants(c=c, c0=torch.zeros_like(c))
    if mode == "recursive":
        c = am.low_bits(w, m).to(torch.float32).sum(dim=reduce_axis) * inv_k
        return CVConstants(c=c, c0=torch.zeros_like(c))
    if mode == "truncated":
        wh = w_hat(w, m)
        c = wh.sum(dim=reduce_axis) * inv_k
        c0 = wh.sum(dim=reduce_axis) / float(1 << m)
        return CVConstants(c=c, c0=c0)
    raise ValueError(f"unknown mode: {mode}")


def cv_constants_grouped(w_codes, mode: Mode, m: int, groups: int,
                         reduce_axis: int = 0) -> CVConstants:
    """Grouped CV (beyond the paper): per-group C over ``groups``
    contiguous slices of the fan-in axis, c of shape (groups, n_out); c0
    over the full axis, as in the single-C form."""
    w = am._as_i32(w_codes).movedim(reduce_axis, 0)
    k = w.shape[0]
    if k % groups != 0:
        raise ValueError(f"fan-in {k} not divisible by groups {groups}")
    wg = w.reshape(groups, k // groups, *w.shape[1:])
    per_group = cv_constants(wg, mode, m, reduce_axis=1)
    full = cv_constants(w, mode, m, reduce_axis=0)
    return CVConstants(c=per_group.c, c0=full.c0)


def cv_term(a_codes, const: CVConstants, mode: Mode, m: int) -> torch.Tensor:
    """V = C * sum_j x_j + C0 for a batch of activation rows -> float32."""
    sx = sum_x(a_codes, mode, m, dim=-1).to(torch.float32)
    return sx[..., None] * const.c + const.c0


def cv_term_grouped(a_codes, const: CVConstants, mode: Mode, m: int,
                    groups: int) -> torch.Tensor:
    """Grouped V = sum_g C_g * sum_{j in g} x_j + C0 -> float32 (a
    rank-``groups`` float32 contraction, like the reference's
    ``dot_general``: equal to it to float32 rounding)."""
    a = am._as_i32(a_codes)
    k = a.shape[-1]
    ag = a.reshape(*a.shape[:-1], groups, k // groups)
    sx = sum_x(ag, mode, m, dim=-1).to(torch.float32)  # (..., groups)
    return torch.matmul(sx, const.c) + const.c0
