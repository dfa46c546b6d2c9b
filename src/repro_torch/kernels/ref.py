"""Scalar-definition oracle for the approx-matmul kernels.

Port of ``repro.kernels.ref.approx_matmul_cv_ref``: elementwise approximate
products summed explicitly — the slowest, most obviously-correct form.
"""

from __future__ import annotations

import torch

from repro_torch.core import control_variate as cvlib
from repro_torch.core import multipliers as am
from repro_torch.core.multipliers import Mode


def approx_matmul_cv_ref(a_q, w_q, c, c0, sum_qw, bias, sa, sw, za, zw, *,
                         mode: Mode, m: int, use_cv: bool = True) -> torch.Tensor:
    """a_q (M, K) uint8 codes, w_q (K, N) uint8 codes -> float32 (M, N).
    O(M*K*N) memory — test shapes only."""
    a_i = torch.as_tensor(a_q).to(torch.int32)
    w_i = torch.as_tensor(w_q).to(torch.int32)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)  # noqa: E731
    kk = a_i.shape[-1]
    acc = am.approx_matmul_ref(a_i, w_i, mode, m).to(torch.float32)
    if use_cv and mode != "exact" and m > 0:
        sumx = cvlib.sum_x(a_i, mode, m).to(torch.float32)
        acc = acc + sumx[:, None] * f32(c)[None, :]
        acc = acc + f32(c0)[None, :]
    sum_qa = a_i.sum(dim=-1, dtype=torch.int64).to(torch.float32)
    acc = acc - f32(zw) * sum_qa[:, None]
    acc = acc - f32(za) * f32(sum_qw)[None, :]
    acc = acc + f32(kk) * f32(za) * f32(zw)
    return acc * (f32(sa) * f32(sw)) + f32(bias)[None, :]
