"""The paper's technique for MoE expert GEMMs: grouped (ragged) approximate
matmuls with PER-EXPERT quantization scales and control-variate constants
(port of ``repro.core.grouped_approx``).

``pack_params`` on a standalone (E, k, n) expert stack gives each expert
its own pack (a :class:`~repro_torch.core.approx_linear.LayerStack` of E
packed modules, no folded operands).  This module runs the expert-sorted
rows against them:

    rows sorted by expert, group_sizes (E,)
    -> the expert id of each row -> its activation scale and zero point
    -> the bit-slice approximate ragged product (exact integer algebra,
       the identities of ``core.multipliers``)
    -> the rank-1 CV correction with the ROW'S OWN expert's (C, C0)
    -> the exact zero-point corrections of that expert

No model path reaches it: inside a model's stacked blocks the expert
leaves are 4-D (L, E, k, n) and stay float, as in the reference (ROADMAP
queue 3).  It is plain PyTorch, as the reference is plain jnp.
"""

from __future__ import annotations

import torch

from repro_torch.core import control_variate as cvlib
from repro_torch.core import multipliers as am
from repro_torch.core.approx_linear import LayerStack


def _row_expert_ids(group_sizes: torch.Tensor, m_rows: int) -> torch.Tensor:
    """group_sizes (E,) -> (M,) expert id of each sorted row."""
    e = group_sizes.shape[0]
    return torch.repeat_interleave(
        torch.arange(e, device=group_sizes.device), group_sizes,
        output_size=m_rows)


def _ragged_int_dot(a: torch.Tensor, w: torch.Tensor,
                    group_sizes: torch.Tensor) -> torch.Tensor:
    """Exact grouped integer matmul: (M, k) x (E, k, n) -> (M, n) int32,
    each expert's rows against its own matrix (float64 holds every
    partial sum exactly, as in ``multipliers._int_matmul``)."""
    out = torch.zeros(a.shape[0], w.shape[-1], dtype=torch.int32,
                      device=a.device)
    lo = 0
    for e, size in enumerate(group_sizes.tolist()):
        if size:
            out[lo:lo + size] = am._int_matmul(a[lo:lo + size], w[e])
        lo += size
    return out


def _approx_ragged(a_i32: torch.Tensor, w_q: torch.Tensor,
                   group_sizes: torch.Tensor, mode: str,
                   m: int) -> torch.Tensor:
    """sum_k AM(w, a) through the bit-slice identities, ragged over the
    experts."""
    if mode == "exact" or m == 0:
        return _ragged_int_dot(a_i32, w_q, group_sizes)
    mask = (1 << m) - 1
    w_i = w_q.to(torch.int32)
    if mode == "perforated":
        return _ragged_int_dot(a_i32 - (a_i32 & mask), w_q, group_sizes)
    if mode == "recursive":
        return (_ragged_int_dot(a_i32, w_q, group_sizes)
                - _ragged_int_dot(a_i32 & mask, w_i & mask, group_sizes))
    if mode == "truncated":
        acc = _ragged_int_dot(a_i32, w_q, group_sizes)
        planes_a = torch.cat([((a_i32 >> i) & 1) << i for i in range(m)],
                             dim=-1)
        planes_w = torch.cat([w_i & ((1 << (m - i)) - 1) for i in range(m)],
                             dim=1)
        return acc - _ragged_int_dot(planes_a, planes_w, group_sizes)
    raise ValueError(mode)


def _stacked(stack: LayerStack, field: str) -> torch.Tensor:
    return torch.stack([getattr(mod, field) for mod in stack.layers])


def grouped_quantized_dense(qd: LayerStack, xs: torch.Tensor,
                            group_sizes: torch.Tensor) -> torch.Tensor:
    """Approximate quantized grouped linear.  xs (M, k) sorted by expert;
    ``qd`` the per-expert packs of an (E, k, n) stack.  Returns (M, n)
    float32."""
    pol = qd[0].policy
    m_rows, k = xs.shape
    ids = _row_expert_ids(group_sizes, m_rows)

    # per-row activation quantization with the row's expert's parameters
    a_scale = _stacked(qd, "a_scale")[ids][:, None]
    a_zp = _stacked(qd, "a_zp")[ids][:, None].to(torch.float32)
    a_q = torch.clamp(torch.round(xs.to(torch.float32) / a_scale) + a_zp,
                      0, 255).to(torch.int32)

    acc = _approx_ragged(a_q, _stacked(qd, "w_q"), group_sizes, pol.mode,
                         pol.m).to(torch.float32)
    if pol.use_cv and pol.mode != "exact" and pol.m > 0:
        sx = cvlib.sum_x(a_q, pol.mode, pol.m, dim=-1).to(torch.float32)
        acc = acc + sx[:, None] * _stacked(qd, "c")[ids] \
            + _stacked(qd, "c0")[ids]

    # exact zero-point corrections (the row's expert's constants)
    sum_qa = a_q.sum(dim=-1, dtype=torch.int32).to(torch.float32)
    zw = _stacked(qd, "w_zp")[ids][:, None].to(torch.float32)
    acc = (acc - zw * sum_qa[:, None]
           - a_zp * _stacked(qd, "sum_qw")[ids].to(torch.float32)
           + k * a_zp * zw)
    y = acc * (a_scale * _stacked(qd, "w_scale")[ids][:, None])
    if qd[0].bias is not None:
        y = y + _stacked(qd, "bias")[ids]
    return y


def grouped_quantized_swiglu(experts: dict, xs: torch.Tensor,
                             group_sizes: torch.Tensor) -> torch.Tensor:
    """swiglu over packed expert stacks: silu(gate(x)) * up(x) -> down."""
    g = grouped_quantized_dense(experts["gate"], xs, group_sizes)
    u = grouped_quantized_dense(experts["up"], xs, group_sizes)
    h = (torch.nn.functional.silu(g) * u).to(xs.dtype)
    return grouped_quantized_dense(experts["down"], h,
                                   group_sizes).to(xs.dtype)
