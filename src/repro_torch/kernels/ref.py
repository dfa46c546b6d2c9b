"""Plain oracles for every kernel of the port.

Port of ``repro.kernels.ref``: the approx-matmul oracle (elementwise
approximate products summed explicitly), the sequential RWKV6 WKV
recurrence and plain softmax attention — the slowest, most
obviously-correct forms.
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


def rwkv6_scan_ref(r, k, v, w, u, state0):
    """Oracle for kernels.rwkv6_scan: sequential RWKV6 WKV recurrence.

    Shapes (B, T, H, Dk) for r/k/w, (B, T, H, Dv) for v, u: (H, Dk),
    state0: (B, H, Dk, Dv).  Returns (out (B, T, H, Dv), stateT).

        out_t   = r_t^T (diag(u) k_t v_t^T + S_{t-1})
        S_t     = diag(w_t) S_{t-1} + k_t v_t^T
    """
    state = state0
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B, H, Dk, Dv)
        att = state + u[None, :, :, None] * kv
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t, att))
        state = w_t[..., :, None] * state + kv
    return torch.stack(outs, dim=1), state


def flash_attention_ref(q, k, v, *, causal: bool, window: int | None = None,
                        scale: float | None = None):
    """Oracle for kernels.flash_attention: plain softmax attention.

    q: (B, Hq, Tq, D), k/v: (B, Hkv, Tk, D); GQA by head-group broadcast.
    window (if set) = sliding-window size.  A row with no visible key gives
    NaN (softmax over all -inf), as the reference's oracle does.
    """
    b, hq, tq, d = q.shape
    rep = hq // k.shape[1]
    if scale is None:
        scale = d ** -0.5
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    tk = k.shape[2]
    qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    ki = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
