"""Public wrappers around the approx-matmul kernels.

Port of ``repro.kernels.ops``: arbitrary leading batch dims, the
decode-shaped row window, and the bridge from packed layers
(``QuantizedDense``) to kernel operands.  The CUDA kernels mask their own
K/N edges, so nothing is padded per call.
"""

from __future__ import annotations

import torch

from repro_torch.core.multipliers import Mode
from repro_torch.kernels import approx_matmul as _amk

#: Row counts at or below this are decode-shaped: the kernel wrappers take
#: the split-K kernel, and fan-out groups run their members.
DECODE_M_MAX = _amk.DECODE_M_MAX


def _scalar(v, dev) -> torch.Tensor:
    """A float32 scalar on ``dev``: a tensor already there is converted
    there; a number is filled in by a kernel that takes it by value (no
    copy from the host, no sync)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=dev)


def approx_matmul_cv_op(a_q: torch.Tensor, w_q: torch.Tensor,
                        c: torch.Tensor, c0: torch.Tensor,
                        sum_qw: torch.Tensor, bias: torch.Tensor | None,
                        sa, sw, za, zw, *, mode: Mode, m: int,
                        use_cv: bool = True) -> torch.Tensor:
    """Approx-matmul + CV over codes with arbitrary leading dims -> f32.
    The kernel reads w_q (K, N) in place; meta [sa, sw, za, zw] is built on
    a_q's device from the caller's tensors (a pack's are there already) and
    the fan-in goes by value."""
    lead, kk = a_q.shape[:-1], a_q.shape[-1]
    nn = w_q.shape[-1]
    a2 = a_q.reshape(-1, kk).contiguous()
    dev = a_q.device
    meta = torch.stack([_scalar(v, dev) for v in (sa, sw, za, zw)])
    out = _amk.approx_matmul_cv(
        a2, w_q.contiguous(), c.to(torch.float32).contiguous(),
        c0.to(torch.float32).contiguous(),
        sum_qw.to(torch.int32).contiguous(),
        None if bias is None else bias.to(torch.float32).contiguous(),
        meta, mode=mode, m=m, use_cv=use_cv, true_k=float(kk))
    return out.reshape(*lead, nn)


def quantized_dense_fused_op(x: torch.Tensor, blocked, *, mode: Mode, m: int,
                             use_cv: bool = True) -> torch.Tensor:
    """Serving path: float activations against an offline-blocked pack
    (quantize + matmul + epilogue; one kernel launch at decode rows).
    Returns x.dtype (..., n)."""
    lead, kk = x.shape[:-1], x.shape[-1]
    if kk != blocked.k:
        raise ValueError(f"fan-in {kk} != pack fan-in {blocked.k}")
    x2 = x.reshape(-1, kk).contiguous()
    out = _amk.approx_matmul_cv_fused(
        x2, blocked.w_qbt, blocked.epilogue, blocked.meta, k=blocked.k,
        n=blocked.n, mode=mode, m=m, use_cv=use_cv)
    return out.reshape(*lead, blocked.n)


def quantized_dense_pallas(x: torch.Tensor, qd) -> torch.Tensor:
    """Bridge: a packed layer + float activations -> the kernel.

    Packs carrying the offline-blocked layout take the float-in kernel;
    packs without one quantize here and take the codes-in kernel.  (The
    name keeps the reference's: ``backend: "pallas"`` selects this path.)
    """
    from repro_torch.quant.quantize import quantize

    pol = qd.policy
    if pol.groups != 1:
        # the dispatch (core.approx_linear._packed_forward) sends grouped
        # packs to the plain grouped path, as the reference's does: the
        # kernel's epilogue holds one C a column
        raise ValueError("grouped-CV packs run the plain grouped path, "
                         "not the kernel")
    blocked = qd.blocked  # a property that builds the layout's dataclass
    if blocked is not None:
        return quantized_dense_fused_op(x, blocked, mode=pol.mode, m=pol.m,
                                        use_cv=pol.use_cv)
    pack, a_qp = qd.pack, qd.a_qp
    return approx_matmul_cv_op(
        quantize(x, a_qp), pack.w_q, pack.c, pack.c0, pack.sum_qw, pack.bias,
        a_qp.scale, pack.w_scale, a_qp.zero_point, pack.w_zp, mode=pol.mode,
        m=pol.m, use_cv=pol.use_cv)
