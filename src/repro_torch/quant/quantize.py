"""uint8 asymmetric quantization + approximate quantized linear algebra.

Port of ``repro.quant.quantize`` (gemmlowp scheme, r = S * (q - Z)).  For
y = A @ W + b with activation codes qa (za, sa) and weight codes qw (zw, sw):

    y = sa*sw * [ sum_k AM(qw, qa) + V - zw*sum_k qa - za*sum_k qw + k*za*zw ] + b

Single-CV jnp-backend packs at fan-ins up to 258 also carry the folded
float32 serving operands (:func:`build_fold`, run by
:func:`folded_linear`); grouped-CV packs and deeper fan-ins run the exact
integer path, :func:`quantized_linear`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import control_variate as cv
from repro_torch.core import multipliers as am

QMIN, QMAX = 0, 255


@dataclasses.dataclass(frozen=True)
class QuantParams:
    """Affine quantization parameters (scalars, or per-column vectors)."""

    scale: torch.Tensor  # float32
    zero_point: torch.Tensor  # int32


def calibrate_minmax(lo, hi, device=None) -> QuantParams:
    """Affine parameters covering [lo, hi], forced to include 0."""
    lo = torch.minimum(torch.as_tensor(lo, dtype=torch.float32, device=device),
                       torch.tensor(0.0, device=device))
    hi = torch.maximum(torch.as_tensor(hi, dtype=torch.float32, device=device),
                       torch.tensor(0.0, device=device))
    scale = torch.clamp((hi - lo) / (QMAX - QMIN), min=1e-12)
    zp = torch.clamp(torch.round(QMIN - lo / scale), QMIN, QMAX).to(torch.int32)
    return QuantParams(scale=scale, zero_point=zp)


def calibrate_tensor(x: torch.Tensor) -> QuantParams:
    """Per-tensor min/max calibration."""
    x = x.to(torch.float32)
    return calibrate_minmax(x.min(), x.max(), device=x.device)


def quantize_i32(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Real -> codes in int32.  IEEE division and round-half-to-even, the
    same arithmetic as ``jnp.round(x / scale) + zp`` and as the CUDA
    kernel's in-kernel quantization."""
    q = torch.round(x.to(torch.float32) / qp.scale) + qp.zero_point
    return torch.clamp(q, QMIN, QMAX).to(torch.int32)


def quantize(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """Real -> uint8 codes."""
    return quantize_i32(x, qp).to(torch.uint8)


# ---------------------------------------------------------------------------
# Packed (offline-prepared) approximate linear layers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedLinear:
    """Serving-time parameter pack for one approximate quantized linear.

    w_q (k, n) uint8; w_scale/w_zp per-tensor scalars or (n,) per-column
    vectors (fan-out-fused packs); sum_qw (n,) int32 column sums; c, c0
    (n,) float32 CV constants (grouped CV: c (groups, n)); bias (n,)
    float32 or None.
    """

    w_q: torch.Tensor
    w_scale: torch.Tensor
    w_zp: torch.Tensor
    sum_qw: torch.Tensor
    c: torch.Tensor
    c0: torch.Tensor
    bias: torch.Tensor | None


def pack_linear(w: torch.Tensor, bias: torch.Tensor | None, mode: am.Mode,
                m: int, groups: int = 1) -> PackedLinear:
    """Quantize float weights (k, n) and precompute CV constants offline
    (``groups`` > 1: grouped CV, c of shape (groups, n))."""
    qp = calibrate_tensor(w)
    w_q = quantize(w, qp)
    w_i = w_q.to(torch.int32)
    if groups == 1:
        const = cv.cv_constants(w_i, mode, m, reduce_axis=0)
    else:
        const = cv.cv_constants_grouped(w_i, mode, m, groups, reduce_axis=0)
    return PackedLinear(
        w_q=w_q, w_scale=qp.scale, w_zp=qp.zero_point,
        sum_qw=w_i.sum(dim=0, dtype=torch.int64).to(torch.int32),
        c=const.c, c0=const.c0,
        bias=None if bias is None else bias.to(torch.float32))


def concat_packs(packs: list[PackedLinear]) -> PackedLinear:
    """Fan-out fusion: concatenate sibling packs along the output axis,
    with per-COLUMN weight quant params, so the fused pack computes column
    for column the arithmetic of the separate member calls."""
    has_bias = [p.bias is not None for p in packs]
    if any(has_bias) and not all(has_bias):
        raise ValueError("cannot fuse packs with mixed bias presence")

    def per_col(p, v, dtype):
        n = p.w_q.shape[-1]
        return v.to(dtype).reshape(-1).expand(n) if v.numel() == 1 else v.to(dtype)

    return PackedLinear(
        w_q=torch.cat([p.w_q for p in packs], dim=-1),
        w_scale=torch.cat([per_col(p, p.w_scale, torch.float32) for p in packs]),
        w_zp=torch.cat([per_col(p, p.w_zp, torch.int32) for p in packs]),
        sum_qw=torch.cat([p.sum_qw for p in packs]),
        c=torch.cat([p.c for p in packs], dim=-1),  # grouped: (groups, n)
        c0=torch.cat([p.c0 for p in packs]),
        bias=torch.cat([p.bias for p in packs]) if all(has_bias) else None)


# ---------------------------------------------------------------------------
# Offline-blocked serving layout
# ---------------------------------------------------------------------------

#: tile granularity the offline layout pads to (the reference's values, so
#: the layouts of both packages are byte-equal)
SERVE_BN, SERVE_BK = 128, 512

#: epilogue-table rows: CV constants, zero-point terms, per-column weight
#: quant params, bias; rows padded to 8
EPI_C, EPI_C0, EPI_SUM_QW, EPI_BIAS, EPI_SW, EPI_ZW = range(6)
EPI_ROWS = 8

#: meta-vector slots (per-tensor scalars the fused kernel reads)
META_SA, META_ZA, META_TRUE_K = range(3)
META_LEN = 8


def shrink_block(size: int, block: int, floor: int) -> int:
    """Halve ``block`` toward ``floor`` while the operand is smaller."""
    while block > floor and size < block:
        block //= 2
    return max(block, floor)


def serving_blocks(k: int, n: int) -> tuple[int, int]:
    """(bn, bk) tile sizes the offline layout pads to."""
    return (shrink_block(n, SERVE_BN, 128 if n >= 128 else 8),
            shrink_block(k, SERVE_BK, 128 if k >= 128 else 8))


def k_major(w: torch.Tensor) -> torch.Tensor:
    """(K, N) uint8 codes -> their (N, K16) copy with K contiguous, K16 = K
    rounded up to 16 bytes (zeros past K): the operand layout of the CUDA
    kernels, whose 8-bit tensor-core products read both operands K-major."""
    return F.pad(w.t(), (0, -w.shape[0] % 16)).contiguous()


@dataclasses.dataclass(frozen=True)
class BlockedPack:
    """Offline-blocked serving layout for one (possibly fused) linear.

    w_qbt (rows, ldt) uint8: the codes K-major, :func:`k_major` of the
    (Kb, Nb) codes zero-padded to (bk, bn) multiples, so rows = Nb and ldt
    = Kb rounded up to 16 (a fused group's member holds its n rows of the
    group's w_qbt instead); epilogue (EPI_ROWS, Nb) float32 table; meta (1,
    META_LEN) float32 scalars.  ``k``/``n`` are the true extents.  The CUDA
    kernels read w_qbt and mask the K and N edges themselves, so the
    padding is only a stride to them.  :attr:`w_qb` is the row-major view
    that the plain version reads; it holds no memory of its own.
    """

    w_qbt: torch.Tensor
    epilogue: torch.Tensor
    meta: torch.Tensor
    k: int
    n: int
    bk: int
    bn: int

    @property
    def w_qb(self) -> torch.Tensor:
        """(Kb, rows) row-major codes: a transposed view of w_qbt."""
        return self.w_qbt[:, :-(-self.k // self.bk) * self.bk].t()


def build_blocked_layout(pack: PackedLinear, a_qp: QuantParams,
                         bn: int | None = None,
                         bk: int | None = None) -> BlockedPack:
    """Pad/assemble a pack into the serving layout, once, offline.
    ``sum_qw`` is stored as float32 — exact while 255*k < 2^24."""
    k, n = pack.w_q.shape[-2:]
    if 255 * k >= (1 << 24):
        raise ValueError(f"fan-in {k} overflows f32-exact sum_qw storage")
    if bn is None or bk is None:
        bn_d, bk_d = serving_blocks(k, n)
        bn, bk = bn or bn_d, bk or bk_d
    kb, nb = -(-k // bk) * bk, -(-n // bn) * bn
    dev = pack.w_q.device
    w_qbt = F.pad(pack.w_q.t(), (0, -(-kb // 16) * 16 - k, 0, nb - n))

    def row(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1)
        return F.pad(v.expand(n), (0, nb - n))

    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    epi = torch.stack(
        [row(pack.c), row(pack.c0), row(pack.sum_qw),
         row(pack.bias if pack.bias is not None else zeros),
         row(pack.w_scale), row(pack.w_zp)]
        + [torch.zeros(nb, dtype=torch.float32, device=dev)] * (EPI_ROWS - 6))
    meta = torch.zeros(1, META_LEN, dtype=torch.float32, device=dev)
    meta[0, META_SA] = a_qp.scale.to(torch.float32)
    meta[0, META_ZA] = a_qp.zero_point.to(torch.float32)
    meta[0, META_TRUE_K] = float(k)
    return BlockedPack(w_qbt=w_qbt.contiguous(), epilogue=epi, meta=meta,
                       k=k, n=n, bk=bk, bn=bn)


def _f32_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """True float32 GEMM, the counterpart of the reference's
    ``Precision.HIGHEST`` dot: on the card TF32 would round the operands
    to 10 mantissa bits and move the folded outputs far past float ulps,
    so a TF32 setting is refused rather than used."""
    if a.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "folded serving GEMMs need true float32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (float32 matmul "
            "precision 'highest')")
    return torch.matmul(a, w)


def build_fold(pack: PackedLinear, a_qp: QuantParams, mode: am.Mode, m: int,
               use_cv: bool) -> dict | None:
    """Fold the whole serving epilogue into dense float32 matrices, offline.

    The quantized-linear identity is linear in the activation codes and
    their mode transform, so a layer collapses to

        y = codes @ A  (+ op2 @ B)  + delta

    A carries alpha*W plus the sum_qa coefficient in every column; B the
    mode's subtractive slice (perforated: W, recursive: W mod 2^m,
    truncated: the weight planes) scaled by -alpha, with the CV constant
    C*alpha folded into the same operand; delta every
    activation-independent term (C0, zero-point terms, bias).  Built only
    for single-CV packs at fan-ins up to 258, as the reference builds it;
    returns None otherwise.  The same float32 operations in the same
    order as the reference's, so both packages store the same bytes."""
    k, n = pack.w_q.shape[-2:]
    if pack.c.ndim != pack.sum_qw.ndim:  # grouped CV: no fold
        return None
    if k > am._F32_EXACT_K:
        return None
    dev = pack.w_q.device
    w_f = pack.w_q.to(torch.float32)
    sum_qw = pack.sum_qw.to(torch.float32)

    def col(v):
        """Per-tensor or per-column values aligned to (n,)."""
        v = torch.as_tensor(v, device=dev).to(torch.float32)
        return v if v.ndim == sum_qw.ndim else v[..., None]

    za = col(a_qp.zero_point)
    zw = col(pack.w_zp)
    alpha = col(a_qp.scale) * col(pack.w_scale)
    beta = -(zw * alpha)  # sum_qa coefficient
    delta = (k * za) * zw - za * sum_qw
    has_cv = use_cv and mode != "exact" and m > 0
    if has_cv:
        delta = delta + pack.c0
    delta = delta * alpha
    if pack.bias is not None:
        delta = delta + pack.bias

    def row(v):  # (n,) -> (1, n), broadcast over the k axis
        return v[..., None, :] if v.ndim == sum_qw.ndim else v[..., None]

    fold = {"sa": a_qp.scale.to(torch.float32),
            "za": a_qp.zero_point.to(torch.float32),
            "A": w_f * row(alpha) + row(beta), "delta": delta}
    if mode == "exact" or m == 0:
        return fold
    cv_row = row(pack.c * alpha) if has_cv else None
    if mode in ("perforated", "recursive"):
        w_slice = w_f if mode == "perforated" else am.low_bits(
            pack.w_q, m).to(torch.float32)
        b_mat = -w_slice * row(alpha)
        if has_cv:
            b_mat = b_mat + cv_row
        fold["B"] = b_mat
        return fold
    # truncated: op2 = [bit planes (m*k) | nonzero-low indicator (k, CV only)]
    planes = torch.cat([am.low_bits(pack.w_q, m - i) for i in range(m)],
                       dim=-2).to(torch.float32)
    b_mat = -planes * row(alpha)
    if has_cv:
        b_mat = torch.cat([b_mat, cv_row.expand(w_f.shape)], dim=-2)
    fold["B"] = b_mat
    return fold


def folded_linear(a: torch.Tensor, fold: dict, mode: am.Mode, m: int,
                  use_cv: bool) -> torch.Tensor:
    """Serving path of folded packs: float in -> float32 out.  One
    elementwise pass (quantize and the mode transform, all float32:
    ``codes mod 2^m`` of small integer floats is exact), one or two float32
    GEMMs, one constant add; equal to :func:`quantized_linear` to float
    ulps."""
    codes = torch.clamp(torch.round(a.to(torch.float32) / fold["sa"])
                        + fold["za"], QMIN, QMAX)
    y = _f32_dot(codes, fold["A"])
    if "B" in fold:
        scale = float(1 << m)
        lo = codes - scale * torch.floor(codes / scale)  # codes mod 2^m
        if mode in ("perforated", "recursive"):
            op2 = lo
        else:  # truncated bit planes (bit i scaled by 2^i), peeled bottom-up
            planes = []
            rest = codes
            for i in range(m):
                p2 = float(1 << (i + 1))
                b = rest - p2 * torch.floor(rest / p2)
                planes.append(b)
                rest = rest - b
            if use_cv:
                planes.append((lo != 0).to(torch.float32))
            op2 = torch.cat(planes, dim=-1)
        y = y + _f32_dot(op2, fold["B"])
    return y + fold["delta"]


def quantized_linear(a: torch.Tensor, pack: PackedLinear, a_qp: QuantParams,
                     mode: am.Mode, m: int, use_cv: bool = True,
                     groups: int = 1) -> torch.Tensor:
    """Approximate quantized linear, float in -> float32 out: the exact
    integer reference path (and the grouped-CV path)."""
    k = a.shape[-1]
    a_i = quantize_i32(a, a_qp)
    acc = am.approx_matmul(a_i, pack.w_q, mode, m).to(torch.float32)
    if use_cv and mode != "exact" and m > 0:
        const = cv.CVConstants(pack.c, pack.c0)
        if groups == 1:
            acc = acc + cv.cv_term(a_i, const, mode, m)
        else:
            acc = acc + cv.cv_term_grouped(a_i, const, mode, m, groups)
    sum_qa = a_i.sum(dim=-1, dtype=torch.int64).to(torch.float32)
    zw = pack.w_zp.to(torch.float32)
    za = a_qp.zero_point.to(torch.float32)
    acc = (acc - zw * sum_qa[..., None] - za * pack.sum_qw.to(torch.float32)
           + k * za * zw)
    y = acc * (a_qp.scale * pack.w_scale)
    if pack.bias is not None:
        y = y + pack.bias
    return y
