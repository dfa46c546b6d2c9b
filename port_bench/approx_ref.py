"""Frozen plain arithmetic of the approximate MAC array, for the
references: uint8 affine quantization (gemmlowp, r = S (q - Z)), the
paper's three approximate multipliers and the control variate (CV), in
plain PyTorch.  It imports nothing of the program.

For y = x W + b with activation codes a (scale sa, zero point za) and
weight codes w (sw, zw) over fan-in K:

    y = sa sw [ sum_k AM(w, a) + V - zw sum_k a - za sum_k w + K za zw ] + b

    perforated  AM = w (a - a mod 2^m)          V = C sum(a mod 2^m),  C = E_k[w]
    recursive   AM = w a - (w mod 2^m)(a mod 2^m)
                                                V = C sum(a mod 2^m),  C = E_k[w mod 2^m]
    truncated   AM = w a - sum_{i<m} (w mod 2^(m-i)) a_i 2^i
                                                V = C sum[a mod 2^m != 0] + C0,
                                                C = E_k[w^], C0 = 2^-m sum_k w^,
                                                w^ = 1/2 sum_{i<m} (w mod 2^(m-i)) 2^i

Codes are held as small integers in floating point; integer sums are
taken in float64, which holds them exactly (255 * 255 * K < 2^53), and
the rest in float32, one rounding an operation, in the formula's order
(acc, + V, - zw sum a, - za sum w, + K za zw, times sa sw, + b).
"""

from __future__ import annotations

import dataclasses

import torch

QMAX = 255.0


def qparams(lo, hi, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero point) as float32 covering [lo, hi], forced to hold 0;
    float32 operations on ``device``, the one the layer runs on (a card
    may take the division by 255 as a product with its reciprocal, one
    unit in the last place away from the quotient)."""
    lo = torch.clamp(torch.as_tensor(lo, dtype=torch.float32, device=device),
                     max=0.0)
    hi = torch.clamp(torch.as_tensor(hi, dtype=torch.float32, device=device),
                     min=0.0)
    scale = torch.clamp((hi - lo) / QMAX, min=1e-12)
    zp = torch.clamp(torch.round(-lo / scale), 0.0, QMAX)
    return scale, zp


def quantize(x: torch.Tensor, scale, zp) -> torch.Tensor:
    """float -> codes 0..255 (float32), round half to even.  The scale is
    moved to x's device first: a division by a host scalar may be taken
    as a product with its reciprocal, which is not the IEEE quotient."""
    scale = torch.as_tensor(scale, device=x.device)
    return torch.clamp(torch.round(x.to(torch.float32) / scale) + zp,
                       0.0, QMAX)


def low(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """codes mod 2^bits, for non-negative integer-valued floats."""
    p = float(1 << bits)
    return codes - p * torch.floor(codes / p)


@dataclasses.dataclass
class Weights:
    """One linear layer quantized per tensor, with its CV constants."""

    w: torch.Tensor  # (K, N) codes, float64
    scale: torch.Tensor
    zp: torch.Tensor
    c: torch.Tensor  # (N,) float32
    c0: torch.Tensor  # (N,) float32
    sum_w: torch.Tensor  # (N,) float32, exact
    bias: torch.Tensor | None


def pack(w: torch.Tensor, bias: torch.Tensor | None, mode: str, m: int
         ) -> Weights:
    """Quantize float weights (K, N) and work out the CV constants: the
    code sums in float32 (exact below 2^24) times the float32 reciprocal
    of the fan-in."""
    scale, zp = qparams(w.min(), w.max())
    q = quantize(w, scale, zp)
    if mode == "perforated":
        stat = q
    elif mode == "recursive":
        stat = low(q, m)
    elif mode == "truncated":
        stat = sum(low(q, m - i) * float(1 << i) for i in range(m)) / 2.0
    else:
        raise ValueError(f"unknown mode {mode!r}")
    inv_k = torch.tensor(1.0, device=w.device) / w.shape[0]
    total = stat.sum(dim=0)
    c = total * inv_k
    c0 = total / float(1 << m) if mode == "truncated" else torch.zeros_like(c)
    return Weights(q.to(torch.float64), scale, zp, c, c0, q.sum(dim=0),
                   None if bias is None else bias.to(torch.float32))


def linear(x: torch.Tensor, wt: Weights, a_scale, a_zp, mode: str, m: int,
           use_cv: bool) -> torch.Tensor:
    """The approximate quantized product of x (..., K) -> float32 (..., N).
    The integer sums are exact; the float32 epilogue takes its terms one
    rounding at a time in the order of the formula above."""
    a = quantize(x, a_scale, a_zp).to(torch.float64)
    lead, k = a.shape[:-1], a.shape[-1]
    a = a.reshape(-1, k)
    w = wt.w
    if mode == "perforated":
        acc = (a - low(a, m)) @ w
        xs = low(a, m)
    elif mode == "recursive":
        acc = a @ w - low(a, m) @ low(w, m)
        xs = low(a, m)
    else:  # truncated
        acc = a @ w
        rest = a
        for i in range(m):
            bit = low(rest, i + 1)
            rest = rest - bit
            acc = acc - bit @ low(w, m - i)
        xs = (low(a, m) != 0).to(torch.float64)
    f32 = torch.float32
    out = acc.to(f32)
    if use_cv:
        out = out + xs.sum(-1, keepdim=True).to(f32) * wt.c
        out = out + wt.c0
    za, zw = a_zp.to(f32), wt.zp.to(f32)
    out = out - zw * a.sum(-1, keepdim=True).to(f32)
    out = out - za * wt.sum_w
    out = out + torch.tensor(float(k), device=out.device) * za * zw
    out = out * (a_scale.to(f32) * wt.scale.to(f32))
    if wt.bias is not None:
        out = out + wt.bias
    return out.reshape(*lead, -1)
