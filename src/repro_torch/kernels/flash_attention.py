"""Blocked online-softmax attention (flash) on Hopper.

:func:`flash_attention` replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (body ``_kernel``):
forward attention over q (B, Hq, Tq, D) and k/v (B, Hkv, Tk, D), causal
and/or sliding-window masks, GQA through a head map (no K/V repeat), query
rows aligned to the END of the key axis (Tq <= Tk), a float32 running max,
denominator and accumulator, key tiles that the mask hides entirely
skipped, output in q's dtype.  The hand-written CUDA source is
``csrc/flash_attention.cu``, compiled with ``nvcc`` for ``sm_90a`` into
``build/`` at first use and bound with ``ctypes``.  bfloat16 inputs (every
serving path) run both products on the bf16 tensor cores (``mma.sync``
m16n8k16, float32 sums, P rounded to bf16 for P.V as FlashAttention does);
float32 inputs run both on the TF32 tensor cores in 3xTF32 (``mma.sync``
m16n8k8: each operand split into its TF32 rounding and the float32
remainder, three passes), which keeps the result within float32 sums'
tolerance of the float32 reference.

Unlike the TPU wrapper, Tq and Tk need not divide a tile: the kernel masks
the ragged edges.  A query row with no visible key (possible with a window,
or with Tq > Tk) gives 0, as the TPU kernel does through its
``max(l, 1e-30)`` clamp; the oracle ``ref.flash_attention_ref`` gives NaN
there.

The wrapper takes a CPU tensor to :func:`flash_attention_plain` and, for a
CUDA tensor, launches the kernel or raises.  ``flash_attention.launches``
counts its launches on the card.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BUILD_DIR = nvcc.BUILD_DIR
NVCC_FLAGS = nvcc.BASE_FLAGS
#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 80, 128)

_LIB: ctypes.CDLL | None = None


def build_job() -> tuple[pathlib.Path, tuple[str, ...], pathlib.Path]:
    return SOURCE, NVCC_FLAGS, BUILD_DIR


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build_many([build_job()])[0]))
        P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        # q, k, v, out pointers; dtype; B, Hq, Hkv, Tq, Tk, D; causal,
        # window; scale; (b, h, t) element strides of q, k, v, out; stream
        lib.fa_launch.argtypes = ([P, P, P, P, I, I, I, I, I, I, I, I, I, F]
                                  + [L] * 12 + [P])
        lib.fa_launch.restype = I
        _LIB = lib
    return _LIB


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: masked softmax in
    float32 over the whole key axis; rows with no visible key give 0."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.to(torch.float32).reshape(b, hkv, hq // hkv, tq, d) * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(torch.float32))
    qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    ki = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)  # finite on empty rows
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p / den, v.to(torch.float32))
    return out.reshape(b, hq, tq, d).to(q.dtype)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads rows of D contiguous elements with 16-byte loads:
    a view that keeps them (e.g. a (B, T, H, D) tensor transposed to
    (B, H, T, D)) is passed as it is, anything else is made contiguous."""
    es = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            (st * es) % 16 for st in t.stride()[:3]):
        t = t.contiguous()
    return t


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Flash attention: q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D), float32 or
    bfloat16 -> (B, Hq, Tq, D) in q's dtype.  ``window`` (if set) keeps the
    keys j with q_pos - window < j; ``scale`` defaults to D**-0.5.

    On the card the result is a view of a (B, Tq, Hq, D) buffer, so that the
    model's (B, T, H*D) output projection reads it without a copy.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    lib = _lib()
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: operands on different devices")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"flash_attention: dtypes {q.dtype} {k.dtype} "
                         f"{v.dtype}")
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or hq % hkv != 0:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    q, k, v = _operand(q), _operand(k), _operand(v)
    out = torch.empty((b, tq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out.transpose(1, 2)
    ot = out.transpose(1, 2)
    strides = [s for t in (q, k, v, ot) for s in t.stride()[:3]]
    status = lib.fa_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, hq, hkv, tq, tk, d, int(causal),
        0 if window is None else int(window),
        float(d ** -0.5 if scale is None else scale), *strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {status}")
    flash_attention.launches += 1
    return ot


flash_attention.launches = 0
