"""Approximate-multiplier matmul + control-variate epilogue on Hopper.

Two entries of one hand-written CUDA source (``csrc/approx_matmul.cu``):

* :func:`approx_matmul_cv_fused` replaces the TPU kernel
  ``repro/kernels/approx_matmul.py::approx_matmul_cv_fused`` (body
  ``_fused_kernel``): float activations against an offline-blocked pack
  (the K-major uint8 codes ``w_qbt``, an (EPI_ROWS, Nb) epilogue table and
  meta scalars);
* :func:`approx_matmul_cv` replaces ``approx_matmul_cv`` (body ``_kernel``):
  the same arithmetic over pre-quantized codes with per-tensor quant params,
  reading the caller's row-major (K, N) weight codes in place.

The fused entry reads the weights K-major, by one of three routes.
Decode-shaped calls (at most :data:`DECODE_M_MAX` rows) are one CUDA
launch: a split-K
kernel that quantizes x itself, multiplies on ``mma.sync`` and adds the K
slices of a thread-block cluster in the leader's shared memory (bound by
the weight bytes).  Conv-shaped calls (more rows, fan-in at most
:data:`CONV_K_MAX`, width at most :data:`CONV_N_MAX` and K * N at most
:data:`CONV_KN_MAX`: the CNNs' im2col calls) are one launch too:
persistent blocks stream x once through a ring of bulk copies, quantize in
registers, keep the pack in shared memory and multiply on ``mma.sync``
(bound by the bytes of x and out).  Other calls run a prep kernel
(quantize x once, mask the codes, per-row statistics) and then the TMA +
``wgmma`` prefill tile (bound by int8 operations at prefill sizes): two
launches.  The codes-in entry takes the split-K and conv kernels built
over row-major weights (byte transposes in registers or on the way into
shared memory) and, for other calls, the prefill tile's transposing
variant: TMA loads row-major weight boxes, the producer warpgroup
transposes them into the K-major stage that ``wgmma`` reads and takes the
row statistics from the codes (where an operand is off 16 bytes, which TMA
refuses, an ``mma.sync`` rows tile instead): one launch a call at every
shape, no scratch, no copy of the weights.  The design notes are in the
source.  The source is compiled
with ``nvcc`` for ``sm_90a`` into ``build/`` at first use and bound with
``ctypes``.

Each wrapper takes a CPU tensor to its plain PyTorch version
(``*_plain``, the float64-exact integer product of
:mod:`repro_torch.core.multipliers`) and, for a CUDA tensor, launches the
kernel or raises.  ``<wrapper>.launches`` counts the wrapper's calls that
launched on the card.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.core import control_variate as cvlib
from repro_torch.core import multipliers as am
from repro_torch.kernels import nvcc
from repro_torch.quant.quantize import (EPI_BIAS, EPI_C, EPI_C0, EPI_ROWS,
                                        EPI_SUM_QW, EPI_SW, EPI_ZW, META_SA,
                                        META_TRUE_K, META_ZA, QMAX, QMIN)

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "approx_matmul.cu"
BUILD_DIR = nvcc.BUILD_DIR

#: no multiply-add contraction: the float32 epilogue rounds step by step
#: like the reference's separate operations
NVCC_FLAGS = nvcc.BASE_FLAGS + ("-fmad=false",)

#: Row counts at or below this are decode-shaped (engine slot counts): one
#: split-K launch, which quantizes x in each block.  Above it the conv
#: kernel or the prep kernel and the prefill tile.
DECODE_M_MAX = 8

#: Calls above DECODE_M_MAX rows whose fan-in, width and K * N are at most
#: these take the conv kernel (one launch, no scratch); the source's
#: ``CONV_K_MAX``/``CONV_N_MAX``/``CONV_KN_MAX`` hold the same values
CONV_K_MAX, CONV_N_MAX, CONV_KN_MAX = 1152, 128, 36864

#: K-major weight rows are padded to this many bytes (TMA row strides)
K_ALIGN = 16

#: the source's own failure statuses (below cudaError_t's range)
_STATUS = {-1: "cuTensorMapEncodeTiled not found in the driver",
           -2: "the driver refused a TMA tensor map"}

#: largest fan-in whose accumulators stay exact in 32 bits: 255*255*K < 2^31
MAX_K = 33025

_LIB: ctypes.CDLL | None = None


def build_job() -> tuple[pathlib.Path, tuple[str, ...], pathlib.Path]:
    return SOURCE, NVCC_FLAGS, BUILD_DIR


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build_many([build_job()])[0]))
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
        # x, x_bf16, codes, ldq, stats, w_qbt, ldt, wt_rows, epilogue, lde,
        # meta, out, M, K, N, decode, then _mode_args, stream
        lib.am_fused_launch.argtypes = [P, I, P, I, P, P, I, I, P, I, P, P,
                                        I, I, I, I, I, I, U, U, I, I, I, P]
        lib.am_fused_launch.restype = I
        # a_q, w_q, ldw, c, c0, sum_qw, bias, meta, true_k, tile, out, M,
        # K, N, decode, then _mode_args, stream
        lib.am_codes_launch.argtypes = [P, P, I, P, P, P, P, P,
                                        ctypes.c_float, I, P, I, I, I, I, I,
                                        I, U, U, I, I, I, P]
        lib.am_codes_launch.restype = I
        lib.am_tile.argtypes = [I, I, I, I, I, I]
        lib.am_tile.restype = I
        lib.am_launches.argtypes = [P]
        lib.am_launches.restype = None
        _LIB = lib
    return _LIB


#: the matmul kernel instantiations, named in the order of the source's
#: ``TileId`` (``am_tile``): the split-K decode kernel, the wgmma tiles for
#: modes with subtractive planes, then those for one product, then the conv
#: kernel, then the codes-in entry's rows tiles (operands off 16 bytes;
#: planes, then one product) and its transposing wgmma tiles (planes, then
#: one product)
TILES = ("split_k", "128x128 planes", "64x128 planes", "128x256", "128x128",
         "64x128", "conv", "rows_64x128 planes", "rows_64x128",
         "tr_64x128 planes", "tr_128x256", "tr_128x128", "tr_64x128")

#: the tiles each entry can take (the codes-in entry's split-K and conv
#: kernels are their row-major-weight instantiations)
ENTRY_TILES = {"approx_matmul_cv_fused": TILES[:7],
               "approx_matmul_cv": ("split_k", "conv") + TILES[7:]}


def tile(mm: int, k: int, n: int, mode: am.Mode, m: int,
         codes: bool = False) -> str:
    """The matmul kernel that a call of ``mm`` rows against a (k, n) pack
    (``codes``: the codes-in entry's call on 16-byte aligned operands)
    launches, as the source chooses it (needs the built library)."""
    planes = len(decomposition(mode, m)[1])
    return TILES[_lib().am_tile(int(mm <= DECODE_M_MAX), mm, k, n, planes,
                                int(codes))]


#: the CUDA kernels of the source, named as their launches are counted
#: (``LaunchKind`` order) and as a profile shows them
LAUNCH_KINDS = ("prep_kernel", "am_wgmma_kernel", "am_splitk_kernel",
                "am_conv_kernel", "am_rows_kernel")


def kernel_launches() -> dict[str, int]:
    """CUDA launches of each kernel of the source since it was loaded, as
    its launch functions count them (needs the built library): a fused call
    launches one split-K or conv kernel, or the prep kernel and a wgmma
    tile; a codes-in call one split-K, conv or rows kernel."""
    out = (ctypes.c_ulonglong * len(LAUNCH_KINDS))()
    _lib().am_launches(out)
    return dict(zip(LAUNCH_KINDS, map(int, out)))


def decomposition(mode: am.Mode, m: int) -> tuple[int, list[tuple[int, int]]]:
    """The kernel's exact integer form of ``mode``/``m``: ``(main, planes)``
    with  acc = (A & main) . W - sum over planes (A & amask) . (W & wmask).

    perforated: main = ~(2^m - 1), no plane (A_hi . W: one product);
    exact: main = 0xFF, no plane; recursive: main = 0xFF, one plane
    (2^m - 1, 2^m - 1); truncated: main = 0xFF, m planes (1 << i,
    2^(m-i) - 1)."""
    if mode == "exact" or m == 0:
        return 0xFF, []
    low = (1 << m) - 1
    if mode == "perforated":
        return 0xFF & ~low, []
    if mode == "recursive":
        return 0xFF, [(low, low)]
    if mode == "truncated":
        return 0xFF, [(1 << i, (1 << (m - i)) - 1) for i in range(m)]
    raise ValueError(f"unknown mode {mode}")


@functools.lru_cache(maxsize=None)
def _mode_args(mode: am.Mode, m: int, use_cv: bool):
    """(main_mask, n_planes, amasks, wmasks, stat_kind, stat_mask, use_cv)
    for the kernel: :func:`decomposition` with the plane masks packed one
    byte each, and the CV statistic (0 none, 1 low bits, 2 nonzero low
    bits).  The prep kernel applies ``main_mask`` to the codes it writes,
    the split-K kernel to the codes it multiplies."""
    main, planes = decomposition(mode, m)
    amasks = sum(a << (8 * i) for i, (a, _) in enumerate(planes))
    wmasks = sum(w << (8 * i) for i, (_, w) in enumerate(planes))
    cv_on = use_cv and mode != "exact" and m > 0
    stat_kind = 0 if not cv_on else (2 if mode == "truncated" else 1)
    return (main, len(planes), amasks, wmasks, stat_kind,
            (1 << m) - 1 if cv_on else 0, int(cv_on))


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the launch takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _out(shape: tuple[int, int], dtype, device) -> torch.Tensor:
    """A call's output: the only allocation a codes-in call makes."""
    return torch.empty(shape, dtype=dtype, device=device)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _launch_status(name: str, status: int) -> None:
    if status != 0:
        what = _STATUS.get(status, f"CUDA error {status}")
        raise RuntimeError(f"{name}: kernel launch failed: {what}")


def _check_k_major(name: str, w_t: torch.Tensor | None, n: int,
                   k: int) -> None:
    """The kernels' weight operand: (rows >= n, ldt) uint8, K contiguous,
    ldt >= k a multiple of K_ALIGN, 16-byte aligned (TMA reads it).  A
    fused group's member passes its rows of the group's copy: a row slice
    with the group's ldt."""
    if w_t is None:
        raise ValueError(f"{name}: the kernels read the K-major weight codes "
                         "(w_qbt); the call needs the K-major weight copy")
    if w_t.dtype != torch.uint8 or w_t.dim() != 2 or w_t.shape[0] < n \
            or w_t.shape[1] < k or w_t.shape[1] % K_ALIGN \
            or w_t.data_ptr() % 16:
        raise ValueError(f"{name}: K-major weights {w_t.dtype} "
                         f"{tuple(w_t.shape)}, want uint8 (>= {n}, >= {k}, a "
                         f"multiple of {K_ALIGN}), 16-byte aligned")


def _scratch(mm: int, k: int, device) -> tuple[torch.Tensor, int]:
    """The prep kernel's outputs in one allocation, for calls above
    DECODE_M_MAX rows: (M, ldq) uint8 codes, ldq = k rounded up to 16, then
    the (M, 2) int32 row statistics from byte M * ldq (a multiple of 16).
    Returns the buffer and ldq."""
    ldq = -(-k // 16) * 16
    return torch.empty(mm * (ldq + 8), dtype=torch.uint8, device=device), ldq


def _check_scratch(name: str, buf: torch.Tensor, mm: int, ldq: int) -> None:
    """The scratch holds M * ldq code bytes and M * 8 bytes of int32 row
    statistics."""
    if buf.dtype != torch.uint8 or buf.numel() != mm * (ldq + 8) \
            or ldq % 16:
        raise ValueError(f"{name}: scratch {buf.dtype} of {buf.numel()} "
                         f"elements, want uint8 codes ({mm}, {ldq}) and int32 "
                         f"statistics ({mm}, 2): {mm * (ldq + 8)} bytes")


def _takes_prep(mm: int, k: int, n: int) -> bool:
    """Whether a call runs the prep kernel and a wgmma tile: above
    DECODE_M_MAX rows and not conv-shaped (the split-K and conv kernels
    quantize x themselves)."""
    return mm > DECODE_M_MAX and not (k <= CONV_K_MAX and n <= CONV_N_MAX
                                      and k * n <= CONV_KN_MAX)


def _prep_scratch(name: str, mm: int, k: int, n: int, device):
    """(buffer, ldq, address of its codes) of the prep kernel's scratch, or
    (None, 0, 0) for a call that takes none (:func:`_takes_prep`): the
    kernel reads the statistics at codes + M * ldq."""
    if not _takes_prep(mm, k, n):
        return None, 0, 0
    buf, ldq = _scratch(mm, k, device)
    _check_scratch(name, buf, mm, ldq)
    return buf, ldq, buf.data_ptr()


# ---------------------------------------------------------------------------
# Kernel 1: float in, blocked pack, quantized on the card
# ---------------------------------------------------------------------------


def _epilogue(acc: torch.Tensor, sqa: torch.Tensor, sx: torch.Tensor | None,
              c, c0, sum_qw, bias, sa, sw, za, zw, true_k) -> torch.Tensor:
    """The kernels' float32 epilogue, operation for operation in the
    reference kernel's order (``_fused_kernel``/``_kernel``)."""
    out = acc.to(torch.float32)
    if sx is not None:
        out = out + sx.to(torch.float32)[:, None] * c
        out = out + c0
    out = out - zw * sqa.to(torch.float32)[:, None]
    out = out - za * sum_qw
    out = out + true_k * za * zw
    return out * (sa * sw) + bias


def approx_matmul_cv_fused_plain(x: torch.Tensor, w_qbt: torch.Tensor,
                                 epilogue: torch.Tensor, meta: torch.Tensor,
                                 *, k: int, n: int, mode: am.Mode, m: int,
                                 use_cv: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`approx_matmul_cv_fused`.
    x (M, k) float -> (M, n) in x's dtype.  It reads the row-major codes
    as a view of w_qbt (``w_qbt[:n, :k].t()``)."""
    sa, za, true_k = meta[0, META_SA], meta[0, META_ZA], meta[0, META_TRUE_K]
    a = torch.clamp(torch.round(x.to(torch.float32) / sa) + za, QMIN,
                    QMAX).to(torch.int32)
    acc = am.approx_matmul(a, w_qbt[:n, :k].t(), mode, m)
    sqa = a.sum(dim=-1, dtype=torch.int64)
    cv_on = use_cv and mode != "exact" and m > 0
    sx = cvlib.sum_x(a, mode, m) if cv_on else None
    epi = epilogue[:, :n]
    out = _epilogue(acc, sqa, sx, epi[EPI_C], epi[EPI_C0], epi[EPI_SUM_QW],
                    epi[EPI_BIAS], sa, epi[EPI_SW], za, epi[EPI_ZW], true_k)
    return out.to(x.dtype)


def approx_matmul_cv_fused(x: torch.Tensor, w_qbt: torch.Tensor | None,
                           epilogue: torch.Tensor, meta: torch.Tensor, *,
                           k: int, n: int, mode: am.Mode, m: int,
                           use_cv: bool = True) -> torch.Tensor:
    """Fused float -> float approximate matmul over a blocked pack.

    x (M, k) float32/bfloat16; w_qbt (>= n, ldt) uint8, the pack's K-major
    codes (ldt >= k, a multiple of K_ALIGN); epilogue (EPI_ROWS, >= n)
    float32; meta (1, META_LEN) float32.  Returns (M, n) in x's dtype.  On
    the card a call of at most DECODE_M_MAX rows, or a conv-shaped one, is
    one CUDA launch and allocates only its output.
    """
    name = "approx_matmul_cv_fused"
    if x.device.type == "cpu":
        return approx_matmul_cv_fused_plain(x, w_qbt, epilogue, meta, k=k,
                                            n=n, mode=mode, m=m, use_cv=use_cv)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x dtype {x.dtype}")
    _check_k_major(name, w_qbt, n, k)
    if epilogue.dtype != torch.float32 or meta.dtype != torch.float32:
        raise ValueError(f"{name}: operand dtypes")
    mm, kk = x.shape
    if kk != k or epilogue.dim() != 2 or epilogue.shape[0] != EPI_ROWS \
            or epilogue.shape[1] < n:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} epilogue "
                         f"{tuple(epilogue.shape)} k={k} n={n}")
    if k > MAX_K:
        raise ValueError(f"fan-in {k} > {MAX_K} overflows the int32 "
                         "accumulator")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _lib()
    _check_cuda(name, x, w_qbt, epilogue, meta)
    out = torch.empty((mm, n), dtype=x.dtype, device=x.device)
    if mm == 0:
        return out
    decode = mm <= DECODE_M_MAX
    scratch, ldq, codes = _prep_scratch(name, mm, k, n, x.device)
    status = lib.am_fused_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes, ldq,
        codes + mm * ldq, w_qbt.data_ptr(),
        w_qbt.shape[1], w_qbt.shape[0], epilogue.data_ptr(),
        epilogue.shape[1], meta.data_ptr(), out.data_ptr(), mm, k, n,
        int(decode), *_mode_args(mode, m, use_cv), _stream(x))
    _launch_status(name, status)
    approx_matmul_cv_fused.launches += 1
    return out


approx_matmul_cv_fused.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2: pre-quantized codes in, per-tensor quant params
# ---------------------------------------------------------------------------


def approx_matmul_cv_plain(a_q: torch.Tensor, w_q: torch.Tensor,
                           c: torch.Tensor, c0: torch.Tensor,
                           sum_qw: torch.Tensor, bias: torch.Tensor | None,
                           meta: torch.Tensor, *, mode: am.Mode, m: int,
                           true_k: float,
                           use_cv: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`approx_matmul_cv`.  meta is
    [sa, sw, za, zw] float32; returns float32 (M, N)."""
    sa, sw, za, zw = (meta[i] for i in range(4))
    a = a_q.to(torch.int32)
    acc = am.approx_matmul(a, w_q, mode, m)
    sqa = a.sum(dim=-1, dtype=torch.int64)
    cv_on = use_cv and mode != "exact" and m > 0
    sx = cvlib.sum_x(a, mode, m) if cv_on else None
    if bias is None:
        bias = torch.zeros(w_q.shape[1], dtype=torch.float32, device=a.device)
    return _epilogue(acc, sqa, sx, c, c0, sum_qw.to(torch.float32), bias, sa,
                     sw, za, zw, true_k)


def approx_matmul_cv(a_q: torch.Tensor, w_q: torch.Tensor, c: torch.Tensor,
                     c0: torch.Tensor, sum_qw: torch.Tensor,
                     bias: torch.Tensor | None, meta: torch.Tensor, *,
                     mode: am.Mode, m: int, true_k: float,
                     use_cv: bool = True,
                     tile: str | None = None) -> torch.Tensor:
    """Approximate matmul + CV over uint8 codes a_q (M, K) and w_q (K, N),
    both contiguous, with c, c0, bias float32 (N,), sum_qw int32 (N,) and
    meta float32 [sa, sw, za, zw]; ``true_k`` is the fan-in of the epilogue's
    K * za * zw term, passed by value.  Returns float32 (M, N).  On the
    card the kernels read w_q in place, row-major: a call is one launch at
    every shape (split-K at most DECODE_M_MAX rows, the conv kernel at conv
    shapes, else a transposing wgmma tile, or a rows tile where an operand
    is off 16 bytes) and allocates only its output.  ``tile`` names
    another of ENTRY_TILES to launch above the split-K and conv routes
    (``chip_smoke.py`` times both designs with it); the source refuses one
    that does not compute the call."""
    name = "approx_matmul_cv"
    if a_q.device.type == "cpu":
        return approx_matmul_cv_plain(a_q, w_q, c, c0, sum_qw, bias, meta,
                                      mode=mode, m=m, use_cv=use_cv,
                                      true_k=true_k)
    if a_q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a_q.device}")
    lib = _lib()
    ops = [a_q, w_q, c, c0, sum_qw, meta] + ([bias] if bias is not None else [])
    _check_cuda(name, *ops)
    if a_q.dtype != torch.uint8 or w_q.dtype != torch.uint8 \
            or sum_qw.dtype != torch.int32 \
            or meta.numel() < 4 \
            or any(t.dtype != torch.float32
                   for t in (c, c0, meta) + ((bias,) if bias is not None
                                             else ())):
        raise ValueError(f"{name}: operand dtypes")
    mm, kk = a_q.shape
    kk2, nn = w_q.shape
    if kk != kk2 or any(t.shape != (nn,) for t in (c, c0, sum_qw)) \
            or (bias is not None and bias.shape != (nn,)):
        raise ValueError(f"{name}: shapes a {tuple(a_q.shape)} "
                         f"w {tuple(w_q.shape)}")
    if kk > MAX_K:
        raise ValueError(f"fan-in {kk} > {MAX_K} overflows the int32 "
                         "accumulator")
    out = _out((mm, nn), torch.float32, a_q.device)
    if mm == 0:
        return out
    status = lib.am_codes_launch(
        a_q.data_ptr(), w_q.data_ptr(), nn, c.data_ptr(), c0.data_ptr(),
        sum_qw.data_ptr(), bias.data_ptr() if bias is not None else None,
        meta.data_ptr(), float(true_k),
        -1 if tile is None else TILES.index(tile), out.data_ptr(), mm, kk,
        nn, int(mm <= DECODE_M_MAX), *_mode_args(mode, m, use_cv),
        _stream(a_q))
    _launch_status(name, status)
    approx_matmul_cv.launches += 1
    return out


approx_matmul_cv.launches = 0
