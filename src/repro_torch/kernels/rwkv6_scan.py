"""RWKV6 (Finch) WKV recurrence as a chunked scan on Hopper.

:func:`rwkv6_scan` replaces the TPU kernel
``repro/kernels/rwkv6_scan.py::rwkv6_scan`` (body ``_kernel``): per head,
with state S (Dk, Dv) and data-dependent decays w_t,

    out_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

from a zero state, in chunks of L = 32 with the reference's algebra
(cumulative log-decays logD, ``r~ = r exp(logD_{t-1})``,
``k~ = k exp(-logD_t)``, so strong decays share its float32 range limit).
Besides the TPU kernel's ``out`` it returns the final state (B, H, Dk, Dv),
which the TPU kernel keeps in its VMEM scratch and the model's prefill
needs for its decode cache.  T need not divide the chunk: the tail is
padded as :func:`wkv_chunked` pads it (w = 1, r = k = v = 0 leave the
state unchanged).  The hand-written CUDA source is ``csrc/rwkv6_scan.cu``,
compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at first use and bound
with ``ctypes``: a cluster of four blocks per (batch, head)
(:func:`grid_blocks`), each owning 16 key columns and the matching rows of
the state in registers; their partial outputs are added up in a fixed
order, so a call is deterministic.  The chunk products run on the tensor
cores in 3xTF32.

The wrapper takes a CPU tensor to its plain version (:func:`wkv_chunked`
from a zero state) and, for a CUDA tensor, launches the kernel or raises.
``rwkv6_scan.launches`` counts its launches on the card.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import nvcc

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"
BUILD_DIR = nvcc.BUILD_DIR
NVCC_FLAGS = nvcc.BASE_FLAGS
DEFAULT_CHUNK = 32
#: largest key/value head dim the kernel's shared-memory tiles hold
MAX_HEAD_DIM = 64

_LIB: ctypes.CDLL | None = None


def build_job() -> tuple[pathlib.Path, tuple[str, ...], pathlib.Path]:
    return SOURCE, NVCC_FLAGS, BUILD_DIR


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build_many([build_job()])[0]))
        P, I = ctypes.c_void_p, ctypes.c_int
        # r, k, v, w, u, out, state; bf16 flag; B, T, H, Dk, Dv; stream
        lib.rwkv6_launch.argtypes = [P] * 7 + [I] * 6 + [P]
        lib.rwkv6_launch.restype = I
        lib.rwkv6_grid_blocks.argtypes = [I]
        lib.rwkv6_grid_blocks.restype = I
        _LIB = lib
    return _LIB


def grid_blocks(b: int, h: int) -> int:
    """Blocks the kernel launches for ``b`` sequences of ``h`` heads (asks
    the built library, so it needs the CUDA toolkit)."""
    return _lib().rwkv6_grid_blocks(b * h)


def wkv_chunked(r, k, v, w, u, state, chunk: int):
    """Chunked WKV (the TPU kernel's algebra), carrying ``state``.  The
    plain version of :func:`rwkv6_scan` (and of the reference's
    ``repro.nn.rwkv.wkv_chunked``).

    r/k/w: (B, T, H, Dk), v: (B, T, H, Dv), u: (H, Dk),
    state: (B, H, Dk, Dv) float32 -> (out (B, T, H, Dv) float32, new state).
    """
    b, t, h, _ = r.shape
    f32 = torch.float32
    if t % chunk != 0:
        pad = chunk - t % chunk

        def zeros(a):
            return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))

        r, k, v = zeros(r), zeros(k), zeros(v)
        w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    tt = r.shape[1]
    u = u.to(f32)
    ti = torch.arange(chunk, device=r.device)
    lower = ti[:, None] > ti[None, :]
    outs = []
    for c0 in range(0, tt, chunk):
        rc, kc, vc, wc = (a[:, c0:c0 + chunk].to(f32) for a in (r, k, v, w))
        log_d = torch.cumsum(torch.log(wc), dim=1)
        d_full = torch.exp(log_d[:, -1])  # (B, H, Dk)
        rt = rc * torch.exp(torch.cat([torch.zeros_like(log_d[:, :1]),
                                       log_d[:, :-1]], 1))
        kt = kc * torch.exp(-log_d)
        a = torch.einsum("bthd,bshd->bhts", rt, kt)
        a = torch.where(lower, a, torch.zeros((), dtype=f32, device=a.device))
        diag = torch.einsum("bthd,hd,bthd->bth", rc, u, kc)
        out = torch.einsum("bhts,bshd->bthd", a, vc)
        out = out + diag[..., None] * vc
        out = out + torch.einsum("bthk,bhkv->bthv", rt, state)
        state = d_full[..., None] * (
            state + torch.einsum("bshk,bshv->bhkv", kt, vc))
        outs.append(out)
    return torch.cat(outs, dim=1)[:, :t], state


def rwkv6_scan_plain(r, k, v, w, u, *, chunk: int = DEFAULT_CHUNK):
    """Plain PyTorch version of :func:`rwkv6_scan`."""
    b, _, h, dk = r.shape
    state = torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32,
                        device=r.device)
    return wkv_chunked(r, k, v, w, u, state, chunk)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *,
               chunk: int = DEFAULT_CHUNK):
    """Chunked WKV from a zero state: r, k (B, T, H, Dk) and v (B, T, H, Dv)
    float32 or bfloat16, w (B, T, H, Dk) decays in (0, 1), u (H, Dk).
    Returns (out (B, T, H, Dv) float32, state (B, H, Dk, Dv) float32)."""
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    lib = _lib()
    if any(t.device != r.device for t in (k, v, w, u)):
        raise ValueError("rwkv6_scan: operands on different devices")
    if r.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == r.dtype):
        raise ValueError(f"rwkv6_scan: dtypes {r.dtype} {k.dtype} {v.dtype}")
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:3] != (b, t, h) \
            or u.shape != (h, dk):
        raise ValueError(f"rwkv6_scan: shapes r {tuple(r.shape)} v "
                         f"{tuple(v.shape)} w {tuple(w.shape)} u "
                         f"{tuple(u.shape)}")
    if chunk != DEFAULT_CHUNK:
        raise ValueError(f"rwkv6_scan: the kernel walks chunks of "
                         f"{DEFAULT_CHUNK}, not {chunk}")
    if not (1 <= dk <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"rwkv6_scan: head dims ({dk}, {dv}) above "
                         f"{MAX_HEAD_DIM}")
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    w = w.to(torch.float32).contiguous()
    u = u.to(torch.float32).contiguous()
    out = torch.empty((b, t, h, dv), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return out, state
    status = lib.rwkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), state.data_ptr(), int(r.dtype == torch.bfloat16), b,
        t, h, dk, dv, torch.cuda.current_stream(r.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"rwkv6_scan: kernel launch failed with CUDA error "
                           f"{status}")
    rwkv6_scan.launches += 1
    return out, state


rwkv6_scan.launches = 0
