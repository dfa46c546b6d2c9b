"""The port's flash-attention op on the CPU (its plain version) against the
JAX kernel in interpret mode and both packages' oracles, and the arithmetic
of the kernel's two routes (bf16 tensor cores; 3xTF32 for float32) in plain
PyTorch against the JAX kernel.

Tolerance: rtol = atol = 2e-5, the JAX kernel tests' own
(tests/test_kernels.py): every side computes float32 softmax attention,
and only the order of the sums differs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.nn import attention as jattn
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import ref as tref
from repro_torch.nn import attention as tattn

from _torch_port import to_np

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b, hq, hkv, tq, tk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, hq, tq, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, tk, d)).astype(np.float32),
            rng.normal(0, 1, (b, hkv, tk, d)).astype(np.float32))


#: (b, hq, hkv, tq, tk, d, causal, window, jax tile): the JAX kernel tests'
#: cases (tests/test_kernels.py), then ragged lengths no tile divides, then
#: hubert-xlarge's head dim 80 (non-causal as its encoder, and causal) and
#: qwen2-vl-2b's GQA group of 6 (12 query heads over 2)
CASES = [
    (2, 4, 4, 128, 128, 32, True, None, 64),
    (2, 8, 2, 128, 128, 32, True, None, 64),
    (2, 4, 4, 128, 128, 32, False, None, 64),
    (2, 4, 2, 128, 128, 32, True, 64, 64),
    (1, 4, 2, 64, 256, 64, True, None, 64),   # Tq < Tk, rows end-aligned
    (2, 4, 2, 100, 100, 32, True, None, 100),  # ragged T
    (1, 2, 1, 37, 90, 16, True, 20, None),     # ragged Tq < Tk with window
    (2, 4, 4, 128, 128, 80, False, None, 64),
    (2, 4, 2, 128, 128, 80, True, None, 64),
    (1, 4, 4, 100, 100, 80, False, None, 100),  # ragged T at D = 80
    (1, 12, 2, 128, 128, 32, True, None, 64),
]


def _threads() -> str:
    """The thread settings a float32 sum order can depend on: torch's
    intra- and inter-op pools, and XLA's CPU pool (the CPU count unless
    XLA_FLAGS sets it)."""
    return (f"torch threads {torch.get_num_threads()} (inter-op "
            f"{torch.get_num_interop_threads()}); XLA: {os.cpu_count()} CPUs, "
            f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window,tile", CASES)
def test_plain_vs_jax_kernel_and_oracles(b, hq, hkv, tq, tk, d, causal,
                                         window, tile):
    """Three comparisons, each named in its failure message with the
    thread settings: the port's plain flash against the JAX oracle, the
    port's oracle against the JAX oracle, the port's plain flash against
    the JAX kernel in interpret mode."""
    q, k, v = _qkv(tq * 7 + d, b, hq, hkv, tq, tk, d)
    got = to_np(fak.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, window=window))
    assert got.shape == (b, hq, tq, d) and got.dtype == np.float32
    want_r = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    np.testing.assert_allclose(
        got, want_r, **TOL,
        err_msg=f"port plain flash vs JAX oracle; {_threads()}")
    np.testing.assert_allclose(
        to_np(tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, window=window)),
        want_r, **TOL, err_msg=f"port oracle vs JAX oracle; {_threads()}")
    if tile is not None:  # the JAX kernel needs tiles dividing Tq and Tk
        want_k = np.asarray(jax_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window, bq=tile, bk=tile, interpret=True))
        np.testing.assert_allclose(
            got, want_k, **TOL,
            err_msg=f"port plain flash vs JAX interpret-mode kernel; "
            f"{_threads()}")


def test_row_with_no_visible_key_gives_zero():
    """Tq > Tk: the first Tq - Tk rows see no key.  The kernel (as the TPU
    kernel, through its max(l, 1e-30) clamp) gives 0 there; the oracle NaN."""
    q, k, v = _qkv(5, 1, 2, 2, 8, 4, 16)
    got = to_np(fak.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=True))
    want_k = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, bq=8, bk=4,
                                  interpret=True))
    oracle = to_np(tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                            causal=True))
    assert np.all(got[:, :, :4] == 0.0)
    assert np.all(np.isnan(oracle[:, :, :4]))
    np.testing.assert_allclose(got, want_k, **TOL)
    np.testing.assert_allclose(got[:, :, 4:], oracle[:, :, 4:], **TOL)


def test_bfloat16_in_bfloat16_out():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(6, 1, 4, 2, 48, 48, 32))
    got = fak.flash_attention(q, k, v, causal=True)
    want = fak.flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=True)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the float32 result
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("hq,hkv,t,causal", [(4, 4, 24, True), (8, 2, 24, True),
                                             (4, 2, 17, False)])
def test_sdpa_vs_jax(hq, hkv, t, causal):
    """The model's plain prefill attention (B, T, H, d) layout."""
    rng = np.random.default_rng(hq * t)
    q = rng.normal(0, 1, (2, t, hq, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, t, hkv, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, t, hkv, 16)).astype(np.float32)
    got = to_np(tattn._sdpa(*map(torch.from_numpy, (q, k, v)), causal=causal))
    want = np.asarray(jattn._sdpa(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, window=None))
    np.testing.assert_allclose(got, want, **TOL)
    # the kernel's function on the (B, H, T, d) layout is the same one
    flash = to_np(fak.flash_attention(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
        causal=causal)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(flash, want, **TOL)


def test_launch_counter_stays_zero_on_cpu():
    before = fak.flash_attention.launches
    q, k, v = map(torch.from_numpy, _qkv(7, 1, 2, 2, 16, 16, 16))
    fak.flash_attention(q, k, v)
    assert fak.flash_attention.launches == before == 0


class _CudaLike:
    """Stands in for a CUDA tensor on a machine without a card: the
    wrapper reads only its device before it needs the kernel library."""

    def __init__(self, t: torch.Tensor):
        self.device = torch.device("cuda")
        self.dtype, self.shape = t.dtype, t.shape


def test_cuda_call_without_the_library_raises(monkeypatch):
    monkeypatch.setattr(fak, "_LIB", None)
    monkeypatch.setattr(fak, "BUILD_DIR", fak.BUILD_DIR.parent / "no-such-build")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    q = _CudaLike(torch.zeros(1, 2, 8, 16))
    with pytest.raises(RuntimeError, match="nvcc"):
        fak.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        t = torch.empty(1, 2, 8, 16, device="meta")
        fak.flash_attention(t, t, t)
    assert fak.flash_attention.launches == 0


def _tensor_core_route(q, k, v, *, causal, window, bkv=64):
    """The arithmetic of the kernel's bfloat16 route, in plain PyTorch:
    float32 scores of the bf16 q and k over 64-key tiles, scaled by
    scale*log2(e) in float32 and exponentiated base 2 against the running
    max, P rounded to bf16 for P.V, float32 running max, denominator and
    accumulator, rows with no visible key giving 0."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, tq, d)
    kf, vf = k.float(), v.float()
    c = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    qi = torch.arange(tq)[:, None] + (tk - tq)
    m = torch.full((b, hkv, hq // hkv, tq), float("-inf"))
    den = torch.zeros_like(m)
    acc = torch.zeros(b, hkv, hq // hkv, tq, d)
    for k0 in range(0, tk, bkv):
        kt, vt = kf[:, :, k0:k0 + bkv], vf[:, :, k0:k0 + bkv]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * c
        ki = torch.arange(k0, k0 + kt.shape[2])[None, :]
        vis = torch.ones(tq, kt.shape[2], dtype=torch.bool)
        if causal:
            vis = vis & (ki <= qi)
        if window is not None:
            vis = vis & (ki > qi - window)
        s = s.masked_fill(~vis, float("-inf"))
        mnew = torch.maximum(m, s.amax(-1))
        base = torch.where(mnew == float("-inf"), 0.0, mnew)
        p = torch.exp2(s - base[..., None])
        corr = torch.exp2(m - base)
        den = den * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(torch.bfloat16).float(), vt)
        m = mnew
    out = acc / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, tq, d).to(torch.bfloat16)


#: the bfloat16 cases chip_smoke.py runs on the card (GQA, window,
#: non-causal, Tq < Tk) at D = 64, 80 and 128, cut to one batch row
BF16_CASES = [case for d in (64, 80, 128) for case in (
    (1, 8, 2, 128, 128, d, True, None),
    (1, 4, 2, 128, 128, d, True, 64),
    (1, 4, 4, 128, 128, d, False, None),
    (1, 4, 2, 64, 256, d, True, None))]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window", BF16_CASES)
def test_tensor_core_route_arithmetic_vs_jax_kernel(b, hq, hkv, tq, tk, d,
                                                    causal, window):
    """Rounding P to bf16 for P.V (as the kernel's bf16 route and
    FlashAttention do) keeps the result within chip_smoke.py's bf16
    tolerance of the JAX kernel (interpret mode, float32 on the same bf16
    values): |got - want| <= 2^-7 (|want| + max|want|)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(tq + d, b, hq, hkv, tq, tk, d))
    got = _tensor_core_route(q, k, v, causal=causal, window=window)
    want = np.asarray(jax_flash(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), causal=causal,
        window=window, bq=64, bk=64, interpret=True))
    err = np.abs(to_np(got.float()) - want)
    assert np.all(err <= 2.0 ** -7 * (np.abs(want) + np.abs(want).max()))
    # the plain version (the wrapper's CPU route) meets the same bound
    plain = fak.flash_attention(q, k, v, causal=causal, window=window)
    assert plain.dtype == torch.bfloat16
    err_p = np.abs(to_np(plain.float()) - want)
    assert np.all(err_p <= 2.0 ** -7 * (np.abs(want) + np.abs(want).max()))


def _tf32_round(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as the kernel's split does on the bits of a finite float."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_cut(x):
    """x cut to TF32, as the tensor cores read a float32 operand."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _tf32x3(eq, a, b):
    """The kernel's 3xTF32 product: a = hi + lo with hi rounded to TF32 and
    lo the float32 remainder read cut to TF32, a.b = a_lo.b_hi + a_hi.b_lo
    + a_hi.b_hi, each pass summed in float32 (its products are exact)."""
    ah, bh = _tf32_round(a), _tf32_round(b)
    al, bl = _tf32_cut(a - ah), _tf32_cut(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _tf32x3_route(q, k, v, *, causal, window):
    """The arithmetic of the kernel's float32 route, in plain PyTorch: q
    times scale*log2(e) in float32, both products in 3xTF32 over the
    kernel's key tile (64 keys up to D = 64, 32 above), scores
    exponentiated base 2 against the running max, float32 running max,
    denominator and accumulator, rows with no visible key giving 0."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    bkv = 64 if d <= 64 else 32
    c = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    qs = q.reshape(b, hkv, hq // hkv, tq, d) * c
    qi = torch.arange(tq)[:, None] + (tk - tq)
    m = torch.full((b, hkv, hq // hkv, tq), float("-inf"))
    den = torch.zeros_like(m)
    acc = torch.zeros(b, hkv, hq // hkv, tq, d)
    for k0 in range(0, tk, bkv):
        kt, vt = k[:, :, k0:k0 + bkv], v[:, :, k0:k0 + bkv]
        s = _tf32x3("bhgqd,bhkd->bhgqk", qs, kt)
        ki = torch.arange(k0, k0 + kt.shape[2])[None, :]
        vis = torch.ones(tq, kt.shape[2], dtype=torch.bool)
        if causal:
            vis = vis & (ki <= qi)
        if window is not None:
            vis = vis & (ki > qi - window)
        s = s.masked_fill(~vis, float("-inf"))
        mnew = torch.maximum(m, s.amax(-1))
        base = torch.where(mnew == float("-inf"), 0.0, mnew)
        p = torch.exp2(s - base[..., None])
        corr = torch.exp2(m - base)
        den = den * corr + p.sum(-1)
        acc = acc * corr[..., None] + _tf32x3("bhgqk,bhkd->bhgqd", p, vt)
        m = mnew
    out = acc / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, tq, d)


#: float32 cases at every compiled head dim, one batch row, two a dim:
#: GQA, window, non-causal, Tq < Tk, and Tq > Tk with rows that see no key
#: (with a window at D = 64)
F32_CASES = [
    (1, 4, 2, 128, 128, 16, True, 64),
    (1, 4, 2, 64, 32, 16, True, None),
    (1, 4, 4, 128, 128, 32, False, None),
    (1, 4, 2, 64, 256, 32, True, None),
    (1, 8, 2, 128, 128, 64, True, None),
    (1, 4, 2, 128, 64, 64, True, 32),
    (1, 4, 4, 128, 128, 80, False, None),
    (1, 4, 2, 64, 256, 80, True, 64),
    (1, 8, 2, 128, 128, 128, True, None),
    (1, 4, 2, 128, 64, 128, True, None),
]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,window", F32_CASES)
def test_tf32x3_route_arithmetic_vs_jax_kernel(b, hq, hkv, tq, tk, d, causal,
                                               window):
    """The 3xTF32 products of the kernel's float32 route keep the result
    within chip_smoke.py's float32 tolerance of the JAX kernel (interpret
    mode): |got - want| <= 2e-5 (|want| + max|want| of the row); rows with
    no visible key are 0 on both sides."""
    q, k, v = map(torch.from_numpy, _qkv(tq * 3 + d, b, hq, hkv, tq, tk, d))
    got = to_np(_tf32x3_route(q, k, v, causal=causal, window=window))
    want = np.asarray(jax_flash(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal,
        window=window, bq=64, bk=64, interpret=True))
    err = np.abs(got - want)
    bound = 2e-5 * (np.abs(want) + np.abs(want).max(-1, keepdims=True))
    assert np.all(err <= bound), float((err / np.maximum(bound, 1e-30)).max())
    if tq > tk:
        assert np.all(got[:, :, :tq - tk] == 0) and np.all(
            want[:, :, :tq - tk] == 0)
