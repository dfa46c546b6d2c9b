"""The port's RWKV6 scan op on the CPU (its plain version, the chunked WKV
algebra) against the JAX kernel in interpret mode, both packages' sequential
oracles, and the reference's ``nn.rwkv.wkv_chunked`` (out and final state).

Tolerance: rtol = 2e-4, atol = 5e-4, the JAX kernel tests' own
(tests/test_kernels.py): the chunked form divides by cumulative decays
(k / D_s) and multiplies back, so it loses a few float32 digits against the
sequential recurrence.  Chunked against chunked (the reference's
``wkv_chunked``) is held to 1e-4: the same algebra, its sums in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_scan
from repro.nn import rwkv as jrwkv
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as rsk

from _torch_port import to_np

TOL = dict(rtol=2e-4, atol=5e-4)


def _case(seed, b, t, h, dk, dv, decay=None):
    """The JAX kernel tests' distribution: decays in [e^-8, 0.9999], or
    every decay equal to ``decay``."""
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 1, (b, t, h, dk)).astype(np.float32)
    k = rng.normal(0, 1, (b, t, h, dk)).astype(np.float32)
    v = rng.normal(0, 1, (b, t, h, dv)).astype(np.float32)
    w = np.clip(np.exp(-np.exp(rng.normal(-1, 1.5, (b, t, h, dk)))),
                np.exp(-8.0), 0.9999).astype(np.float32)
    if decay is not None:
        w = np.full_like(w, decay)
    u = rng.normal(0, 0.5, (h, dk)).astype(np.float32)
    return r, k, v, w, u


def _jax_kernel(r, k, v, w, u, chunk=32):
    """The JAX kernel on whole chunks: T padded as ``wkv_chunked`` pads it
    (w = 1, r = k = v = 0), the padded steps dropped."""
    t = r.shape[1]
    pad = ((0, 0), (0, -t % chunk), (0, 0), (0, 0))
    out = jax_scan(*(np.pad(a, pad) for a in (r, k, v)),
                   np.pad(w, pad, constant_values=1.0), u, chunk=chunk,
                   interpret=True)
    return np.asarray(out)[:, :t]


@pytest.mark.parametrize("t,dk,dv", [(64, 64, 64), (96, 32, 32)])
def test_plain_vs_jax_kernel_and_oracles(t, dk, dv):
    b, h = 2, 2
    r, k, v, w, u = _case(t + dk, b, t, h, dk, dv)
    out, state = rsk.rwkv6_scan(*map(torch.from_numpy, (r, k, v, w, u)))
    out, state = to_np(out), to_np(state)
    assert out.shape == (b, t, h, dv) and state.shape == (b, h, dk, dv)
    want_k = np.asarray(jax_scan(r, k, v, w, u, chunk=32, interpret=True))
    np.testing.assert_allclose(out, want_k, **TOL)
    out_r, state_r = jref.rwkv6_scan_ref(
        *map(jnp.asarray, (r, k, v, w, u)), jnp.zeros((b, h, dk, dv)))
    np.testing.assert_allclose(out, np.asarray(out_r), **TOL)
    np.testing.assert_allclose(state, np.asarray(state_r), **TOL)
    t_out, t_state = tref.rwkv6_scan_ref(
        *map(torch.from_numpy, (r, k, v, w, u)),
        torch.zeros((b, h, dk, dv)))
    np.testing.assert_allclose(to_np(t_out), np.asarray(out_r), **TOL)
    np.testing.assert_allclose(to_np(t_state), np.asarray(state_r), **TOL)


#: the card's scan cases beyond the JAX tests' (chip_smoke.py SCAN_CASES):
#: (B, T, H, Dk, Dv, every decay at this value or None).  Every decay at
#: e^-8 runs 10 steps: from the 11th step of a chunk k~ = k e^88 leaves the
#: float32 range, in the reference's chunked algebra too.
CARD_CASES = [
    (2, 1, 3, 64, 64, None), (2, 31, 3, 64, 64, None),
    (2, 33, 3, 64, 64, None), (1, 200, 1, 64, 64, None),
    (2, 96, 4, 64, 32, None), (2, 80, 4, 32, 64, None),
    (2, 70, 2, 40, 24, None), (2, 10, 4, 64, 64, float(np.exp(-8.0))),
    (2, 256, 4, 64, 64, 0.9999)]


@pytest.mark.parametrize("b,t,h,dk,dv,decay", CARD_CASES)
def test_plain_at_card_shapes_vs_jax(b, t, h, dk, dv, decay):
    """Partial chunks, one (batch, head), Dk != Dv, the extreme decays:
    the plain version against the JAX kernel (interpret mode) and the
    sequential oracle at the JAX kernel tests' tolerance, and against the
    reference's ``wkv_chunked`` at 1e-4 where it applies (it takes
    Dk = Dv only)."""
    arrs = _case(t * 7 + dk + dv, b, t, h, dk, dv, decay)
    out, state = rsk.rwkv6_scan(*map(torch.from_numpy, arrs))
    out, state = to_np(out), to_np(state)
    assert out.shape == (b, t, h, dv) and state.shape == (b, h, dk, dv)
    assert np.isfinite(out).all() and np.isfinite(state).all()
    np.testing.assert_allclose(out, _jax_kernel(*arrs), **TOL)
    out_r, state_r = jref.rwkv6_scan_ref(*map(jnp.asarray, arrs),
                                         jnp.zeros((b, h, dk, dv)))
    np.testing.assert_allclose(out, np.asarray(out_r), **TOL)
    np.testing.assert_allclose(state, np.asarray(state_r), **TOL)
    if dk == dv:
        j_out, j_state = jrwkv.wkv_chunked(
            *map(jnp.asarray, arrs), jnp.zeros((b, h, dk, dv), jnp.float32),
            32)
        np.testing.assert_allclose(out, np.asarray(j_out), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(state, np.asarray(j_state), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("t", [64, 96, 40])
def test_final_state_vs_reference_wkv_chunked(t):
    """T = 40 pads the last chunk (w = 1, r = k = v = 0)."""
    b, h, d = 2, 2, 16
    r, k, v, w, u = _case(t, b, t, h, d, d)
    out, state = rsk.rwkv6_scan(*map(torch.from_numpy, (r, k, v, w, u)))
    j_out, j_state = jrwkv.wkv_chunked(*map(jnp.asarray, (r, k, v, w, u)),
                                       jnp.zeros((b, h, d, d), jnp.float32),
                                       32)
    # chunked against chunked: the same algebra, its sums in another order
    # (the k / D_s terms reach e^8 here, so a few ulps of them show)
    np.testing.assert_allclose(to_np(out), np.asarray(j_out), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(state), np.asarray(j_state), rtol=1e-4,
                               atol=1e-4)
    out_r, state_r = jref.rwkv6_scan_ref(
        *map(jnp.asarray, (r, k, v, w, u)), jnp.zeros((b, h, d, d)))
    np.testing.assert_allclose(to_np(state), np.asarray(state_r), **TOL)


def _wkv_key_split(r, k, v, w, u, chunk=32, blocks=4):
    """The CUDA kernel's arrangement of the chunk algebra, in plain float32
    PyTorch: key columns in ``blocks`` slices, each with its own rows of the
    state; every slice adds its part r~_q S_q + A_q V + diag_q v of a
    chunk's output, and the parts are summed in slice order."""
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    pad = -t % chunk
    zp = (0, 0, 0, 0, 0, pad)
    r, k, v = (torch.nn.functional.pad(a, zp) for a in (r, k, v))
    w = torch.nn.functional.pad(w, zp, value=1.0)
    width = -(-dk // blocks)
    cols = [slice(q * width, min((q + 1) * width, dk)) for q in range(blocks)]
    states = [torch.zeros(b, h, c.stop - c.start, dv) for c in cols]
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool), -1)
    outs = []
    for c0 in range(0, t + pad, chunk):
        rc, kc, vc, wc = (a[:, c0:c0 + chunk] for a in (r, k, v, w))
        out = None
        for q, c in enumerate(cols):
            log_d = torch.cumsum(torch.log(wc[..., c]), dim=1)
            rt = rc[..., c] * torch.exp(torch.cat(
                [torch.zeros_like(log_d[:, :1]), log_d[:, :-1]], 1))
            kt = kc[..., c] * torch.exp(-log_d)
            a = torch.einsum("bthd,bshd->bhts", rt, kt) * lower
            diag = torch.einsum("bthd,hd,bthd->bth", rc[..., c], u[:, c],
                                kc[..., c])
            part = torch.einsum("bthk,bhkv->bthv", rt, states[q])
            part = part + torch.einsum("bhts,bshv->bthv", a, vc)
            part = part + diag[..., None] * vc
            out = part if out is None else out + part
            states[q] = torch.exp(log_d[:, -1])[..., None] * (
                states[q] + torch.einsum("bshk,bshv->bhkv", kt, vc))
        outs.append(out)
    return torch.cat(outs, 1)[:, :t], torch.cat(states, 2)


@pytest.mark.parametrize("t,d", [(64, 64), (40, 64), (33, 32), (1, 64)])
def test_kernel_key_split_form_vs_reference_wkv_chunked(t, d):
    """The kernel splits each chunk's sums over key columns into four
    partial sums (one per block of a cluster) added in a fixed order; that
    form, in plain PyTorch, against the reference's wkv_chunked at 1e-4."""
    b, h = 2, 2
    arrs = _case(t + 3 * d, b, t, h, d, d)
    out, state = _wkv_key_split(*map(torch.from_numpy, arrs))
    j_out, j_state = jrwkv.wkv_chunked(*map(jnp.asarray, arrs),
                                       jnp.zeros((b, h, d, d), jnp.float32),
                                       32)
    np.testing.assert_allclose(to_np(out), np.asarray(j_out), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(state), np.asarray(j_state), rtol=1e-4,
                               atol=1e-4)


def test_carried_state_continues_the_sequence():
    """wkv_chunked from the state after a first half equals the whole run."""
    b, t, h, d = 1, 64, 2, 16
    arrs = list(map(torch.from_numpy, _case(9, b, t, h, d, d)))
    r, k, v, w, u = arrs
    full, s_full = rsk.rwkv6_scan(r, k, v, w, u)
    first, s1 = rsk.rwkv6_scan(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u)
    second, s2 = rsk.wkv_chunked(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:],
                                 u, s1, 32)
    torch.testing.assert_close(torch.cat([first, second], 1), full,
                               rtol=0, atol=0)
    torch.testing.assert_close(s2, s_full, rtol=0, atol=0)


def test_bfloat16_inputs():
    b, t, h, d = 1, 40, 2, 16
    r, k, v, w, u = map(torch.from_numpy, _case(3, b, t, h, d, d))
    out, state = rsk.rwkv6_scan(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)
    want, want_s = rsk.rwkv6_scan(r.bfloat16().float(), k.bfloat16().float(),
                                  v.bfloat16().float(), w, u)
    assert out.dtype == state.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(state, want_s, rtol=0, atol=0)


def test_launch_counter_stays_zero_on_cpu():
    before = rsk.rwkv6_scan.launches
    rsk.rwkv6_scan(*map(torch.from_numpy, _case(1, 1, 8, 1, 8, 8)))
    assert rsk.rwkv6_scan.launches == before == 0


class _CudaLike:
    def __init__(self, t: torch.Tensor):
        self.device = torch.device("cuda")
        self.dtype, self.shape = t.dtype, t.shape


def test_cuda_call_without_the_library_raises(monkeypatch):
    monkeypatch.setattr(rsk, "_LIB", None)
    monkeypatch.setattr(rsk, "BUILD_DIR", rsk.BUILD_DIR.parent / "no-such-build")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    x = _CudaLike(torch.zeros(1, 8, 1, 8))
    with pytest.raises(RuntimeError, match="nvcc"):
        rsk.rwkv6_scan(x, x, x, x, _CudaLike(torch.zeros(1, 8)))
    with pytest.raises(ValueError, match="unsupported device"):
        m = torch.empty(1, 8, 1, 8, device="meta")
        rsk.rwkv6_scan(m, m, m, m, torch.empty(1, 8, device="meta"))
    assert rsk.rwkv6_scan.launches == 0
