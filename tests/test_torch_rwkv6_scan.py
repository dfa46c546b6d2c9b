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


def _case(seed, b, t, h, dk, dv):
    """The JAX kernel tests' distribution: decays in [e^-8, 0.9999]."""
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 1, (b, t, h, dk)).astype(np.float32)
    k = rng.normal(0, 1, (b, t, h, dk)).astype(np.float32)
    v = rng.normal(0, 1, (b, t, h, dv)).astype(np.float32)
    w = np.clip(np.exp(-np.exp(rng.normal(-1, 1.5, (b, t, h, dk)))),
                np.exp(-8.0), 0.9999).astype(np.float32)
    u = rng.normal(0, 0.5, (h, dk)).astype(np.float32)
    return r, k, v, w, u


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
