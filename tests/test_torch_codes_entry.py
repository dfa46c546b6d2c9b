"""The codes-in approx-matmul entry (``approx_matmul_cv``) on the CPU: its
plain version and the op against the JAX kernel in interpret mode at
ragged shapes (fan-ins off 16 bytes, widths off the column tiles, row
counts on both sides of the decode window), every mode with the CV on and
off; the ``backend: "pallas"`` bridge on a pack without a blocked layout
against the reference's; and the wrapper's card branch, driven through a
stand-in library, reading the caller's row-major weight codes in place.

Tolerance: rtol=2e-5 plus four float32 ulps of the largest epilogue term
(``tests/test_torch_kernels.py`` gives the reasoning); the integer
accumulators are exact on both sides.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.approx_linear import pack_dense as jax_pack_dense
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.kernels import ops as jops
from repro_torch.core.approx_linear import QuantizedDense, pack_dense
from repro_torch.core.policy import ApproxPolicy
from repro_torch.kernels import approx_matmul as amk
from repro_torch.kernels import ops as tops

from _torch_port import to_np

RTOL = 2e-5
MODES = [("exact", 0), ("perforated", 1), ("perforated", 3), ("recursive", 2),
         ("recursive", 4), ("truncated", 5), ("truncated", 7)]
SCALARS = (0.015, 0.02, 7.0, 131.0)  # sa, sw, za, zw


def _atol(k, sa, sw):
    return 4 * float(np.finfo(np.float32).eps) * 255.0 ** 2 * k * sa * sw


def _codes_case(rng, mm, kk, nn):
    a_q = rng.integers(0, 256, (mm, kk)).astype(np.uint8)
    w_q = rng.integers(0, 256, (kk, nn)).astype(np.uint8)
    c = rng.normal(100, 30, (nn,)).astype(np.float32)
    c0 = rng.normal(0, 10, (nn,)).astype(np.float32)
    sqw = w_q.astype(np.int64).sum(0).astype(np.int32)
    bias = rng.normal(0, 1, (nn,)).astype(np.float32)
    return a_q, w_q, c, c0, sqw, bias


@pytest.mark.parametrize("mode,m", MODES)
@pytest.mark.parametrize("mm", [1, 8, 9, 130])
@pytest.mark.parametrize("kk,nn", [(27, 16), (27, 33), (200, 16), (200, 33)])
def test_codes_entry_ragged_vs_jax(mode, m, mm, kk, nn):
    """The op and the plain version (true_k by value) against the JAX op
    in interpret mode, CV on and off: at most 8 rows the card's split-K
    route, above it the conv route (every K * N here is conv-shaped) and,
    in the chip check, the transposing and rows tiles at wider shapes."""
    rng = np.random.default_rng(mm * 1000 + kk * 10 + nn + m)
    arrays = _codes_case(rng, mm, kk, nn)
    t_arrays = [torch.from_numpy(a) for a in arrays]
    meta4 = torch.tensor(SCALARS, dtype=torch.float32)
    atol = _atol(kk, SCALARS[0], SCALARS[1])
    for use_cv in (True, False):
        want = np.asarray(jops.approx_matmul_cv_op(
            *arrays, *SCALARS, mode=mode, m=m, use_cv=use_cv, interpret=True))
        got = to_np(tops.approx_matmul_cv_op(*t_arrays, *SCALARS, mode=mode,
                                             m=m, use_cv=use_cv))
        assert got.shape == (mm, nn) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
        plain4 = amk.approx_matmul_cv_plain(*t_arrays, meta4, mode=mode, m=m,
                                            use_cv=use_cv, true_k=float(kk))
        # the op runs the plain version on the CPU: the same bits
        assert np.array_equal(to_np(plain4), got)


@pytest.mark.parametrize("mode,m", [("perforated", 2), ("recursive", 3),
                                    ("truncated", 6)])
@pytest.mark.parametrize("use_cv", [True, False])
@pytest.mark.parametrize("lead,kk,nn", [((2, 3), 48, 40), ((1, 1), 27, 33),
                                        ((3, 5), 200, 130)])
def test_legacy_pack_bridge_vs_reference(mode, m, use_cv, lead, kk, nn):
    """``quantized_dense_pallas`` on a ``backend: "pallas"`` pack without a
    blocked layout (the reference's legacy pack: quantize, then the
    codes-in kernel) against the reference's, from the same float weights,
    bias and activation range."""
    rng = np.random.default_rng(kk + nn + m)
    w = rng.normal(0, kk ** -0.5, (kk, nn)).astype(np.float32)
    b = rng.normal(0, 0.5, (nn,)).astype(np.float32)
    x = rng.normal(0, 1.2, lead + (kk,)).astype(np.float32)
    rng_ = (-3.0, 3.0)
    jqd = jax_pack_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                         JaxPolicy(mode, m, use_cv, backend="pallas"), rng_)
    jqd = dataclasses.replace(jqd, blocked=None, fold=None)
    qd = pack_dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                    ApproxPolicy(mode, m, use_cv, backend="pallas"), rng_)
    legacy = QuantizedDense(qd.pack, qd.a_qp, qd.policy, None)
    assert legacy.blocked is None and legacy.w_q is qd.w_q  # no copy
    want = np.asarray(jops.quantized_dense_pallas(jnp.asarray(x), jqd))
    got = to_np(tops.quantized_dense_pallas(torch.from_numpy(x), legacy))
    assert got.shape == lead + (nn,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=_atol(
        kk, float(qd.a_scale), float(qd.w_scale)))


class _Card:
    """Stands in for a CUDA tensor on a host without a card: the wrapper
    reads its device, dtype, shape, contiguity, size and address."""

    def __init__(self, t: torch.Tensor):
        self.t = t
        self.device = torch.device("cuda")
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return self.t.is_contiguous()

    def numel(self):
        return self.t.numel()

    def data_ptr(self):
        return self.t.data_ptr()


class _Lib:
    """A stand-in kernel library that records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def am_codes_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("mm", [4, 9, 300])
def test_card_branch_reads_w_q_in_place(monkeypatch, mm):
    """On the card the wrapper launches once on the caller's row-major w_q
    (its own address, row stride N), makes no K-major copy, allocates only
    its output and passes the fan-in by value: checked through a stand-in
    library, so that it runs on a host without a card."""
    tq = importlib.import_module("repro_torch.quant.quantize")

    def no_copy(*a, **kw):
        raise AssertionError("the codes-in entry made a K-major copy")

    outs = []

    def out(shape, dtype, device):
        outs.append((shape, dtype, device))
        return torch.empty(shape, dtype=dtype)

    lib = _Lib()
    monkeypatch.setattr(tq, "k_major", no_copy)
    monkeypatch.setattr(amk, "_LIB", lib)
    monkeypatch.setattr(amk, "_out", out)
    monkeypatch.setattr(amk, "_stream", lambda t: 0)
    monkeypatch.setattr(amk.approx_matmul_cv, "launches", 0)
    kk, nn = 200, 33
    arrays = _codes_case(np.random.default_rng(mm), mm, kk, nn)
    a_q, w_q, c, c0, sqw, bias = (_Card(torch.from_numpy(a)) for a in arrays)
    meta = _Card(torch.tensor(SCALARS, dtype=torch.float32))
    got = amk.approx_matmul_cv(a_q, w_q, c, c0, sqw, bias, meta,
                               mode="perforated", m=2, true_k=float(kk))
    assert got.shape == (mm, nn) and outs == [((mm, nn), torch.float32,
                                               torch.device("cuda"))]
    (args,) = lib.calls
    assert args[:3] == (a_q.data_ptr(), w_q.data_ptr(), nn)  # in place
    # true_k by value, the source's own tile
    assert args[7:10] == (meta.data_ptr(), float(kk), -1)
    assert args[11:15] == (mm, kk, nn, int(mm <= amk.DECODE_M_MAX))
    assert args[15:22] == amk._mode_args("perforated", 2, True)
    assert amk.approx_matmul_cv.launches == 1
    # the fan-in has one convention: by value, always given
    with pytest.raises(TypeError, match="true_k"):
        amk.approx_matmul_cv(a_q, w_q, c, c0, sqw, bias, meta,
                             mode="perforated", m=2)
    # another design named by its tile goes to the source by index
    amk.approx_matmul_cv(a_q, w_q, c, c0, sqw, bias, meta, mode="perforated",
                         m=2, true_k=float(kk), tile="rows_64x128")
    assert lib.calls[-1][9] == amk.TILES.index("rows_64x128")
    assert len(outs) == 2


def test_op_builds_meta_without_true_k_in_it():
    """The op's meta is [sa, sw, za, zw] on the codes' device (a tensor
    scalar converted there, a number filled in there) and the fan-in goes
    by value: it equals the plain call given the same meta and fan-in."""
    rng = np.random.default_rng(7)
    arrays = [torch.from_numpy(a) for a in _codes_case(rng, 5, 40, 24)]
    scal = (torch.tensor(0.01), 0.02, torch.tensor(3, dtype=torch.int32),
            120.0)
    got = tops.approx_matmul_cv_op(*arrays, *scal, mode="perforated", m=2)
    meta4 = torch.tensor([0.01, 0.02, 3.0, 120.0], dtype=torch.float32)
    assert torch.equal(got, amk.approx_matmul_cv_plain(
        *arrays, meta4, mode="perforated", m=2, true_k=40.0))
    assert tops._scalar(1.5, torch.device("cpu")).shape == ()
