"""The port's two kernel ops, on the CPU (plain versions), against the JAX
kernels in interpret mode and the scalar oracle.

Tolerance: rtol=2e-5 (the reference's own kernel contract,
docs/kernels.md) plus an absolute floor.  The integer accumulators are
exact on both sides; the float32 epilogue adds and subtracts terms of
magnitude up to 255*255*K (accumulator, zero-point corrections) before
scaling by sa*sw, so four float32 ulps of 255*255*K, times sa*sw, bound what
two roundings of the epilogue can differ by (the reference's CPU compile
may contract a multiply-add; its wrapper reorders the terms when it pads K).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.policy import ApproxPolicy
from repro_torch.kernels import approx_matmul as amk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_port import to_np

import importlib

jq = importlib.import_module("repro.quant.quantize")
tq = importlib.import_module("repro_torch.quant.quantize")

RTOL = 2e-5
MODES = [("exact", 0), ("perforated", 1), ("perforated", 3), ("recursive", 2),
         ("recursive", 4), ("truncated", 5), ("truncated", 7)]


def _atol(k, sa, sw):
    """Four float32 ulps of the largest epilogue term, scaled to output."""
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
@pytest.mark.parametrize("shape", [(8, 32, 16), (64, 200, 48), (128, 512, 128),
                                   (4, 300, 40)])
def test_codes_kernel_plain_vs_jax(mode, m, shape):
    rng = np.random.default_rng(sum(shape) + m)
    arrays = _codes_case(rng, *shape)
    scalars = (0.015, 0.02, 7.0, 131.0)
    got = to_np(tops.approx_matmul_cv_op(*map(torch.from_numpy, arrays),
                                         *scalars, mode=mode, m=m))
    want_k = np.asarray(jops.approx_matmul_cv_op(*arrays, *scalars, mode=mode,
                                                 m=m, interpret=True))
    want_r = np.asarray(jref.approx_matmul_cv_ref(*arrays, *scalars, mode=mode,
                                                  m=m))
    atol = _atol(shape[1], scalars[0], scalars[1])
    np.testing.assert_allclose(got, want_k, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(got, want_r, rtol=RTOL, atol=atol)
    port_ref = to_np(tref.approx_matmul_cv_ref(*map(torch.from_numpy, arrays),
                                               *scalars, mode=mode, m=m))
    np.testing.assert_allclose(got, port_ref, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("use_cv", [True, False])
def test_codes_kernel_cv_flag_and_leading_dims(use_cv):
    rng = np.random.default_rng(11)
    a_q, w_q, c, c0, sqw, bias = _codes_case(rng, 15, 40, 24)
    a3 = a_q.reshape(3, 5, 40)
    scalars = (0.01, 0.02, 1.0, 2.0)
    got = to_np(tops.approx_matmul_cv_op(
        torch.from_numpy(a3), *map(torch.from_numpy, (w_q, c, c0, sqw, bias)),
        *scalars, mode="recursive", m=3, use_cv=use_cv))
    want = np.asarray(jops.approx_matmul_cv_op(
        a3, w_q, c, c0, sqw, bias, *scalars, mode="recursive", m=3,
        use_cv=use_cv, interpret=True))
    assert got.shape == (3, 5, 24)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=_atol(40, 0.01, 0.02))


def _blocked_pair(rng, kk, nn, mode, m, members=1):
    """The same float weights packed and blocked by both packages."""
    ws = [rng.normal(0, kk ** -0.5, (kk, nn // members)).astype(np.float32)
          for _ in range(members)]
    jp = [jq.pack_linear(jnp.asarray(w), None, mode, m) for w in ws]
    tp = [tq.pack_linear(torch.from_numpy(w), None, mode, m) for w in ws]
    jp = jp[0] if members == 1 else jq.concat_packs(jp)
    tp = tp[0] if members == 1 else tq.concat_packs(tp)
    return (jq.build_blocked_layout(jp, jq.calibrate_minmax(-4.0, 4.0)),
            tq.build_blocked_layout(tp, tq.calibrate_minmax(-4.0, 4.0)))


@pytest.mark.parametrize("mode,m", MODES)
@pytest.mark.parametrize("mm,kk,nn,members,dtype", [
    (1, 64, 192, 3, "bfloat16"),    # one decode row, fused q|k|v pack
    (4, 64, 192, 3, "float32"),     # decode M <= 8, fused q|k|v pack
    (8, 200, 48, 1, "bfloat16"),    # DECODE_M_MAX rows, ragged K and N
    (16, 200, 48, 1, "float32"),    # ragged K and N
    (40, 128, 256, 2, "bfloat16"),  # prefill-shaped, bf16, fused gate|up
    # conv-shaped (the CNNs' im2col calls, the conv route on the card):
    # ragged M, K off a multiple of 8, N below 64
    (300, 27, 16, 1, "float32"),
    (300, 24, 48, 1, "float32"),
    (260, 288, 32, 1, "float32"),
])
def test_fused_kernel_plain_vs_jax(mode, m, mm, kk, nn, members, dtype):
    rng = np.random.default_rng(mm * kk + m)
    jb, tb = _blocked_pair(rng, kk, nn, mode, m, members)
    x = rng.normal(0, 1.5, (mm, kk)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tops.quantized_dense_fused_op(xt, tb, mode=mode, m=m)
    want = jops.quantized_dense_fused_op(xj, jb, mode=mode, m=m, interpret=True)
    assert got.dtype == xt.dtype and tuple(got.shape) == (mm, nn)
    got32 = to_np(got.float())
    want32 = np.asarray(want.astype(jnp.float32))
    atol = _atol(kk, float(tb.meta[0, 0]), float(tb.epilogue[4].max()))
    # bf16 output: one bf16 rounding of float32 values that agree to ulps
    rtol = RTOL if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got32, want32, rtol=rtol, atol=atol)
    # the oracle over the same codes: quantize with the pack's own params
    a_q = tq.quantize(xt.float(), tq.QuantParams(tb.meta[0, 0],
                                                 tb.meta[0, 1].to(torch.int32)))
    epi = tb.epilogue[:, :nn]
    if members == 1:  # per-tensor weight quant params: the scalar oracle
        want_r = to_np(tref.approx_matmul_cv_ref(
            a_q, tb.w_qb[:kk, :nn], epi[0], epi[1], epi[2], epi[3],
            tb.meta[0, 0], epi[4, 0], tb.meta[0, 1], epi[5, 0], mode=mode, m=m))
        np.testing.assert_allclose(got32, want_r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode,m", MODES)
def test_fused_kernel_cv_off_conv_shape(mode, m):
    """A conv-shaped call (300 rows, K = 27, N = 16) with the CV off
    agrees with the JAX kernel (interpret mode) with the CV off."""
    mm, kk, nn = 300, 27, 16
    rng = np.random.default_rng(7 + m)
    jb, tb = _blocked_pair(rng, kk, nn, mode, m)
    x = rng.normal(0, 1.5, (mm, kk)).astype(np.float32)
    got = to_np(tops.quantized_dense_fused_op(torch.from_numpy(x), tb,
                                              mode=mode, m=m, use_cv=False))
    want = np.asarray(jops.quantized_dense_fused_op(
        jnp.asarray(x), jb, mode=mode, m=m, use_cv=False, interpret=True))
    atol = _atol(kk, float(tb.meta[0, 0]), float(tb.epilogue[4].max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    if mode != "exact":  # the CV moves the output
        with_cv = to_np(tops.quantized_dense_fused_op(
            torch.from_numpy(x), tb, mode=mode, m=m, use_cv=True))
        assert not np.array_equal(with_cv, got)


@pytest.mark.parametrize("mode,m", MODES)
@pytest.mark.parametrize("mm", [1, 4, 8])
def test_member_slices_plain_vs_jax(mode, m, mm):
    """A fused group's members read row slices of the group's K-major codes
    (no copy of their own): each member's call over its slice agrees with
    the JAX op on the member packed alone (interpret mode) and equals the
    group call's columns bit for bit, at decode rows."""
    rng = np.random.default_rng(100 * mm + m)
    kk, widths = 96, (64, 32, 32)   # q | k | v of a GQA layer
    ws = [rng.normal(0, kk ** -0.5, (kk, w)).astype(np.float32)
          for w in widths]
    a_lo, a_hi = -4.0, 4.0
    tps = [tq.pack_linear(torch.from_numpy(w), None, mode, m) for w in ws]
    group = tq.build_blocked_layout(tq.concat_packs(tps),
                                    tq.calibrate_minmax(a_lo, a_hi))
    x = rng.normal(0, 1.5, (mm, kk)).astype(np.float32)
    xt = torch.from_numpy(x)
    whole = to_np(tops.quantized_dense_fused_op(xt, group, mode=mode, m=m))
    lo = 0
    for w, tp in zip(ws, tps):
        n = w.shape[1]
        own = tq.build_blocked_layout(tp, tq.calibrate_minmax(a_lo, a_hi))
        member = dataclasses.replace(own, w_qbt=group.w_qbt[lo:lo + n])
        assert member.w_qbt.untyped_storage().data_ptr() == \
            group.w_qbt.untyped_storage().data_ptr()
        got = to_np(tops.quantized_dense_fused_op(xt, member, mode=mode, m=m))
        jb = jq.build_blocked_layout(jq.pack_linear(jnp.asarray(w), None,
                                                    mode, m),
                                     jq.calibrate_minmax(a_lo, a_hi))
        want = np.asarray(jops.quantized_dense_fused_op(
            jnp.asarray(x), jb, mode=mode, m=m, interpret=True))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=_atol(
            kk, float(own.meta[0, 0]), float(own.epilogue[4].max())))
        np.testing.assert_array_equal(got, whole[:, lo:lo + n])
        lo += n


def _fast_codes(x: torch.Tensor, sa: float, za: float) -> torch.Tensor:
    """The CUDA kernels' quantization (``to_code`` in csrc/approx_matmul.cu)
    in float32 PyTorch: x * RN(1/sa), rounded to an integer by adding and
    subtracting 1.5 * 2^23, with the IEEE division where |x * inv| < 512 lies
    within 2^-12 of a half-integer."""
    sa_t = torch.tensor(sa, dtype=torch.float32)
    inv = torch.tensor(1.0, dtype=torch.float32) / sa_t
    big = torch.tensor(12582912.0, dtype=torch.float32)
    q = x * inv
    r = (q + big) - big
    tie = (q.abs() < 512) & ((q - r).abs() > 0.5 - 2.0 ** -12)
    q_exact = x / sa_t
    r = torch.where(tie, (q_exact + big) - big, r)
    return torch.clamp(r + za, 0, 255).to(torch.int32)


@pytest.mark.parametrize("sa", [8.0 / 255, 0.0123, 3.0e-4, 1.7])
def test_fast_quotient_quantizes_like_the_division(sa):
    """The kernels' quantization equals quantize_i32's IEEE division and
    round-half-even on random inputs, on inputs a few ulps either side of
    every half-integer quotient in range, and on extremes."""
    rng = np.random.default_rng(int(sa * 1e6))
    za = 131.0
    ties = (np.arange(-600, 600) + 0.5) * np.float32(sa)
    ties = ties.astype(np.float32).view(np.int32)
    near = (ties[:, None] + np.arange(-4, 5)[None, :]).reshape(-1)
    x = np.concatenate([
        rng.normal(0, 300 * sa, 20000).astype(np.float32),
        near.view(np.float32),
        np.array([0.0, -0.0, 1e-40, -1e-40, 3e38, -3e38, 511.5 * sa,
                  -511.5 * sa, 512.5 * sa], dtype=np.float32)])
    xt = torch.from_numpy(x)
    want = tq.quantize_i32(xt, tq.QuantParams(
        torch.tensor(sa, dtype=torch.float32),
        torch.tensor(int(za), dtype=torch.int32)))
    assert torch.equal(_fast_codes(xt, sa, za), want)


def test_launch_counter_stays_zero_on_cpu():
    before = (amk.approx_matmul_cv_fused.launches, amk.approx_matmul_cv.launches)
    rng = np.random.default_rng(3)
    _, tb = _blocked_pair(rng, 32, 16, "perforated", 2)
    tops.quantized_dense_fused_op(torch.randn(3, 32), tb, mode="perforated", m=2)
    tops.approx_matmul_cv_op(*map(torch.from_numpy, _codes_case(rng, 3, 32, 16)),
                             0.1, 0.1, 1.0, 2.0, mode="perforated", m=2)
    assert (amk.approx_matmul_cv_fused.launches,
            amk.approx_matmul_cv.launches) == before == (0, 0)


class _CudaLike:
    """Stands in for a CUDA tensor where the sandbox has no card: the
    wrapper reads only its device before it needs the kernel library."""

    def __init__(self, t: torch.Tensor):
        self._t = t
        self.device = torch.device("cuda")
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return True


def test_cuda_call_without_the_library_raises(monkeypatch):
    monkeypatch.setattr(amk, "_LIB", None)
    monkeypatch.setattr(amk, "BUILD_DIR", amk.BUILD_DIR.parent / "no-such-build")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    rng = np.random.default_rng(4)
    _, tb = _blocked_pair(rng, 32, 16, "perforated", 2)
    x = _CudaLike(torch.randn(3, 32))
    with pytest.raises(RuntimeError, match="nvcc"):
        amk.approx_matmul_cv_fused(x, tb.w_qbt, tb.epilogue, tb.meta, k=32,
                                   n=16, mode="perforated", m=2)
    a = _CudaLike(torch.zeros(3, 32, dtype=torch.uint8))
    with pytest.raises(RuntimeError, match="nvcc"):
        amk.approx_matmul_cv(a, tb.w_qb, tb.epilogue[0], tb.epilogue[1],
                             torch.zeros(16, dtype=torch.int32), None,
                             torch.ones(4), mode="perforated", m=2,
                             true_k=32.0)
    with pytest.raises(ValueError, match="unsupported device"):
        amk.approx_matmul_cv_fused(torch.empty(3, 32, device="meta"),
                                   tb.w_qbt, tb.epilogue, tb.meta, k=32, n=16,
                                   mode="perforated", m=2)
    assert amk.approx_matmul_cv_fused.launches == 0


def test_tile_names_follow_the_source():
    """``approx_matmul.TILES`` names the source's ``TileId`` values in their
    order, since ``tile()`` indexes it by the ``am_tile`` result."""
    import re

    body = re.search(r"enum TileId \{([^}]*)\}", amk.SOURCE.read_text())
    ids = [t.strip() for t in body.group(1).split(",") if t.strip()]
    assert [i.removeprefix("TILE_").replace("_PLANES", " planes").lower()
            for i in ids] == list(amk.TILES)


def test_launch_kinds_follow_the_source():
    """``approx_matmul.LAUNCH_KINDS`` names the source's ``LaunchKind``
    counters in their order, each by a kernel the source defines, since
    ``kernel_launches`` zips them with the ``am_launches`` counts."""
    import re

    src = amk.SOURCE.read_text()
    body = re.search(r"enum LaunchKind \{([^}]*)\}", src).group(1)
    kinds = [t.strip() for t in body.split(",") if t.strip()]
    assert kinds == ["L_PREP", "L_WGMMA", "L_SPLIT_K", "L_CONV", "L_ROWS",
                     "L_KINDS"]
    assert len(amk.LAUNCH_KINDS) == len(kinds) - 1
    for kind, name in zip(kinds, amk.LAUNCH_KINDS):
        assert re.search(rf"\n{name}\(", src), name  # a kernel's definition
        assert f"counted({kind})" in src


def test_conv_route_bounds_follow_the_source():
    """The wrapper skips the prep kernel's scratch exactly where the source
    takes the conv route: its CONV_K_MAX and CONV_N_MAX are the source's."""
    import re

    src = amk.SOURCE.read_text()
    for name in ("CONV_K_MAX", "CONV_N_MAX", "CONV_KN_MAX"):
        want = int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
        assert getattr(amk, name) == want
    assert not amk._takes_prep(amk.DECODE_M_MAX, 4096, 4096)  # split-K
    assert not amk._takes_prep(256_000, 27, 16)                # conv
    assert not amk._takes_prep(9, amk.CONV_K_MAX, 32)
    assert not amk._takes_prep(16_000, 576, 64)
    assert amk._takes_prep(9, amk.CONV_K_MAX + 1, 16)          # prep + wgmma
    assert amk._takes_prep(4096, 288, amk.CONV_N_MAX + 1)
    assert amk._takes_prep(16_000, 576, 128)                   # K * N
    assert amk._prep_scratch("t", 256_000, 288, 32, "meta") == (None, 0, 0)


@pytest.mark.parametrize("arch", sorted(
    __import__("repro_torch.configs.registry",
               fromlist=["ARCH_REGISTRY"]).ARCH_REGISTRY))
def test_no_llm_layer_is_conv_shaped(arch):
    """Every packable layer of every registered model at full size (built
    on the meta device, a uniform spec packing them all) keeps its route:
    none is narrow enough for the conv kernel, so only the CNNs take it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_model
    from repro_torch.numerics import uniform_spec

    params = build_model(get_config(arch), "meta").init(0)
    shapes = {tuple(e.w_shape[-2:])
              for e in uniform_spec(None).resolve(params).entries}
    assert shapes
    assert not [kn for kn in shapes
                if kn[0] <= amk.CONV_K_MAX and kn[1] <= amk.CONV_N_MAX]


@pytest.mark.parametrize("mode,m", [("perforated", 2), ("truncated", 5)])
def test_quantized_dense_pallas_dispatch(mode, m):
    """A packed layer without a blocked layout takes the codes-in kernel and
    agrees with the blocked (float-in) path on the same pack."""
    from repro_torch.core.approx_linear import QuantizedDense, pack_dense

    rng = np.random.default_rng(9)
    p = {"w": torch.from_numpy(rng.normal(0, 0.2, (48, 40)).astype(np.float32))}
    qd = pack_dense(p, ApproxPolicy(mode, m, backend="pallas"), (-3.0, 3.0))
    bare = QuantizedDense(qd.pack, qd.a_qp, qd.policy, None)
    x = torch.from_numpy(rng.normal(0, 1, (6, 48)).astype(np.float32))
    np.testing.assert_allclose(
        to_np(tops.quantized_dense_pallas(x, bare)),
        to_np(tops.quantized_dense_pallas(x, qd)), rtol=RTOL,
        atol=_atol(48, float(qd.a_scale), float(qd.w_scale)))
    assert JaxPolicy(mode, m, backend="pallas").to_dict() == \
        dataclasses.asdict(qd.policy)


# ---------------------------------------------------------------------------
# The kernels' integer decomposition, the K-major copy, the wrapper's checks
# ---------------------------------------------------------------------------

DECOMP_MODES = MODES + [("perforated", 8), ("recursive", 8), ("truncated", 8)]


@pytest.mark.parametrize("mode,m", DECOMP_MODES)
def test_kernel_decomposition_matches_both_oracles(mode, m):
    """acc = (A & main).W - sum over planes (A & amask).(W & wmask), the
    integer form both tiles compute, evaluated with int64 matmuls: equal to
    both packages' elementwise oracles at every (a, w) code pair (K = 1)
    and over a K = 300 sum."""
    import jax.numpy as jnp_

    from repro.core import multipliers as jam
    from repro_torch.core import multipliers as tam

    main, planes = amk.decomposition(mode, m)
    assert (main == 0xFF) == (mode != "perforated" or m == 0)
    assert len(planes) == {"exact": 0, "perforated": 0, "recursive": 1,
                           "truncated": m}[mode] * (m > 0)
    args = amk._mode_args(mode, m, True)
    assert args[:4] == (main, len(planes),
                        sum(a << (8 * i) for i, (a, _) in enumerate(planes)),
                        sum(w << (8 * i) for i, (_, w) in enumerate(planes)))
    codes = torch.arange(256, dtype=torch.int64)
    rng = np.random.default_rng(m + 1)
    for a, w in ((codes[:, None], codes[None, :]),
                 (torch.from_numpy(rng.integers(0, 256, (16, 300))),
                  torch.from_numpy(rng.integers(0, 256, (300, 24))))):
        got = (a & main) @ w
        for am_, wm_ in planes:
            got = got - (a & am_) @ (w & wm_)
        want_t = tam.approx_matmul_ref(a, w, mode, m).to(torch.int64)
        want_j = np.asarray(jam.approx_matmul_ref(
            jnp_.asarray(a.numpy(), jnp_.int32),
            jnp_.asarray(w.numpy(), jnp_.int32), mode, m)).astype(np.int64)
        assert torch.equal(got, want_t)
        np.testing.assert_array_equal(got.numpy(), want_j)


@pytest.mark.parametrize("mod,name", [("attn", "o"), ("attn", "qkv"),
                                      ("mlp", "down"), ("mlp", "gateup")])
def test_k_major_copy_is_the_reference_w_qb_transposed(mod, name):
    """Packs of a model carried across by the bridge: each layer's K-major
    codes, transposed, are byte-equal to the reference's blocked w_qb (zeros
    past Kb, rows padded to 16 bytes), and no pack holds a row-major copy;
    a fused group's members hold row slices of the group's codes (the same
    storage), byte-equal to the reference member's w_qb transposed."""
    from repro.core.approx_linear import pack_params as jax_pack_params
    from repro_torch.core.approx_linear import pack_params

    from _torch_port import jax_side, torch_side

    _, _, jparams = jax_side()
    _, _, tparams = torch_side()
    jp = jax_pack_params(jparams, lambda p: JaxPolicy("perforated", 2,
                                                      backend="pallas"))
    tp = pack_params(tparams, lambda p: ApproxPolicy("perforated", 2,
                                                     backend="pallas"))
    jl, tl = jp["blocks"][mod][name], tp["blocks"][mod][name]
    jw = np.asarray(jl.blocked.w_qb)
    assert len(tl) == jw.shape[0]
    for i in range(len(tl)):
        kb, nb = jw[i].shape
        t = to_np(tl[i].blocked.w_qbt)
        assert t.dtype == np.uint8 and t.shape == (nb, -(-kb // 16) * 16)
        assert np.ascontiguousarray(t.T[:kb]).tobytes() == jw[i].tobytes()
        assert not t[:, kb:].any()
        assert "w_qb" not in dict(tl[i].named_buffers())
        members = list(getattr(tl[i], "members", []))
        lo = 0
        for jm, member in zip(getattr(jl, "members", []), members):
            mt = member.blocked.w_qbt
            assert mt is not None and "w_qb" not in dict(member.named_buffers())
            assert mt.untyped_storage().data_ptr() == \
                tl[i].w_qbt.untyped_storage().data_ptr()
            assert torch.equal(mt, tl[i].w_qbt[lo:lo + mt.shape[0]])
            jmw = np.asarray(jm.blocked.w_qb)[i]
            assert np.ascontiguousarray(to_np(mt).T[:kb]).tobytes() == \
                jmw.tobytes()
            lo += mt.shape[0]
        assert lo == (tl[i].blocked.n if members else 0)


def _meta_pack(mm):
    rng = np.random.default_rng(12)
    _, tb = _blocked_pair(rng, 32, 16, "perforated", 2)
    return (torch.empty(mm, 32, device="meta"), tb.epilogue.to("meta"),
            tb.meta.to("meta"), tb.w_qbt)


_K_MAJOR_CASES = [  # (id, operand, error)
    ("None", None, "needs the K-major weight copy"),
    ("w_qbt1", torch.zeros(16, 16, dtype=torch.uint8), "K-major weights"),  # < k
    ("w_qbt2", torch.zeros(8, 32, dtype=torch.uint8), "K-major weights"),   # rows
    ("w_qbt3", torch.zeros(16, 40, dtype=torch.uint8), "K-major weights"),  # stride
    ("w_qbt4", torch.zeros(16, 32, dtype=torch.int8), "K-major weights"),   # dtype
    ("slice", torch.zeros(48, 32, dtype=torch.uint8), "unsupported device"),
    ("pack", "pack", "unsupported device"),                                 # valid
]


@pytest.mark.parametrize("w_qbt,match,mm", [
    pytest.param(w, match, mm, id=f"{pre}{name}-{match}")
    for pre, mm in (("", amk.DECODE_M_MAX + 1), ("decode-", amk.DECODE_M_MAX))
    for name, w, match in _K_MAJOR_CASES])
def test_fused_prefill_rows_check_the_k_major_operand(w_qbt, match, mm):
    """Every call on the card reads the pack's K-major codes: decode rows
    (the split-K kernel) and prefill rows (the wgmma tile) alike.  The
    wrapper checks the operand before it needs a card; more rows than n
    (a fused group member's slice of the group's codes) are valid."""
    x, epi, meta, packed = _meta_pack(mm)
    w_qbt = packed.to("meta") if isinstance(w_qbt, str) else w_qbt
    if isinstance(w_qbt, torch.Tensor):
        w_qbt = w_qbt.to("meta")
    with pytest.raises(ValueError, match=match):
        amk.approx_matmul_cv_fused(x, w_qbt, epi, meta, k=32, n=16,
                                   mode="perforated", m=2)
    assert amk.approx_matmul_cv_fused.launches == 0


@pytest.mark.parametrize("dtype,numel,ldq,match", [
    (torch.uint8, 64 * (48 + 8), 48, None),
    (torch.int32, 64 * (48 + 8), 48, "scratch"),        # wrong dtype
    (torch.uint8, 64 * 48, 48, "scratch"),              # no statistics
    (torch.uint8, 63 * (48 + 8), 48, "scratch"),        # rows
    (torch.uint8, 64 * (40 + 8), 40, "scratch"),        # ldq not 16-aligned
])
def test_scratch_checks(dtype, numel, ldq, match):
    """The prep kernel's outputs in one buffer: (M, k rounded up to 16)
    uint8 codes, then (M, 2) int32 row statistics."""
    mm, k = 64, 40
    buf = torch.empty(numel, dtype=dtype, device="meta")
    if match is None:
        amk._check_scratch("t", buf, mm, ldq)
        made, made_ldq = amk._scratch(mm, k, "meta")
        assert made_ldq == 48 and made.dtype == torch.uint8
        amk._check_scratch("t", made, mm, made_ldq)
    else:
        with pytest.raises(ValueError, match=match):
            amk._check_scratch("t", buf, mm, ldq)
