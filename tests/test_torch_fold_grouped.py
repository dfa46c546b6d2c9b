"""The port's folded serving operands (``quant.quantize.build_fold`` /
``folded_linear``) and grouped CV (``core.control_variate``
``cv_constants_grouped`` / ``cv_term_grouped``, ``pack_linear(groups=)``,
``quantized_linear(groups=)``) against the JAX package.

Inputs are seeded with numpy.  Tolerances:
  * fold operands, grouped CV constants, grouped V and grouped packs: byte
    equal (the same float32 operations in the same order);
  * ``folded_linear`` against the reference's ``folded_linear`` and against
    the port's exact-integer ``quantized_linear``: rtol=2e-5 (the kernel
    contract), with an absolute floor of four float32 ulps of the
    epilogue's 255*255*K terms (sa*sw scaled) for outputs that cancel to
    near zero — the fold sums float32 products in another order;
  * the grouped ``quantized_linear``: integer accumulators exact, the
    output within the same rtol and floor of the reference's;
  * CNN logits under ``paper_grid_specs(backend="jnp")`` (folded convs):
    1e-5 of the largest logit with equal argmax, as the CNN tests hold the
    kernel path.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import control_variate as jcv
from repro.core import multipliers as jam
from repro.core.approx_linear import dense as jax_dense
from repro.core.approx_linear import pack_params as jax_pack_params
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.nn import cnn as jcnn
from repro.numerics import apply_numerics as jax_apply_numerics
from repro.numerics import paper_grid_specs as jax_grid
from repro.numerics.plan import _fold_bytes as jax_fold_bytes
from repro_torch.core import control_variate as tcv
from repro_torch.core import multipliers as tam
from repro_torch.core.approx_linear import (QuantizedDense, dense,
                                            iter_tensors, pack_params)
from repro_torch.core.policy import ApproxPolicy
from repro_torch.kernels import ops as kops
from repro_torch.nn import cnn as tcnn
from repro_torch.numerics import apply_numerics, paper_grid_specs
from repro_torch.numerics.plan import _fold_bytes

from _torch_port import to_np, torch_side

jq = importlib.import_module("repro.quant.quantize")
tq = importlib.import_module("repro_torch.quant.quantize")

MODES = [("exact", 0), ("perforated", 2), ("recursive", 3), ("truncated", 5),
         ("truncated", 6)]
RTOL = 2e-5
N = 24


def _pair(k, mode, m, seed, fused=False, groups=1):
    """The same seeded layer packed in both packages (``fused``: three
    members concatenated, per-column quant params), with a seeded bias
    and activation range."""
    rng = np.random.default_rng(seed)
    jps, tps = [], []
    for _ in range(3 if fused else 1):
        w = rng.normal(0, 0.3, (k, N)).astype(np.float32)
        b = rng.normal(0, 0.1, N).astype(np.float32)
        jps.append(jq.pack_linear(jnp.asarray(w), jnp.asarray(b), mode, m,
                                  groups=groups))
        tps.append(tq.pack_linear(torch.from_numpy(w), torch.from_numpy(b),
                                  mode, m, groups=groups))
    jp = jq.concat_packs(jps) if fused else jps[0]
    tp = tq.concat_packs(tps) if fused else tps[0]
    return (jp, jq.calibrate_minmax(-3.0, 5.0), tp,
            tq.calibrate_minmax(-3.0, 5.0))


def _floor(k, tp, tqp):
    return (4 * float(np.finfo(np.float32).eps) * 255.0 ** 2 * k
            * float(tqp.scale) * float(tp.w_scale.max()))


@pytest.mark.parametrize("fused", [False, True], ids=["single", "fused"])
@pytest.mark.parametrize("k", [27, 144, 258])
@pytest.mark.parametrize("use_cv", [True, False], ids=["cv", "no-cv"])
@pytest.mark.parametrize("mode,m", MODES)
def test_build_fold_operands_byte_equal_to_jax(mode, m, use_cv, k, fused):
    jp, jqp, tp, tqp = _pair(k, mode, m, seed=k + m, fused=fused)
    want = jq.build_fold(jp, jqp, mode, m, use_cv)
    got = tq.build_fold(tp, tqp, mode, m, use_cv)
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        assert tuple(got[key].shape) == w.shape, key
        assert to_np(got[key]).tobytes() == w.tobytes(), key
    n = tp.w_q.shape[1]
    fold_bytes = sum(got[key].numel() * 4 for key in ("A", "B", "delta")
                     if key in got)
    pol = ApproxPolicy(mode, m, use_cv=use_cv)
    assert fold_bytes == _fold_bytes(k, n, pol) == jax_fold_bytes(
        k, n, JaxPolicy(mode, m, use_cv=use_cv))


@pytest.mark.parametrize("mode,m", MODES)
def test_no_fold_past_the_exact_fan_in_or_with_groups(mode, m):
    assert tam._F32_EXACT_K == jam._F32_EXACT_K == 258
    jp, jqp, tp, tqp = _pair(259, mode, m, seed=1)
    assert jq.build_fold(jp, jqp, mode, m, True) is None
    assert tq.build_fold(tp, tqp, mode, m, True) is None
    assert _fold_bytes(259, N, ApproxPolicy(mode, m)) == 0
    if mode != "exact":
        _, _, tp4, tqp4 = _pair(64, mode, m, seed=2, groups=4)
        assert tq.build_fold(tp4, tqp4, mode, m, True) is None
        assert _fold_bytes(64, N, ApproxPolicy(mode, m, groups=4)) == 0


@pytest.mark.parametrize("k", [27, 144, 258])
@pytest.mark.parametrize("use_cv", [True, False], ids=["cv", "no-cv"])
@pytest.mark.parametrize("mode,m", MODES)
def test_folded_linear_vs_jax_and_the_integer_path(mode, m, use_cv, k):
    jp, jqp, tp, tqp = _pair(k, mode, m, seed=3 * k + m, fused=True)
    x = np.random.default_rng(k).normal(0, 2, (2, 9, k)).astype(np.float32)
    want = np.asarray(jq.folded_linear(
        jnp.asarray(x), jq.build_fold(jp, jqp, mode, m, use_cv), mode, m,
        use_cv))
    got = to_np(tq.folded_linear(torch.from_numpy(x),
                                 tq.build_fold(tp, tqp, mode, m, use_cv),
                                 mode, m, use_cv))
    exact = to_np(tq.quantized_linear(torch.from_numpy(x), tp, tqp, mode, m,
                                      use_cv))
    assert got.shape == want.shape == (2, 9, 3 * N) and got.dtype == np.float32
    atol = _floor(k, tp, tqp)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(got, exact, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("mode,m", [("perforated", 2), ("recursive", 3),
                                    ("truncated", 6)])
def test_grouped_cv_constants_term_and_pack_byte_equal_to_jax(mode, m, groups):
    jp, _, tp, _ = _pair(64, mode, m, seed=groups + m, groups=groups)
    for f in ("w_q", "w_scale", "w_zp", "sum_qw", "c", "c0", "bias"):
        want = np.asarray(getattr(jp, f))
        assert tuple(getattr(tp, f).shape) == want.shape, f
        assert to_np(getattr(tp, f)).tobytes() == want.tobytes(), f
    assert tuple(tp.c.shape) == (groups, N)
    w_i = tp.w_q.to(torch.int32)
    tc = tcv.cv_constants_grouped(w_i, mode, m, groups)
    jc = jcv.cv_constants_grouped(jnp.asarray(to_np(w_i)), mode, m, groups)
    assert to_np(tc.c).tobytes() == np.asarray(jc.c).tobytes()
    assert to_np(tc.c0).tobytes() == np.asarray(jc.c0).tobytes()
    a = np.random.default_rng(m).integers(0, 256, (3, 5, 64))
    tv = tcv.cv_term_grouped(torch.from_numpy(a), tc, mode, m, groups)
    jv = jcv.cv_term_grouped(jnp.asarray(a), jc, mode, m, groups)
    assert tuple(tv.shape) == (3, 5, N)
    assert to_np(tv).tobytes() == np.asarray(jv).tobytes()
    with pytest.raises(ValueError, match="divisible"):
        tcv.cv_constants_grouped(w_i[:63], mode, m, groups)


@pytest.mark.parametrize("mode,m", [("perforated", 2), ("recursive", 3),
                                    ("truncated", 6)])
def test_grouped_quantized_linear_vs_jax(mode, m):
    """Exact integer accumulators, then the grouped epilogue within the
    contract's tolerance of the reference's."""
    k = 128
    jp, jqp, tp, tqp = _pair(k, mode, m, seed=7, groups=4)
    x = np.random.default_rng(m).normal(0, 2, (6, k)).astype(np.float32)
    a_i = tq.quantize_i32(torch.from_numpy(x), tqp)
    assert torch.equal(a_i, torch.from_numpy(np.array(
        jq.quantize_i32(jnp.asarray(x), jqp))).to(torch.int32))
    acc_t = tam.approx_matmul(a_i, tp.w_q, mode, m)
    acc_j = jam.approx_matmul(jnp.asarray(to_np(a_i)), jp.w_q, mode, m)
    np.testing.assert_array_equal(to_np(acc_t), np.asarray(acc_j))
    got = to_np(tq.quantized_linear(torch.from_numpy(x), tp, tqp, mode, m,
                                    groups=4))
    want = np.asarray(jq.quantized_linear(jnp.asarray(x), jp, jqp, mode, m,
                                          groups=4))
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=_floor(k, tp, tqp))


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_grouped_packs_take_the_plain_grouped_path(backend):
    """``groups > 1`` never reaches the kernel (or a fold): the dispatch
    takes the plain grouped product for either backend, as the
    reference's does, and the bridge to the kernel refuses a grouped pack."""
    _, _, tparams = torch_side()
    jparams = jax.tree.map(jnp.asarray, {
        "w": to_np(tparams["blocks"]["mlp"]["down"]["w"][0])})
    tleaf = {"w": tparams["blocks"]["mlp"]["down"]["w"][0]}
    pol = dict(mode="perforated", m=2, groups=4, backend=backend)
    tpk = pack_params({"down": tleaf}, lambda p: ApproxPolicy(**pol),
                      default_range=(-4.0, 4.0))["down"]
    jpk = jax_pack_params({"down": jparams}, lambda p: JaxPolicy(**pol),
                          default_range=(-4.0, 4.0))["down"]
    assert isinstance(tpk, QuantizedDense)
    assert tpk.blocked is None and tpk.fold is None
    assert jpk.blocked is None and jpk.fold is None
    x = np.random.default_rng(0).normal(0, 1.5, (2, 3, tleaf["w"].shape[0]))
    x = x.astype(np.float32)
    got = dense(tpk, torch.from_numpy(x))
    want = tq.quantized_linear(torch.from_numpy(x), tpk.pack, tpk.a_qp,
                               "perforated", 2, groups=4)
    assert torch.equal(got, want)
    np.testing.assert_allclose(to_np(got), np.asarray(jax_dense(
        jpk, jnp.asarray(x))), rtol=RTOL,
        atol=_floor(x.shape[-1], tpk, tpk.a_qp))
    with pytest.raises(ValueError, match="grouped"):
        kops.quantized_dense_pallas(torch.from_numpy(x), tpk)


def test_single_cv_dispatch_kernel_fold_or_integer_path():
    """Per pack, the reference's order: pallas-backend single-CV approx
    packs carry the kernel layout and no fold; jnp-backend packs (and the
    exact preset) carry the fold at these fan-ins (64, 128); ``fold=False``
    keeps them on the integer path, within the contract of the fold."""
    _, _, tparams = torch_side()
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1.5, (2, 5, 64)).astype(np.float32))
    for backend in ("pallas", "jnp"):
        packed = pack_params(tparams, lambda p: ApproxPolicy(
            "truncated", 6, backend=backend))
        mods = [m for m in iter_modules(packed)]
        assert mods
        for mod in mods:
            if backend == "pallas":
                assert mod.blocked is not None and mod.fold is None
            else:
                assert mod.blocked is None and mod.fold is not None
    folded = pack_params(tparams, lambda p: ApproxPolicy("truncated", 6))
    plain = pack_params(tparams, lambda p: ApproxPolicy("truncated", 6),
                        fold=False)
    fq, pq = (t["blocks"]["attn"]["o"][0] for t in (folded, plain))
    assert pq.fold is None
    assert sum(t.numel() for t in iter_tensors(fq)) > sum(
        t.numel() for t in iter_tensors(pq))
    yf, yp = dense(fq, x), dense(pq, x)
    assert not torch.equal(yf, yp)  # two paths, not one
    np.testing.assert_allclose(to_np(yf), to_np(yp), rtol=RTOL,
                               atol=_floor(64, pq, pq.a_qp))


def iter_modules(tree):
    from repro_torch.core.approx_linear import LayerStack, QuantizedDenseGroup

    if isinstance(tree, LayerStack):
        for i in range(len(tree)):
            yield from iter_modules(tree[i])
    elif isinstance(tree, QuantizedDenseGroup):
        yield tree
        yield from tree.members
    elif isinstance(tree, QuantizedDense):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from iter_modules(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from iter_modules(v)


# ---------------------------------------------------------------------------
# the paper grid on the reference's default backend (folded convs)
# ---------------------------------------------------------------------------

FAMILIES = ["vgg", "resnet", "inception", "shufflenet"]
#: one point per mode: perforated m=2, recursive m=3, truncated m=6
POINTS = {"perforated-2": 1, "recursive-3": 4, "truncated-6": 7}
_CNN = {}


def _cnn(family):
    if family not in _CNN:
        from repro.checkpoint.manager import _flatten
        from repro.quant import observers as jobs
        from repro_torch.bridge import from_jax_cnn_params

        kw = dict(family=family, width=8, depth=1, img_size=16)
        jc, tc = jcnn.CNNConfig(**kw), tcnn.CNNConfig(**kw)
        jp = jcnn.init_cnn(jax.random.PRNGKey(0), jc)
        tp = from_jax_cnn_params(dict(_flatten(jp)[0]))
        x = np.random.default_rng(0).random((2, 16, 16, 3)).astype(np.float32)
        with jobs.CalibrationRecorder() as rec:
            jcnn.cnn_apply(jp, jnp.asarray(x), jc)
        _CNN[family] = (jc, tc, jp, tp, x, rec.ranges())
    return _CNN[family]


@pytest.mark.parametrize("point", list(POINTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_cnn_jnp_grid_logits_vs_jax(family, point):
    """The paper grid's default backend: every conv and head with K <= 258
    runs folded (deeper ones, resnet's last stage at K = 288, the integer
    path) in both packages, and the logits agree."""
    jc, tc, jp, tp, x, jr = _cnn(family)
    jspec = jax_grid(use_cv=True)[POINTS[point]]
    tspec = paper_grid_specs(use_cv=True)[POINTS[point]]
    assert jspec.to_dict() == tspec.to_dict()
    jpk = jax_apply_numerics(jp, jspec.resolve(jp), act_ranges=jr)
    tpk = apply_numerics(tp, tspec.resolve(tp), act_ranges=jr)
    mods = list(iter_modules(tpk))
    assert all((mod.fold is not None) == (mod.w_q.shape[0] <= 258)
               for mod in mods)
    assert any(mod.fold is not None for mod in mods)
    jy = np.asarray(jcnn.cnn_apply(jpk, jnp.asarray(x), jc))
    ty = to_np(tcnn.cnn_apply(tpk, torch.from_numpy(x), tc))
    assert ty.shape == jy.shape and np.isfinite(ty).all()
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-5 * np.abs(jy).max())
    np.testing.assert_array_equal(ty.argmax(-1), jy.argmax(-1))
    assert sum(e.packed_bytes for e in tspec.resolve(tp).entries) == sum(
        e.packed_bytes for e in jspec.resolve(jp).entries)

