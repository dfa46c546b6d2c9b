"""The port's CNN path (``repro_torch.nn.cnn``, calibration, the paper grid)
against the JAX package, on weights initialised once in JAX and carried
across by ``repro_torch.bridge.from_jax_cnn_params``.

Size: each family at width 8, depth 1, 16x16 images, batch 2.

Tolerances.  Float logits: 1e-5 of the largest logit; the two packages sum
float32 products in other orders (matmul, depthwise conv, global mean),
and the measured gap is a few ulps (below 4e-7).  Calibration ranges: the
same paths, values within 1e-6 (the recorded activations carry those ulps).
Packs are built in both packages from the reference's ranges and must be
byte-equal.  Packed logits of the port's plain path against the
reference's ``backend: "pallas"`` kernel in interpret mode: 1e-5 of the
largest logit with equal argmax; both evaluate the same integer products
and the same float32 epilogue, and the measured gap is 0, but one
activation code that rounds the other way after a float ulp would move the
next layer by about sa*sw*|w|.  The layout traps (patch order, strides,
-inf padding, channel shuffle) are data movement or a max: equal exactly;
the depthwise conv is a 9-term float32 sum: 1e-6 of the output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs.cnn_suite import CNN_SUITE as JAX_SUITE
from repro.core.approx_linear import packed_layer_paths as jax_packed_paths
from repro.core.approx_linear import pack_params as jax_pack_params
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.nn import cnn as jcnn
from repro.numerics import apply_numerics as jax_apply_numerics
from repro.numerics import paper_grid_specs as jax_grid
from repro.quant import observers as jobs
from repro_torch.bridge import from_jax_cnn_params
from repro_torch.configs.cnn_suite import CNN_SUITE, get_cnn
from repro_torch.core.approx_linear import (QuantizedDense, is_linear_params,
                                            iter_tensors, pack_params,
                                            packed_layer_paths)
from repro_torch.core.policy import ApproxPolicy
from repro_torch.nn import cnn as tcnn
from repro_torch.numerics import apply_numerics, paper_grid_specs
from repro_torch.quant import observers as tobs

from _torch_port import assert_packs_byte_equal, to_np

FAMILIES = ["vgg", "resnet", "inception", "shufflenet"]
#: one grid point per mode: indices into paper_grid_specs (perforated m=2,
#: recursive m=3, truncated m=6)
POINTS = {"perforated-2": 1, "recursive-3": 4, "truncated-6": 7}
#: the number of approx (dense) calls a forward of each suite net makes
SUITE_LAYERS = {"vgg13": 8, "vgg16": 11, "resnet44": 16, "resnet56": 22,
                "googlenet": 20, "shufflenet": 12}
FLOAT_RTOL = 1e-5
RANGE_ATOL = 1e-6


def _cfgs(family):
    kw = dict(family=family, width=8, depth=1, img_size=16)
    return jcnn.CNNConfig(**kw), tcnn.CNNConfig(**kw)


_SIDES = {}


def _sides(family):
    """(jax cfg, port cfg, jax params, port params, images, jax logits, jax
    calibration ranges), one JAX init per family."""
    if family not in _SIDES:
        jc, tc = _cfgs(family)
        jp = jcnn.init_cnn(jax.random.PRNGKey(0), jc)
        tp = from_jax_cnn_params(dict(_flatten(jp)[0]))
        x = np.random.default_rng(0).random((2, 16, 16, 3)).astype(np.float32)
        with jobs.CalibrationRecorder() as rec:
            jy = np.asarray(jcnn.cnn_apply(jp, jnp.asarray(x), jc))
        _SIDES[family] = (jc, tc, jp, tp, x, jy, rec.ranges())
    return _SIDES[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_bridge_carries_cnn_trees_with_lists(family):
    _, _, jp, tp, *_ = _sides(family)
    key = "stages" if family in ("vgg", "resnet") else "blocks"
    assert isinstance(tp[key], list) and len(tp[key]) == len(jp[key])
    flat = dict(_flatten(jp)[0])
    got = {}

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            got["/".join(path)] = to_np(node)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            for i, v in enumerate(node):
                walk(v, path + (str(i),))

    walk(tp, ())
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        assert got[k].tobytes() == np.asarray(v).tobytes(), k
    if family == "shufflenet":
        assert tuple(tp["blocks"][0]["dw"]["kernel"].shape) == (3, 3, 16)


@pytest.mark.parametrize("family", FAMILIES)
def test_float_cnn_apply_vs_jax(family):
    _, tc, _, tp, x, jy, _ = _sides(family)
    ty = to_np(tcnn.cnn_apply(tp, torch.from_numpy(x), tc))
    assert ty.shape == jy.shape == (2, 10) and ty.dtype == np.float32
    np.testing.assert_allclose(ty, jy, rtol=0,
                               atol=FLOAT_RTOL * np.abs(jy).max())


@pytest.mark.parametrize("family", FAMILIES)
def test_calibration_ranges_vs_jax(family):
    _, tc, _, tp, x, _, jr = _sides(family)
    with tobs.CalibrationRecorder() as rec:
        tcnn.cnn_apply(tp, torch.from_numpy(x), tc)
    tr = rec.ranges()
    assert sorted(tr) == sorted(jr)
    assert sorted(tr) == sorted(packed_layer_paths(pack_params(
        tp, lambda p: ApproxPolicy("perforated", 2)))), \
        "calibration paths are not the parameter paths"
    for k in jr:
        np.testing.assert_allclose(tr[k], jr[k], rtol=0, atol=RANGE_ATOL,
                                   err_msg=k)


def _packed(family, point, use_cv):
    jc, tc, jp, tp, x, _, jr = _sides(family)
    jspec = jax_grid(use_cv=use_cv, backend="pallas")[point]
    tspec = paper_grid_specs(use_cv=use_cv, backend="pallas")[point]
    assert jspec.name == tspec.name
    jpk = jax_apply_numerics(jp, jspec.resolve(jp), act_ranges=jr)
    tpk = apply_numerics(tp, tspec.resolve(tp), act_ranges=jr)
    return jpk, tpk


@pytest.mark.parametrize("family", FAMILIES)
def test_cnn_packs_byte_equal_to_jax(family):
    jpk, tpk = _packed(family, POINTS["perforated-2"], True)
    paths = packed_layer_paths(tpk)
    assert paths == jax_packed_paths(jpk) and paths
    assert_packs_byte_equal(jpk, tpk)


@pytest.mark.parametrize("use_cv", [True, False], ids=["cv", "no-cv"])
@pytest.mark.parametrize("point", list(POINTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_packed_cnn_logits_vs_jax_kernel(family, point, use_cv):
    jc, tc, *_, x, _, _ = _sides(family)
    jpk, tpk = _packed(family, POINTS[point], use_cv)
    jy = np.asarray(jcnn.cnn_apply(jpk, jnp.asarray(x), jc))  # interpret
    ty = to_np(tcnn.cnn_apply(tpk, torch.from_numpy(x), tc))
    assert ty.shape == jy.shape and np.isfinite(ty).all()
    np.testing.assert_allclose(ty, jy, rtol=0,
                               atol=FLOAT_RTOL * np.abs(jy).max())
    np.testing.assert_array_equal(ty.argmax(-1), jy.argmax(-1))


# --- the layout traps, each on its own -------------------------------------


@pytest.mark.parametrize("ksize,stride,padding",
                         [(1, 2, 0), (3, 2, 1), (5, 1, 2)],
                         ids=["k1-s2", "k3-s2", "k5"])
def test_im2col_patch_order_vs_jax(ksize, stride, padding):
    x = np.random.default_rng(1).normal(size=(2, 9, 9, 5)).astype(np.float32)
    want = np.asarray(jcnn._im2col(jnp.asarray(x), ksize, stride, padding))
    got = tcnn._im2col(torch.from_numpy(x), ksize, stride, padding)
    assert got.is_contiguous()
    np.testing.assert_array_equal(to_np(got), want)
    # and conv2d routes a strided 1x1 through the patches, not pointwise
    w = np.random.default_rng(2).normal(size=(ksize * ksize * 5, 3)
                                        ).astype(np.float32)
    leaf = {"w": w, "b": np.zeros(3, np.float32)}
    want = np.asarray(jcnn.conv2d(jax.tree.map(jnp.asarray, leaf),
                                  jnp.asarray(x), ksize, stride, padding))
    got = tcnn.conv2d({k: torch.from_numpy(v) for k, v in leaf.items()},
                      torch.from_numpy(x), ksize, stride, padding)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size,stride", [(32, 2), (16, 1), (15, 2)])
def test_depthwise_same_padding_vs_jax(size, stride):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, size, size, 8)).astype(np.float32)
    dw = {"kernel": rng.normal(size=(3, 3, 8)).astype(np.float32)}
    want = np.asarray(jcnn._depthwise(jax.tree.map(jnp.asarray, dw),
                                      jnp.asarray(x), stride))
    got = to_np(tcnn._depthwise({"kernel": torch.from_numpy(dw["kernel"])},
                                torch.from_numpy(x), stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    if size % 2 == 0 and stride == 2:  # symmetric padding is the trap
        sym = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(dw["kernel"]).permute(2, 0, 1)[:, None],
            stride=2, padding=1, groups=8).permute(0, 2, 3, 1)
        assert sym.shape == want.shape
        assert np.abs(to_np(sym) - want).max() > 1e-2


def test_inception_pool_branch_and_channel_shuffle_vs_jax():
    x = np.random.default_rng(4).normal(size=(2, 8, 8, 12)).astype(np.float32)
    xj = jnp.asarray(x)
    want = np.asarray(jcnn.maxpool(jnp.pad(
        xj, ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=-jnp.inf), 3, 1))
    got = to_np(tcnn._pool_branch(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(
        to_np(tcnn.maxpool(torch.from_numpy(x))), np.asarray(jcnn.maxpool(xj)))
    np.testing.assert_array_equal(
        to_np(tcnn._channel_shuffle(torch.from_numpy(x), 4)),
        np.asarray(jcnn._channel_shuffle(xj, 4)))


# --- the list-walker repair -------------------------------------------------


def _list_tree(rng):
    def leaf(k, n):
        return {"w": rng.normal(size=(k, n)).astype(np.float32),
                "b": np.zeros(n, np.float32)}

    return {"stages": [[{"conv": leaf(9, 4)}, {"conv": leaf(36, 4)}],
                       [{"conv": leaf(36, 8)}]],
            "blocks": ({"pw": leaf(8, 8), "dw": {"kernel": rng.normal(
                size=(3, 3, 8)).astype(np.float32)}},),
            "head": {"fc": leaf(8, 3)}}


def test_list_valued_trees_pack_every_linear_leaf():
    """resolve, apply_numerics and packed_layer_paths descend lists and
    tuples with str(index) segments, as the reference's walkers do; a
    tree whose layers sit in lists is packed, not left float."""
    tree = _list_tree(np.random.default_rng(5))
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(torch.from_numpy, tree)
    want = ["blocks/0/pw", "head/fc", "stages/0/0/conv", "stages/0/1/conv",
            "stages/1/0/conv"]
    jspec = jax_grid(backend="pallas")[1]
    tspec = paper_grid_specs(backend="pallas")[1]
    jplan, tplan = jspec.resolve(jtree), tspec.resolve(ttree)
    assert sorted(e.path for e in tplan.entries) == want
    assert [e.path for e in tplan.entries] == [e.path for e in jplan.entries]
    tpk = apply_numerics(ttree, tplan)  # strict: plan == the tree's layers
    jpk = jax_apply_numerics(jtree, jplan)
    assert packed_layer_paths(tpk) == jax_packed_paths(jpk) == want
    assert isinstance(tpk["stages"], list) and isinstance(tpk["blocks"], tuple)
    assert isinstance(tpk["stages"][1][0]["conv"], QuantizedDense)
    assert torch.is_tensor(tpk["blocks"][0]["dw"]["kernel"])
    n_codes = sum(t.numel() for t in iter_tensors(tpk)
                  if t.dtype == torch.uint8)
    assert n_codes >= sum(leaf["w"].size for leaf in (
        tree["stages"][0][0]["conv"], tree["head"]["fc"]))
    # and pack_params with a policy function, not a plan
    direct = pack_params(ttree, lambda p: ApproxPolicy("perforated", 2))
    assert packed_layer_paths(direct) == want
    assert jax_packed_paths(jax_pack_params(
        jtree, lambda p: JaxPolicy("perforated", 2))) == want


@pytest.mark.parametrize("name", sorted(CNN_SUITE))
def test_suite_plan_lists_the_reference_paths(name):
    """Each of the six nets at full width: the port's plan, its packs and
    its calibration paths name the reference's layers, every linear leaf
    packed, and a forward makes one approx call per layer."""
    assert CNN_SUITE[name] == tcnn.CNNConfig(**vars(JAX_SUITE[name]))
    cfg = get_cnn(name)
    jp = jax.eval_shape(lambda: jcnn.init_cnn(jax.random.PRNGKey(0),
                                              JAX_SUITE[name]))
    jpaths = sorted(
        e.path for e in jax_grid(backend="pallas")[1].resolve(jp).entries)
    tp = tcnn.init_cnn(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    plan = paper_grid_specs(backend="pallas")[1].resolve(tp)
    assert sorted(e.path for e in plan.entries) == jpaths
    assert len(jpaths) == SUITE_LAYERS[name]
    packed = apply_numerics(tp, plan)
    assert packed_layer_paths(packed) == jpaths
    left = []

    def walk(node, path):
        if is_linear_params(node):
            left.append(path)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))

    walk(packed, ())
    assert not left, f"float linear leaves left: {left[:3]}"
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with tobs.CalibrationRecorder() as rec:
        y = tcnn.cnn_apply(tp, x, cfg)
    assert y.shape == (1, 10) and sorted(rec.ranges()) == jpaths


def test_recorder_nesting_and_scopes():
    with tobs.scope("stages", 0):
        with tobs.scope("1"):
            assert tobs.current_path() == "stages/0/1"
        assert tobs.current_path() == "stages/0"
    assert tobs.current_path() == ""
    with tobs.CalibrationRecorder() as rec:
        with pytest.raises(RuntimeError, match="nested"):
            with tobs.CalibrationRecorder():
                pass
        with tobs.scope("a"):
            tobs.record(torch.tensor([1.0, -2.0]))
        with tobs.scope("a"):
            tobs.record(torch.tensor([3.0]))
    assert rec.ranges() == {"a": (-2.0, 3.0)}
    tobs.record(torch.tensor([9.0]))  # no recorder: nothing to record
    assert rec.ranges() == {"a": (-2.0, 3.0)}
