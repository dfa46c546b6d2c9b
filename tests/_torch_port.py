"""Shared set-up for the port's CPU tests (tests/test_torch_*.py): one JAX
init per arch (olmo-1b-reduced by default, rwkv6-1.6b-reduced), carried
into the port through the bridge, packed in both packages under the same
spec; and (``seeded_sides``) the same with seeded norm scales and biases,
so that every such leaf is seen to be carried and applied."""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import get_config as jax_get_config
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.launch.serve import ServeConfig as JaxServeConfig
from repro.launch.serve import build_serving_params as jax_build_serving_params
from repro.models import build_model as jax_build_model
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.approx_linear import (LayerStack, QuantizedDense,
                                            QuantizedDenseGroup)
from repro_torch.core.policy import ApproxPolicy
from repro_torch.launch.serve import ServeConfig, build_serving_params
from repro_torch.models import build_model

ARCH = "olmo-1b-reduced"
RWKV_ARCH = "rwkv6-1.6b-reduced"


@functools.lru_cache(maxsize=None)
def jax_side(arch: str = ARCH):
    cfg = jax_get_config(arch)
    api = jax_build_model(cfg)
    return cfg, api, api.init(jax.random.PRNGKey(0))


def torch_side(arch: str = ARCH):
    cfg = get_config(arch)
    _, _, jparams = jax_side(arch)
    flat = dict(_flatten(jparams)[0])
    return cfg, build_model(cfg, "cpu"), from_jax_params(flat, cfg)


def packed_pair(policy: tuple | None, arch: str = ARCH):
    """(jax params, port params) for ``policy`` = (mode, m, use_cv, backend)
    wrapped in serve-default, or None for float."""
    jcfg, _, jparams = jax_side(arch)
    tcfg, _, tparams = torch_side(arch)
    if policy is None:
        return jparams, tparams
    mode, m, use_cv, backend = policy
    jp = jax_build_serving_params(jparams, jcfg, JaxServeConfig(
        policy=JaxPolicy(mode, m, use_cv=use_cv, backend=backend)))
    tp = build_serving_params(tparams, tcfg, ServeConfig(
        policy=ApproxPolicy(mode, m, use_cv=use_cv, backend=backend)),
        device="cpu")
    return jp, tp


@functools.lru_cache(maxsize=None)
def seeded_sides(jcfg, tcfg):
    """(jax api, jax params, port api, port params) for a pair of configs:
    one JAX init whose norm scales and biases (``/scale``, ``/bias``) and
    linear biases (``/b``) get seeded values (they are ones and zeros at
    init), carried across by the bridge."""
    japi = jax_build_model(jcfg)
    items, treedef = _flatten(japi.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    flat = {}
    for key, arr in items:
        if key.endswith("/scale"):
            arr = (1 + 0.2 * rng.standard_normal(arr.shape)).astype(arr.dtype)
        elif key.endswith(("/b", "/bias")):
            arr = (0.1 * rng.standard_normal(arr.shape)).astype(arr.dtype)
        flat[key] = arr
    jparams = jax.tree_util.tree_unflatten(
        treedef, [jax.numpy.asarray(flat[k]) for k, _ in items])
    return japi, jparams, build_model(tcfg, "cpu"), from_jax_params(flat, tcfg)


@functools.lru_cache(maxsize=None)
def seeded_packed(jcfg, tcfg, policy: tuple):
    """The serve-default packs of :func:`seeded_sides`' weights in both
    packages, ``policy`` = (mode, m, use_cv, backend)."""
    _, jparams, _, tparams = seeded_sides(jcfg, tcfg)
    mode, m, use_cv, backend = policy
    jp = jax_build_serving_params(jparams, jcfg, JaxServeConfig(
        policy=JaxPolicy(mode, m, use_cv=use_cv, backend=backend)))
    tp = build_serving_params(tparams, tcfg, ServeConfig(
        policy=ApproxPolicy(mode, m, use_cv=use_cv, backend=backend)),
        device="cpu")
    return jp, tp


def _packs(tree, path=()):
    """(path, packed module) of every pack in a port parameter tree; layer
    stacks give one entry per layer."""
    if isinstance(tree, LayerStack):
        for i in range(len(tree)):
            yield from _packs(tree[i], path + (i,))
    elif isinstance(tree, (QuantizedDense, QuantizedDenseGroup)):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _packs(v, path + (k,))
    elif isinstance(tree, (list, tuple)):  # list nodes: str(index) segments
        for i, v in enumerate(tree):
            yield from _packs(v, path + (str(i),))


def _jax_node(tree, path):
    """The reference's pack at a port path; an integer indexes the layer
    axis of its stacked leaves, a str segment a dict key or list index."""
    layer = None
    for key in path:
        if isinstance(key, int):
            layer = key
        elif isinstance(tree, (list, tuple)):
            tree = tree[int(key)]
        else:
            tree = tree[key]
    return tree, layer


def assert_packs_byte_equal(jax_tree, port_tree) -> set[str]:
    """Every pack of the port tree (fused groups with their members, layer
    by layer, list nodes index by index) byte-equal to the reference's at the same path: the pack's
    codes, quant params, CV constants and bias, and the blocked layout.
    Returns the keys of the fused groups seen ("qkv", "gateup")."""
    seen = set()
    for path, mod in _packs(port_tree):
        jmod, layer = _jax_node(jax_tree, path)
        pairs = [(jmod, mod)]
        if isinstance(mod, QuantizedDenseGroup):
            pairs += list(zip(jmod.members, mod.members))
            seen.add([k for k in path if isinstance(k, str)][-1])
        for jm, tm in pairs:
            for f in ("w_q", "w_scale", "w_zp", "sum_qw", "c", "c0", "bias"):
                want, got = getattr(jm.pack, f), getattr(tm.pack, f)
                assert (want is None) == (got is None), (path, f)
                if want is None:
                    continue
                want = np.asarray(want)
                want = want if layer is None else want[layer]
                assert want.tobytes() == to_np(got).tobytes(), (path, f)
            for f in ("w_qb", "epilogue", "meta"):
                want = np.asarray(getattr(jm.blocked, f))
                want = want if layer is None else want[layer]
                assert want.tobytes() == to_np(getattr(tm.blocked, f)
                                               ).tobytes(), (path, f)
    return seen


def to_np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
