"""The port's sharding rules (``repro_torch.parallel``) against the
reference's (``repro.parallel.sharding``) on a (2, 2) ("data", "model")
mesh.

The reference side runs in one subprocess with 4 XLA host devices (as
``tests/test_sharding_dryrun.py`` does) and hands back, for every leaf of
every tree, its path string, shape, PartitionSpec and the index each mesh
coordinate's device holds (``NamedSharding.devices_indices_map``).  The
port side needs no process group: its rules run on an abstract mesh, and
``local_slices`` is the function a rank takes its piece with, evaluated at
every coordinate.

Trees: olmo-1b, qwen3-4b, deepseek-v2-lite-16b, rwkv6-1.6b and hymba-1.5b
(reduced), float (plain, ``fsdp``, ``dp_only``) and packed
``serve-default`` on both backends (jnp: plain and ``dp_only``; pallas:
plain and ``fsdp``); their batches (tokens, labels, M-RoPE positions) and
decode caches.  Every leaf path equals the reference's, the port's
K-major ``blocked/w_qbt`` standing for the reference's ``blocked/w_qb``.
A ``LayerStack`` layer's leaf is compared as its layer of the reference's
stacked leaf.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.policy import ApproxPolicy
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.serve import ServeConfig, build_serving_params
from repro_torch.models import build_model
from repro_torch.parallel import (P, batch_shardings, cache_shardings,
                                  fit_spec, local_slices, param_shardings)
from repro_torch.parallel import sharding as tsh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["olmo-1b", "qwen3-4b", "deepseek-v2-lite-16b", "rwkv6-1.6b",
         "hymba-1.5b"]
#: (variant, backend or None for float, fsdp, dp_only)
VARIANTS = [("float", None, False, False), ("float-fsdp", None, True, False),
            ("float-dp_only", None, False, True),
            ("jnp", "jnp", False, False),
            ("jnp-dp_only", "jnp", False, True),
            ("pallas", "pallas", False, False),
            ("pallas-fsdp", "pallas", True, False)]
MESH = AbstractMesh((2, 2), ("data", "model"))

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.policy import ApproxPolicy
    from repro.launch.mesh import make_test_mesh
    from repro.launch.serve import ServeConfig, build_serving_params
    from repro.models import build_model
    from repro.parallel.sharding import (_path_str, batch_shardings,
                                         cache_shardings, param_shardings)

    ARCHS, VARIANTS = json.loads(sys.argv[1])
    mesh = make_test_mesh((2, 2), ("data", "model"))
    coords = {int(d.id): [int(i), int(j)]
              for i, row in enumerate(mesh.devices) for j, d in
              enumerate(row)}

    def records(tree, shardings):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        out = {}
        for (path, leaf), sh in zip(flat, jax.tree_util.tree_leaves(
                shardings)):
            shape = tuple(leaf.shape)
            idx = {}
            for dev, ix in sh.devices_indices_map(shape).items():
                idx[str(coords[int(dev.id)])] = [
                    list(s.indices(n))[:2] for s, n in zip(ix, shape)]
            spec = [(e[0] if len(e) == 1 else list(e))
                    if isinstance(e, tuple) else e for e in sh.spec]
            out[_path_str(path)] = {"shape": list(shape), "spec": spec,
                                    "idx": idx}
        return out

    res = {}
    for arch in ARCHS:
        cfg = get_config(arch + "-reduced")
        api = build_model(cfg)
        init = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))
        for name, backend, fsdp, dp_only in VARIANTS:
            if backend is None:
                tree = init
            else:
                scfg = ServeConfig(policy=ApproxPolicy(
                    "perforated", 2, use_cv=True, backend=backend))
                tree = jax.eval_shape(lambda: build_serving_params(
                    api.init(jax.random.PRNGKey(0)), cfg, scfg))
            res[f"{arch}/{name}"] = records(tree, param_shardings(
                tree, mesh, cfg, fsdp=fsdp, dp_only=dp_only))
        cache = jax.eval_shape(lambda: api.init_cache(4, 16, jnp.bfloat16))
        res[f"{arch}/cache"] = records(cache, cache_shardings(cache, mesh,
                                                              cfg))
    batch = {"tokens": jax.ShapeDtypeStruct((4, 16), jnp.int32),
             "labels": jax.ShapeDtypeStruct((4, 16), jnp.int32),
             "positions": jax.ShapeDtypeStruct((3, 4, 16), jnp.int32),
             "odd": jax.ShapeDtypeStruct((3, 5), jnp.float32)}
    for dp_only in (False, True):
        res[f"batch/{dp_only}"] = records(batch, batch_shardings(
            batch, mesh, dp_only=dp_only))
    print("REF_JSON" + json.dumps(res))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, json.dumps([ARCHS, VARIANTS])],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=560)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines()
                if x.startswith("REF_JSON"))
    return json.loads(line[len("REF_JSON"):])


def _spec_list(spec) -> list:
    """A spec as JSON, an entry of one axis as its name (JAX writes
    P(("data",)) as P("data"))."""
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, (tuple, list))
            else e for e in spec]


def _port_records(tree, spec_fn) -> dict:
    """{reference path: {"shape", "spec", "idx", "layers"}} of a port tree:
    a LayerStack's layers as one stacked leaf, each layer's spec checked
    against the stacked one with its layer dim dropped."""
    out: dict = {}
    for path, leaf, stack in tsh.leaf_paths(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        full = shape if stack is None else (stack[0],) + shape
        spec = spec_fn(path, full)
        rec = out.setdefault(path, {"shape": list(full),
                                    "spec": _spec_list(spec), "layers": 0})
        assert rec["spec"] == _spec_list(spec), path
        rec["layers"] += 1
        padded = tuple(spec) + (None,) * (len(full) - len(spec))
        idx = {}
        for c in range(MESH.size):
            coord = MESH.coords(c)
            sl = local_slices(P(*padded), full, MESH, coord)
            idx[str([coord["data"], coord["model"]])] = [
                [s.start, s.stop] for s in sl]
        rec["idx"] = idx
    return out


def _float_tree(arch: str):
    return build_model(get_config(arch + "-reduced"), "meta").init(0)


def _packed_tree(arch: str, backend: str):
    cfg = get_config(arch + "-reduced")
    return build_serving_params(
        _float_tree(arch), cfg, ServeConfig(policy=ApproxPolicy(
            "perforated", 2, use_cv=True, backend=backend)), device="meta")


def _per_layer_specs_match(tree, specs, spec_fn) -> None:
    """param_shardings' spec of every LayerStack layer is the stacked
    spec with the layer dim dropped."""
    flat = {}

    def collect(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                collect(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                collect(v, path + (i,))
        else:
            flat.setdefault(len(flat), node)

    collect(specs)
    got = list(flat.values())
    want = []
    for path, leaf, stack in tsh.leaf_paths(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        full = shape if stack is None else (stack[0],) + shape
        want.append(tsh._per_layer(spec_fn(path, full), stack))
    assert len(got) == len(want)
    assert all(tuple(g) == tuple(w) for g, w in zip(got, want))


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_paths_specs_and_slices_equal_reference(reference, arch,
                                                      variant):
    name, backend, fsdp, dp_only = variant
    tree = (_float_tree(arch) if backend is None
            else _packed_tree(arch, backend))

    def spec_fn(path, shape):
        return tsh.param_spec(path, shape, MESH, fsdp, dp_only)

    got = _port_records(tree, spec_fn)
    want = reference[f"{arch}/{name}"]
    renamed = {p.replace("blocked/w_qbt", "blocked/w_qb"): p for p in got}
    assert set(renamed) == set(want)
    for ref_path, path in renamed.items():
        g, w = got[path], want[ref_path]
        if path.endswith("blocked/w_qbt"):
            # the port's K-major codes: the reference's out-dim sharding on
            # the other dim (both padded to tile multiples)
            assert g["spec"][-2] == w["spec"][-1] or (
                g["spec"][-2] is None or w["spec"][-1] is None), path
            assert g["spec"][-1] is None and w["spec"][-2] is None, path
            continue
        assert g["shape"] == w["shape"], path
        assert g["spec"] == w["spec"], (path, g["spec"], w["spec"])
        assert g["idx"] == w["idx"], path
    _per_layer_specs_match(tree, param_shardings(
        tree, MESH, fsdp=fsdp, dp_only=dp_only), spec_fn)


def test_w_qbt_keeps_the_out_sharding_where_the_padding_allows(reference):
    """The K-major codes shard their dim 0 (the out dim) wherever the
    reference's w_qb shards its out dim and the port's padded N divides;
    on the reduced archs the two paddings agree on every leaf."""
    tree = _packed_tree("qwen3-4b", "pallas")
    want = reference["qwen3-4b/pallas"]
    sharded = 0
    for path, leaf, stack in tsh.leaf_paths(tree):
        if not path.endswith("blocked/w_qbt"):
            continue
        full = (stack[0],) + tuple(leaf.shape) if stack else tuple(
            leaf.shape)
        spec = tsh.param_spec(path, full, MESH)
        ref = want[path.replace("w_qbt", "w_qb")]["spec"]
        assert spec[-2] == ref[-1], path
        sharded += spec[-2] is not None
    assert sharded > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_and_slices_equal_reference(reference, arch):
    cfg = get_config(arch + "-reduced")
    cache = build_model(cfg, "meta").init_cache(4, 16, torch.bfloat16)
    got = _port_records(cache, lambda path, shape: tsh.cache_spec(
        path, shape, MESH, cfg))
    want = reference[f"{arch}/cache"]
    assert set(got) == set(want)
    for path in want:
        assert got[path]["spec"] == want[path]["spec"], path
        assert got[path]["idx"] == want[path]["idx"], path
    assert list(cache_shardings(cache, MESH, cfg)) == list(cache)


@pytest.mark.parametrize("dp_only", [False, True])
def test_batch_specs_and_slices_equal_reference(reference, dp_only):
    batch = {"tokens": torch.empty(4, 16, device="meta"),
             "labels": torch.empty(4, 16, device="meta"),
             "positions": torch.empty(3, 4, 16, device="meta"),
             "odd": torch.empty(3, 5, device="meta")}
    got = _port_records(batch, lambda path, shape: tsh.batch_spec(
        path, shape, MESH, dp_only))
    want = reference[f"batch/{dp_only}"]
    assert set(got) == set(want)
    for path in want:
        assert got[path]["spec"] == want[path]["spec"], path
        assert got[path]["idx"] == want[path]["idx"], path
    specs = batch_shardings(batch, MESH, dp_only=dp_only)
    assert {k: tuple(v) for k, v in specs.items()} == {
        k: tuple(tsh.batch_spec(k, tuple(v.shape), MESH, dp_only))
        for k, v in batch.items()}


def test_fit_spec_drops_indivisible():
    mesh = AbstractMesh((16, 16), ("data", "model"))
    assert fit_spec(P("model", None), (32001, 64), mesh) == P(None, None)
    assert fit_spec(P("model", None), (32000, 64), mesh) == P("model", None)
    assert fit_spec(P(("data", "model")), (128,), mesh) == P(None)
    assert fit_spec(P(("data", "model")), (256,), mesh) == P(
        ("data", "model"))
