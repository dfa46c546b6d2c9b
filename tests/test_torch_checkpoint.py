"""The port's checkpoint store (``repro_torch.checkpoint``) against the JAX
package's: the counterparts of tests/test_checkpoint.py and of the
checkpoint half of tests/test_numerics_spec.py, shard files byte-identical
between the packages for the same bridged tree and codec, each package
reading the other's shards, the legacy layouts, and the port's own
MessagePack encoder and decoder held to the ``msgpack`` wheel.

Every comparison is exact: leaves bit for bit, shard files and encodings
byte for byte.
"""

import functools
import mmap
import os
import tempfile

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - fallback when wheel absent
    from _hypothesis_fallback import given, settings, st

from repro.checkpoint import manager as jman
from repro.configs.cnn_suite import get_cnn as jax_get_cnn
from repro.nn import cnn as jcnn
from repro.numerics import get_preset as jax_get_preset
from repro.optim import adamw as jadamw
from repro_torch.bridge import _to_tensor, from_jax_cnn_params
from repro_torch.checkpoint import (CheckpointManager, _msgpack, load_pytree,
                                    read_meta, restore_with_sharding,
                                    save_pytree)
from repro_torch.checkpoint import manager as tman
from repro_torch.numerics import get_preset
from repro_torch.optim import adamw as tadamw

from _torch_port import jax_side, torch_side


def _tree(seed=0):
    """tests/test_checkpoint.py's tree in the port's types: float32, a
    bf16 vector, the optimizer's int step."""
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(16, 8, generator=g),
                   "b": torch.randn(8, generator=g).to(torch.bfloat16)},
        "opt": {"step": 7, "m": torch.randn(16, 8, generator=g)},
    }


def _zeros(tree):
    return tadamw.tree_map(
        lambda _, x: torch.zeros_like(x) if isinstance(x, torch.Tensor)
        else 0, tree)


def _assert_tree_equal(a, b):
    fa, fb = list(tman._walk(a)), list(tman._walk(b))
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert type(x) is type(y) and x == y, k


# ---------------------------------------------------------------------------
# the counterparts of tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def test_save_restore_exact():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t = _tree()
        mgr.save(t, 5)
        restored, step = mgr.restore(_zeros(t))
        assert step == 5
        _assert_tree_equal(t, restored)


def test_async_save_and_retention():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        threads = []
        try:
            for s in (1, 2, 3, 4):
                tree = _tree(s)
                mgr.save(tree, s, blocking=False)
                threads.append(mgr._thread)
                # the save copied every leaf before its thread started:
                # changing the caller's tree now changes nothing saved
                tree["params"]["w"].fill_(float("nan"))
        finally:
            for t in threads:
                t.join(10.0)
            mgr.wait()
        assert len(threads) == 4 and not any(t.is_alive() for t in threads)
        mgr.save(_tree(5), 5)  # triggers gc
        assert mgr.steps() == [4, 5]
        restored, step = mgr.restore(_zeros(_tree()))
        assert step == 5
        _assert_tree_equal(_tree(5), restored)
        restored, step = mgr.restore(_zeros(_tree()), 4)
        _assert_tree_equal(_tree(4), restored)


def test_crash_consistency_ignores_incomplete():
    """A step dir without the DONE marker (crash mid-commit) is invisible."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(_tree(1), 1)
        broken = os.path.join(d, "step_0000000002")
        os.makedirs(broken)
        save_pytree(_tree(2), os.path.join(broken, "shard_00000.ckpt"))
        assert mgr.latest_step() == 1
        restored, step = mgr.restore(_zeros(_tree()))
        assert step == 1
        _assert_tree_equal(_tree(1), restored)


def test_shape_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.ckpt")
        save_pytree({"w": torch.zeros(4, 4, dtype=torch.float64)}, path)
        with pytest.raises(ValueError):
            load_pytree({"w": torch.zeros(5, 4)}, path)
        with pytest.raises(KeyError, match="missing leaf"):
            load_pytree({"v": torch.zeros(4, 4)}, path)
        # the template's dtype wins, as the reference's astype
        got = load_pytree({"w": torch.ones(4, 4)}, path)["w"]
        assert got.dtype == torch.float32 and not got.any()


# ---------------------------------------------------------------------------
# the checkpoint half of tests/test_numerics_spec.py
# ---------------------------------------------------------------------------


def test_checkpoint_persists_numerics_spec():
    spec = get_preset("int8")
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(tree, 3, numerics=spec)
        restored, step = mgr.restore(_zeros(tree))
        assert step == 3
        assert torch.equal(restored["w"], tree["w"])
        assert mgr.numerics() == spec
        meta = read_meta(os.path.join(d, "step_0000000003",
                                      "shard_00000.ckpt"))
        assert meta["numerics"]["name"] == "int8"
        mgr.save(tree, 4)
        assert mgr.numerics(4) is None


def test_save_pytree_meta_reserved_key():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="reserved"):
            save_pytree({"w": torch.zeros(2)}, os.path.join(d, "x.ckpt"),
                        meta={"codec": "zstd"})


# ---------------------------------------------------------------------------
# one format for both packages
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _bridged_trees():
    """The same tree in both packages: olmo-1b-reduced's float32
    parameters with AdamW's state (JAX's int32 step, the port's int), a
    resnet44's list-valued parameters, a bf16 leaf and an int32 vector.
    The port's side is carried across by repro_torch.bridge."""
    jcfg, _, jparams = jax_side()
    jcnn_p = jcnn.init_cnn(jax.random.PRNGKey(0), jax_get_cnn("resnet44"))
    rng = np.random.default_rng(3)
    b16 = jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16)
    ids = np.arange(6, dtype=np.int32)
    jtree = {"state": {"params": jparams,
                       "opt": jadamw.adamw_init(jparams,
                                                jadamw.AdamWConfig())},
             "cnn": jcnn_p, "extra": {"b16": b16, "ids": ids}}
    tcfg, _, tparams = torch_side()
    ttree = {"state": {"params": tparams,
                       "opt": tadamw.adamw_init(tparams,
                                                tadamw.AdamWConfig())},
             "cnn": from_jax_cnn_params(dict(jman._flatten(jcnn_p)[0])),
             "extra": {"b16": _to_tensor(np.asarray(b16), "cpu"),
                       "ids": torch.from_numpy(ids.copy())}}
    assert isinstance(ttree["cnn"]["stages"], list)
    return jtree, ttree


@pytest.mark.parametrize("codec", ["none", "zlib"])
@pytest.mark.parametrize("with_spec", [False, True])
def test_shards_byte_identical_to_reference(codec, with_spec, tmp_path):
    jtree, ttree = _bridged_trees()
    jmeta = ({"numerics": jax_get_preset("serve-default").to_dict()}
             if with_spec else None)
    tmeta = ({"numerics": get_preset("serve-default").to_dict()}
             if with_spec else None)
    jman.save_pytree(jtree, str(tmp_path / "j.ckpt"), codec=codec, meta=jmeta)
    save_pytree(ttree, str(tmp_path / "t.ckpt"), codec=codec, meta=tmeta)
    want = (tmp_path / "j.ckpt").read_bytes()
    assert (tmp_path / "t.ckpt").read_bytes() == want
    keys = [k for k, _ in jman._flatten(jtree)[0]]
    assert any(k.startswith("cnn/stages/0/0/") for k in keys)
    assert "state/opt/step" in keys and "extra/b16" in keys


def test_each_package_reads_the_others_shards(tmp_path):
    jtree, ttree = _bridged_trees()
    # the reference's shard into the port (a meta template, placed on the
    # CPU), and the port's into the reference
    jman.save_pytree(jtree, str(tmp_path / "j.ckpt"), codec="zlib")
    meta_t = tadamw.tree_map(
        lambda _, x: x.to("meta") if isinstance(x, torch.Tensor) else x, ttree)
    placement = tadamw.tree_map(lambda _, x: torch.device("cpu"), ttree)
    got = load_pytree(meta_t, str(tmp_path / "j.ckpt"), placement)
    _assert_tree_equal(ttree, got)
    assert got["state"]["opt"]["step"] == 0
    save_pytree(ttree, str(tmp_path / "t.ckpt"), codec="zlib")
    back = jman.load_pytree(jtree, str(tmp_path / "t.ckpt"))
    for (k, a), (_, b) in zip(jman._flatten(jtree)[0],
                              jman._flatten(back)[0]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    # a managed step written by the reference restores in the port
    jm = jman.CheckpointManager(str(tmp_path / "run"))
    jm.save(jtree, 9, numerics=jax_get_preset("int8"))
    mgr = CheckpointManager(str(tmp_path / "run"))
    assert mgr.steps() == [9] and mgr.numerics() == get_preset("int8")
    got, step = mgr.restore(ttree)
    assert step == 9
    _assert_tree_equal(ttree, got)


def test_restore_with_sharding_places_leaves(tmp_path):
    """The placement tree decides each leaf's device; the template's
    (``meta``: nothing allocated) does not.  The reference's re-mesh
    onto 8 devices waits for the distributed slice."""
    tree = _tree(3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(tree, 2)
    meta_t = tadamw.tree_map(
        lambda _, x: x.to("meta") if isinstance(x, torch.Tensor) else x, tree)
    placement = tadamw.tree_map(lambda _, x: torch.device("cpu"), tree)
    got, step = restore_with_sharding(mgr, meta_t, placement)
    assert step == 2
    assert all(x.device.type == "cpu" for _, x in tman._walk(got)
               if isinstance(x, torch.Tensor))
    _assert_tree_equal(tree, got)


def test_legacy_layouts_and_missing_zstd(tmp_path, monkeypatch):
    """A headerless MessagePack shard (leaves at the top level) and a
    headerless zstd frame read back; a zstd shard without the wheel
    raises the reference's message."""
    items, _ = jman._flatten({"w": np.arange(6, dtype=np.float32),
                              "b16": jnp.ones((2,), jnp.bfloat16)})
    leaves = {k: {"dtype": str(a.dtype), "shape": list(a.shape),
                  "data": a.tobytes()} for k, a in items}
    raw = msgpack.packb(leaves, use_bin_type=True)
    tmpl = {"w": torch.zeros(6), "b16": torch.zeros(2, dtype=torch.bfloat16)}
    want = {"w": torch.arange(6, dtype=torch.float32),
            "b16": torch.ones(2, dtype=torch.bfloat16)}
    (tmp_path / "plain.ckpt").write_bytes(raw)
    _assert_tree_equal(want, load_pytree(tmpl, str(tmp_path / "plain.ckpt")))
    assert read_meta(str(tmp_path / "plain.ckpt")) == {}
    zstandard = pytest.importorskip("zstandard")
    (tmp_path / "old.ckpt").write_bytes(
        zstandard.ZstdCompressor(level=3).compress(raw))
    _assert_tree_equal(want, load_pytree(tmpl, str(tmp_path / "old.ckpt")))
    jman.save_pytree({"w": np.zeros(2, np.float32)}, str(tmp_path / "z.ckpt"),
                     codec="zstd")
    monkeypatch.setattr(tman, "zstandard", None)
    monkeypatch.setattr(jman, "zstandard", None)
    with pytest.raises(RuntimeError) as want_err:
        jman.load_pytree({"w": np.zeros(2, np.float32)},
                         str(tmp_path / "z.ckpt"))
    with pytest.raises(RuntimeError) as got_err:
        load_pytree({"w": torch.zeros(2)}, str(tmp_path / "z.ckpt"))
    assert str(got_err.value) == str(want_err.value)
    assert "zstandard is not installed" in str(got_err.value)
    with pytest.raises(RuntimeError, match="legacy zstd"):
        load_pytree(tmpl, str(tmp_path / "old.ckpt"))
    assert tman._default_codec() == "zlib"


def test_leaf_of_4gib_refused(tmp_path):
    """bin32 holds at most 2**32 - 1 bytes: a 4 GiB leaf is refused before
    anything is written, as the wheel refuses it.  (Virtual memory only:
    neither buffer is touched.)"""
    big = torch.empty(2**32, dtype=torch.uint8)
    with pytest.raises(ValueError, match="too large"):
        save_pytree({"w": big}, str(tmp_path / "x.ckpt"))
    assert not os.listdir(tmp_path)
    with mmap.mmap(-1, 2**32) as m:
        with memoryview(m) as mv:
            with pytest.raises(ValueError):
                msgpack.packb(mv, use_bin_type=True)
            with pytest.raises(ValueError, match="too large"):
                _msgpack.packb(mv)
    del big


# ---------------------------------------------------------------------------
# the port's MessagePack against the wheel
# ---------------------------------------------------------------------------

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**63, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
        -2**31, -2**31 - 1, -2**63]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 4095, 4096, 65535, 65536, 70000]
FLOATS = [0.0, -0.0, 1.5, -2.25, 1e308, 5e-324, float("inf"), float("-inf"),
          float("nan")]


def _wheel(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _plain(obj):
    """Our decoded object with memoryviews as bytes (the wheel's bins)."""
    if isinstance(obj, memoryview):
        return bytes(obj)
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def _boundary_cases():
    yield from INTS
    yield from FLOATS
    yield from (True, False, None)
    for n in LENGTHS:
        yield "a" * n
        yield "é" * (n // 2)  # two bytes a character
        yield b"\x01" * n
        yield bytearray(b"\x02" * n)
        yield memoryview((np.arange(n) % 251).astype(np.uint8))
        yield list(range(n))
        yield tuple([None] * n)
        yield {f"k{i}": i for i in range(n)}


BOUNDARY_CASES = list(_boundary_cases())


@pytest.mark.parametrize("case", range(len(BOUNDARY_CASES)))
def test_msgpack_encoder_at_every_width_boundary(case):
    obj = BOUNDARY_CASES[case]
    want = _wheel(obj)
    assert _msgpack.packb(obj) == want
    parts = []
    _msgpack.pack_to(obj, parts.append)
    assert b"".join(bytes(p) for p in parts) == want
    got = _plain(_msgpack.unpackb(want))
    ref = msgpack.unpackb(want, raw=False, strict_map_key=False)
    if isinstance(obj, float) and obj != obj:
        assert got != got and ref != ref
    else:
        assert got == ref


def _random_obj(rng: np.random.Generator, depth: int = 0):
    kind = int(rng.integers(0, 9 if depth < 3 else 6))
    if kind == 0:
        v = INTS[int(rng.integers(len(INTS)))] + int(rng.integers(-2, 3))
        return min(max(v, -2**63), 2**64 - 1)
    if kind == 1:
        return float(rng.standard_normal() * 10.0 ** rng.integers(-300, 300))
    if kind == 2:
        return [True, False, None][int(rng.integers(0, 3))]
    if kind == 3:
        n = int(rng.choice(LENGTHS[:9]))
        return "".join(rng.choice(list("abé€ x"), n))
    if kind in (4, 5):
        n = int(rng.choice(LENGTHS))
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 6:
        return [_random_obj(rng, depth + 1)
                for _ in range(int(rng.choice([0, 1, 3, 15, 16, 20])))]
    if kind == 7:
        return {f"k{i}": _random_obj(rng, depth + 1)
                for i in range(int(rng.choice([0, 1, 3, 15, 16, 20])))}
    return {"dtype": "float32", "shape": [int(rng.integers(0, 9))],
            "data": rng.standard_normal(int(rng.integers(0, 700))).astype(
                np.float32).tobytes()}


@settings(max_examples=150, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_msgpack_matches_wheel_on_random_trees(seed):
    obj = _random_obj(np.random.default_rng(seed))
    want = _wheel(obj)
    assert _msgpack.packb(obj) == want
    assert _msgpack.packb(_msgpack.unpackb(want)) == want
    got = _plain(_msgpack.unpackb(want))
    assert _msgpack.packb(got) == _wheel(
        msgpack.unpackb(want, raw=False, strict_map_key=False))


def test_msgpack_decoder_equals_wheel_on_reference_shards():
    """The reference's shard payloads (meta with a NumericsSpec, float32,
    bf16 and int32 leaves) decode to the wheel's objects."""
    jtree, _ = _bridged_trees()
    meta = {"numerics": jax_get_preset("serve-default").to_dict()}
    blob = jman._pack(jman._flatten(jtree)[0], "none", meta)
    raw = blob[8:]
    assert _plain(_msgpack.unpackb(raw)) == msgpack.unpackb(raw, raw=False)
    assert _plain(tman._decode(blob)) == jman._decode(blob)
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(raw[:-1])
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(raw + b"\xc0")
