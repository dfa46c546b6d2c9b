"""Tensor-store checkpointing (port of ``repro.checkpoint.manager``):
MessagePack shards, optional compression, atomic renames, async saves.

Layout:  <dir>/step_<N>/shard_<process>.ckpt  +  <dir>/step_<N>/DONE
A shard file holds the full value of every leaf; ``<process>`` is the
``torch.distributed`` rank when a process group is up, else 0.  The commit
protocol is the reference's: the shard is written to a tmp file, fsynced
and renamed; the tmp step directory is renamed; then DONE is written.
Restores pick the newest step with DONE, so a crash mid-save never
corrupts the restore point.

The shard format is the reference's, byte for byte: ``RPK1`` plus a
4-character codec tag ("zstd" | "zlib" | "none"), then the (compressed)
MessagePack payload ``{"__meta__": {"codec": ..., **meta}, "leaves":
{path: {"dtype", "shape", "data"}}}``.  Leaf paths are dict keys and list
indices joined by "/", in JAX's flatten order (dict keys sorted, lists by
index), so the same tree gives the same file from either package, and
each reads the other's.  The encoder is the port's own
(:mod:`._msgpack`); ``zstandard`` is used where it is installed, as the
reference uses it, and otherwise zlib is the default.  bfloat16 leaves
are stored as their raw 2-byte words under the dtype string
``"bfloat16"`` (numpy needs no bfloat16 type for it).  A Python int leaf
(the optimizer's ``step``) is stored as an int32 scalar, as JAX's step
is, and restored into an int.  Headerless legacy files stay readable.
"""

from __future__ import annotations

import mmap
import os
import shutil
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

try:  # optional: best ratio/speed, but not baked into every container
    import zstandard
except ImportError:  # pragma: no cover - exercised where the wheel is absent
    zstandard = None

#: shard-file header: magic + 4-char codec tag, then the compressed payload
_MAGIC = b"RPK1"
_ZSTD_FRAME_MAGIC = b"\x28\xb5\x2f\xfd"  # legacy headerless files

#: numpy dtype names as the shard stores them <-> torch dtypes
_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _default_codec() -> str:
    return "zstd" if zstandard is not None else "zlib"


def _process_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _walk(tree: Any, path: str = ""):
    """(path, leaf) in JAX's flatten order: dict keys sorted, lists and
    tuples by index, None an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}" if path else str(i))
    elif tree is not None:
        yield path, tree


def _rebuild(tree: Any, leaves):
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves`` (in :func:`_walk`'s order)."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}  # the template's key order
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return None if tree is None else next(leaves)


def _host_leaf(leaf: Any, copy: bool = False):
    """A leaf as host memory: a contiguous CPU tensor, a numpy array, or
    an int32 scalar for a Python int.  ``copy`` copies CPU data too."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype not in _DTYPE_NAMES:
            raise TypeError(f"no checkpoint dtype for {t.dtype}")
        if t.device.type != "cpu":
            return t.to("cpu").contiguous()
        return t.clone(memory_format=torch.contiguous_format) if copy \
            else t.contiguous()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(np.int32(leaf))
    arr = np.asarray(leaf)
    return np.array(arr, order="C") if copy else np.ascontiguousarray(arr)


def _record(host) -> dict:
    """The shard's record of one host leaf; ``data`` is a byte view of the
    leaf's memory, not a copy."""
    if isinstance(host, torch.Tensor):
        name = _DTYPE_NAMES[host.dtype]
        data = host.reshape(-1).view(torch.uint8).numpy()
    else:
        name = str(host.dtype)
        data = host.reshape(-1).view(np.uint8)
    if data.nbytes >= _msgpack.MAX_LEN:
        raise ValueError(f"a {data.nbytes}-byte leaf is too large for one "
                         "MessagePack bin (4 GiB at most)")
    return {"dtype": name, "shape": list(host.shape),
            "data": memoryview(data)}


class _Compressor:
    """The body writer for one codec: ``write(chunk)`` then ``finish()``
    give what the reference's one-shot compress of the whole payload
    gives."""

    def __init__(self, codec: str, out) -> None:
        self.out = out
        if codec == "zstd":
            if zstandard is None:
                raise RuntimeError(
                    "codec 'zstd' requested but zstandard is not installed")
            self._c = zstandard.ZstdCompressor(level=3)
            self._parts: list | None = []  # a one-shot frame, as reference
        elif codec == "zlib":
            self._c, self._parts = zlib.compressobj(3), None
        elif codec == "none":
            self._c, self._parts = None, None
        else:
            raise ValueError(f"unknown checkpoint codec {codec!r}")

    def write(self, chunk) -> None:
        if self._parts is not None:
            self._parts.append(bytes(chunk))
        elif self._c is None:
            self.out.write(chunk)
        else:
            self.out.write(self._c.compress(chunk))

    def finish(self) -> None:
        if self._parts is not None:
            self.out.write(self._c.compress(b"".join(self._parts)))
        elif self._c is not None:
            self.out.write(self._c.flush())


def _payload(items: list[tuple[str, Any]], codec: str | None,
             meta: dict | None) -> tuple[str, dict]:
    """(codec, the MessagePack payload); the codec tag rides in the
    metadata too, as the reference's does."""
    codec = codec or _default_codec()
    return codec, {"__meta__": {"codec": codec, **(meta or {})},
                   "leaves": {key: _record(host) for key, host in items}}


def _write_shard(out, codec: str, payload: dict) -> None:
    comp = _Compressor(codec, out)
    out.write(_MAGIC + codec.encode("ascii").ljust(4))
    _msgpack.pack_to(payload, comp.write)
    comp.finish()


def _decode(blob) -> dict:
    """Shard bytes -> the decoded payload (meta + leaves; each leaf's data
    a memoryview into a writable buffer)."""
    blob = memoryview(blob)
    if blob[:4] == _MAGIC:
        codec = bytes(blob[4:8]).rstrip().decode("ascii")
        body = blob[8:]
        if codec == "zstd":
            if zstandard is None:
                raise RuntimeError(
                    "checkpoint was written with zstd but zstandard is not "
                    "installed; re-save with codec='zlib' or install the "
                    "wheel")
            raw = bytearray(zstandard.ZstdDecompressor().decompress(body))
        elif codec == "zlib":
            raw = bytearray(zlib.decompress(body))
        elif codec == "none":
            raw = body
        else:
            raise ValueError(f"unknown checkpoint codec {codec!r}")
    elif blob[:4] == _ZSTD_FRAME_MAGIC:  # pre-header files (always zstd)
        if zstandard is None:
            raise RuntimeError(
                "legacy zstd checkpoint but zstandard is not installed")
        raw = bytearray(zstandard.ZstdDecompressor().decompress(blob))
    else:  # pre-header uncompressed msgpack
        raw = blob
    payload = _msgpack.unpackb(raw)
    if "__meta__" not in payload:  # pre-header layout: leaves at top level
        payload = {"__meta__": {}, "leaves": payload}
    return payload


def _read(path: str):
    """A shard file as a writable buffer: a private (copy-on-write) map,
    so a page is read only when a leaf's bytes are copied out of it and
    :func:`read_meta` of an uncompressed shard reads its headers alone."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            return bytearray()
        return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)


def _to_tensor(rec: dict, device, dtype: torch.dtype | None) -> torch.Tensor:
    """A stored leaf as a tensor on ``device``: its bytes copied once into
    fresh (aligned) memory there, viewed as the stored dtype (bfloat16
    through its 2-byte words), cast to ``dtype``."""
    name = rec["dtype"]
    if name not in _TORCH_DTYPES:
        raise TypeError(f"checkpoint dtype {name!r} has no torch dtype")
    data = rec["data"]
    out = torch.empty(len(data), dtype=torch.uint8, device=device)
    if len(data):
        out.copy_(torch.frombuffer(data, dtype=torch.uint8))
    t = out.view(_TORCH_DTYPES[name]).reshape(rec["shape"])
    return t if dtype is None else t.to(dtype)


def read_meta(path: str) -> dict:
    """Shard metadata (codec tag plus anything save_pytree attached, e.g.
    ``{"numerics": <NumericsSpec dict>}``).  Needs no template tree, but
    does decompress/decode the shard to reach the header."""
    return _decode(_read(path))["__meta__"]


def _save_host(items: list[tuple[str, Any]], path: str, codec: str | None,
               meta: dict | None) -> None:
    codec, payload = _payload(items, codec, meta)  # refuses before writing
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _write_shard(f, codec, payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_pytree(tree: Any, path: str, codec: str | None = None,
                meta: dict | None = None) -> None:
    """Atomic single-file save (library-level; the manager adds steps and
    async saves).

    ``codec`` is "zstd" | "zlib" | "none"; the default prefers zstd when
    the wheel is installed and falls back to stdlib zlib otherwise.
    ``meta`` is an optional JSON-safe dict stored in the shard header
    (recovered by :func:`read_meta`); "codec" is a reserved key.  Leaves
    are tensors (on any device), numpy arrays or scalars, and Python ints.
    """
    if meta and "codec" in meta:
        raise ValueError("'codec' is a reserved metadata key")
    _save_host([(key, _host_leaf(leaf)) for key, leaf in _walk(tree)],
               path, codec, meta)


def load_pytree(template: Any, path: str, placement: Any = None) -> Any:
    """Load into the structure of ``template`` (shapes verified).  Each
    leaf takes its template leaf's dtype and device (a tensor) or type (a
    Python int, float or bool); ``placement``, a tree of ``torch.device``
    of the template's structure, overrides the devices (a ``meta``
    template then allocates nothing before the load)."""
    stored = _decode(_read(path))["leaves"]
    devices = (dict(_walk(placement)) if placement is not None else {})
    leaves = []
    for key, leaf in _walk(template):
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        rec = stored[key]
        want = tuple(getattr(leaf, "shape", ()))
        if tuple(rec["shape"]) != want:
            raise ValueError(f"{key}: checkpoint {tuple(rec['shape'])} != "
                             f"template {want}")
        if isinstance(leaf, torch.Tensor):
            leaves.append(_to_tensor(rec, devices.get(key, leaf.device),
                                     leaf.dtype))
        elif isinstance(leaf, (bool, int, float)):
            leaves.append(type(leaf)(_to_tensor(rec, "cpu", None).item()))
        else:
            raise TypeError(f"{key}: a template leaf is a tensor or a "
                            f"Python scalar, not {type(leaf).__name__}")
    return _rebuild(template, iter(leaves))


class CheckpointManager:
    """Step-scoped checkpoints with retention, async commit, and resume."""

    def __init__(self, directory: str, keep: int = 3,
                 codec: str | None = None) -> None:
        """``codec`` is the shards' (``save_pytree``'s; None: its
        default)."""
        self.dir = directory
        self.keep = keep
        self.codec = codec
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- paths ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _shard_path(self, step: int, index: int | None = None) -> str:
        """This process's shard file of ``step`` (or shard ``index``'s)."""
        index = _process_index() if index is None else index
        return os.path.join(self._step_dir(step), f"shard_{index:05d}.ckpt")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, "DONE")
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ----------------------------------------------------------------

    def _save_sync(self, items: list, step: int, meta: dict | None,
                   index: int | None = None) -> None:
        sdir = self._step_dir(step)
        tmp_dir = sdir + ".tmp"
        index = _process_index() if index is None else index
        shutil.rmtree(tmp_dir, ignore_errors=True)
        os.makedirs(tmp_dir, exist_ok=True)
        _save_host(items, os.path.join(
            tmp_dir, f"shard_{index:05d}.ckpt"), self.codec, meta)
        os.replace(tmp_dir, sdir)
        with open(os.path.join(sdir, "DONE"), "w") as f:
            f.write(str(time.time()))
        self._gc()

    def save(self, tree: Any, step: int, blocking: bool = True,
             numerics: Any = None, shardings: Any = None,
             mesh=None) -> None:
        """``numerics`` (a NumericsSpec, or its dict form) is persisted in
        the shard metadata so a packed serving checkpoint carries the exact
        per-layer approximation recipe it was built under.  Every leaf is
        copied to host memory here, in the caller's thread (CPU tensors
        too), so the caller may change or free the tree at once.

        A sharded tree (this rank's pieces, ``shardings`` their spec tree
        on ``mesh``) is saved as the whole tree: every leaf gathered whole
        on every rank (a collective: every rank calls), rank 0 writing
        shard 0 with the same bytes the unsharded tree writes, then a
        barrier; the save is then blocking."""
        if shardings is not None:
            from repro_torch.parallel.sharding import tree_gather

            full = tree_gather(tree, shardings, mesh)
            if mesh.rank == 0:
                self.save(full, step, numerics=numerics)
            torch.distributed.barrier(group=mesh.group(mesh.axis_names))
            return
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        meta = None
        if numerics is not None:
            spec_d = numerics.to_dict() if hasattr(numerics, "to_dict") \
                else dict(numerics)
            meta = {"numerics": spec_d}
        items = [(key, _host_leaf(leaf, copy=True))
                 for key, leaf in _walk(tree)]
        if blocking:
            self._save_sync(items, step, meta)
            return
        self.wait()

        def run():
            try:
                self._save_sync(items, step, meta)
            except BaseException as e:  # surfaced on next save()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def _resolve(self, step: int | None) -> int:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {self.dir}")
        return step

    def restore(self, template: Any, step: int | None = None,
                placement: Any = None,
                index: int | None = None) -> tuple[Any, int]:
        """The tree of ``step`` (default: the latest) from this process's
        shard (or shard ``index``'s)."""
        step = self._resolve(step)
        return load_pytree(template, self._shard_path(step, index),
                           placement), step

    def numerics(self, step: int | None = None):
        """The NumericsSpec persisted with a step (None when the checkpoint
        was saved without one)."""
        step = self._resolve(step)
        spec_d = read_meta(self._shard_path(step)).get("numerics")
        if spec_d is None:
            return None
        from repro_torch.numerics import NumericsSpec

        return NumericsSpec.from_dict(spec_d)
