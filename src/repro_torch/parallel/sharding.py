"""PartitionSpec rules for every architecture in the zoo (port of
``repro.parallel.sharding``).

Megatron-style TP on the "model" axis (column-parallel QKV/up projections,
row-parallel O/down), vocab-parallel embeddings/heads, expert-parallel MoE
stacks, head- or sequence-sharded decode caches, and optional FSDP (2D
weight sharding over ("data", "model")) for the large dense train cells.

The engine is shape-aware: :func:`fit_spec` drops any sharding a dimension
cannot honor (e.g. hymba's 32001 vocab is not divisible by 16 -> the
embedding falls back to replicated), so one rule set serves every
architecture and every mesh, including the reduced CPU meshes of the tests.

Batch ("data") sharding composes ("pod", "data") on the multi-pod mesh.

The rules run on an abstract mesh (axis names and sizes,
``launch.mesh.AbstractMesh``) and return specs: a :class:`PartitionSpec`
is a tuple with one entry a dim, None or an axis name or a tuple of axis
names (the first axis major), as the reference's.  :func:`placements`
turns a spec into DTensor placements on a ``DeviceMesh``;
:func:`local_slices`, :func:`shard` and :func:`gather` give a rank its
piece of a leaf and the whole leaf back.  The reference's
``shard_map_compat`` is a JAX version shim and has no counterpart.

Leaf paths are the reference's path strings (``_path_str`` over JAX's
flatten), built by :func:`leaf_paths` over the port's trees: dict keys and
list indices as they are; a packed module's buffers under the reference's
dataclass fields (``pack/w_q``, ``a_qp/scale``, ``blocked/epilogue``,
``fold/A``, ``members/0/...``); the layers of a ``LayerStack`` all under
the stack's path, each at its layer of the stacked shape the reference
holds (its leading layer dim), so the rules and :func:`fit_spec` see the
reference's shapes.  The port's pack holds the K-major codes ``w_qbt``
(N padded, ldt) where the reference holds ``w_qb`` (K padded, N padded):
its out axis is dim 0, so its rule is the reference's ``w_qb`` rule with
the two dims swapped, P(out, None).  Where the port pads N to another
multiple than the reference, :func:`fit_spec` can keep the out sharding on
one side only.
"""

from __future__ import annotations

import math
import re
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig


class PartitionSpec(tuple):
    """One entry a dim: None, an axis name or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _dp_axes(mesh):
    axes = [a for a in mesh.axis_names if a in ("pod", "data")]
    return tuple(axes) if axes else None


def fit_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Drop sharding on dims the shape cannot honor (non-divisible/too
    small), and on an axis the mesh does not have (a rule's "model" on a
    (data,) mesh, where the reference's lookup would fail)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape) or any(
                a not in mesh.shape for a in _entry_axes(entry)):
            out.append(None)
            continue
        n = math.prod(mesh.shape[a] for a in _entry_axes(entry))
        out.append(entry if shape[i] % n == 0 and shape[i] >= n else None)
    return P(*out)


# ---------------------------------------------------------------------------
# leaf paths over the port's trees
# ---------------------------------------------------------------------------

_PACK_NAMES = {"w_q": "pack/w_q", "w_scale": "pack/w_scale",
               "w_zp": "pack/w_zp", "sum_qw": "pack/sum_qw", "c": "pack/c",
               "c0": "pack/c0", "bias": "pack/bias",
               "a_scale": "a_qp/scale", "a_zp": "a_qp/zero_point",
               "w_qbt": "blocked/w_qbt", "epilogue": "blocked/epilogue",
               "meta": "blocked/meta"}


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def _packed_buffers(module, path: str):
    """(buffer name, reference path, buffer) of a packed module's own
    buffers (a fused group's members aside)."""
    for name, buf in module.named_buffers(recurse=False,
                                          remove_duplicate=False):
        if buf is not None:
            ref = (f"fold/{name[5:]}" if name.startswith("fold_")
                   else _PACK_NAMES[name])
            yield name, _join(path, ref), buf


def leaf_paths(tree: Any, path: str = "", stack=None):
    """(reference path, leaf, stack) of every leaf: ``stack`` = (layers,
    layer) for a layer of a ``LayerStack`` (whose reference leaf has a
    leading layer dim), else None.  Python scalars (a cache's ``pos``)
    are leaves of shape ()."""
    from repro_torch.core.approx_linear import LayerStack, _Packed

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, _join(path, k), stack)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, _join(path, i), stack)
    elif isinstance(tree, LayerStack):
        for i, layer in enumerate(tree.layers):
            yield from leaf_paths(layer, path, (len(tree), i))
    elif isinstance(tree, _Packed):
        for _, ref, buf in _packed_buffers(tree, path):
            yield ref, buf, stack
        for i, member in enumerate(getattr(tree, "members", ())):
            yield from leaf_paths(member, _join(path, f"members/{i}"), stack)
    elif tree is not None:
        yield path, tree, stack


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _map_specs(tree: Any, spec_fn, path: str = "", stack=None):
    """A tree of the structure of ``tree`` (dicts and lists; a packed
    module a dict of its buffer names, ``members`` a list; a LayerStack a
    list of its layers) whose leaves are ``spec_fn(path, leaf, stack)``."""
    from repro_torch.core.approx_linear import LayerStack, _Packed

    if isinstance(tree, dict):
        return {k: _map_specs(v, spec_fn, _join(path, k), stack)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_specs(v, spec_fn, _join(path, i), stack)
                for i, v in enumerate(tree)]
    if isinstance(tree, LayerStack):
        return [_map_specs(layer, spec_fn, path, (len(tree), i))
                for i, layer in enumerate(tree.layers)]
    if isinstance(tree, _Packed):
        out = {name: spec_fn(ref, buf, stack)
               for name, ref, buf in _packed_buffers(tree, path)}
        if hasattr(tree, "members"):
            out["members"] = [
                _map_specs(m, spec_fn, _join(path, f"members/{i}"), stack)
                for i, m in enumerate(tree.members)]
        return out
    if tree is None:
        return None
    return spec_fn(path, tree, stack)


def _per_layer(spec: P, stack) -> P:
    """A stacked leaf's spec for one layer of a LayerStack (its leading
    layer dim dropped; a spec that shards the layer dim replicates the
    layer, which a rank then holds whole)."""
    if stack is None:
        return spec
    if spec and spec[0] is not None:
        return P(*((None,) * (len(spec) - 1)))
    return P(*spec[1:])


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

# (regex on path, spec for the LAST ndims of the leaf).  First match wins.
# Leading (layer-stack / expert) dims are padded with the stack spec.
_COL = "COL"  # (in, out) -> P(maybe_fsdp, "model")
_ROW = "ROW"  # (in, out) -> P("model", maybe_fsdp)

_PARAM_RULES: list[tuple[str, Any]] = [
    # embeddings / heads (vocab-parallel)
    (r"embed/table$", P("model", None)),
    (r"lm_head/w$", P(None, "model")),
    # MoE: router replicated; expert stacks sharded on the expert dim
    (r"router/", P(None, None)),
    (r"experts/(gate|up)/w$", P("model", None, None)),
    (r"experts/down/w$", P("model", None, None)),
    # attention projections (qkv = the fan-out-fused Q|K|V group: its
    # concatenated output axis is column-parallel exactly like the members)
    (r"attn/(q|k|v|qkv)/w$", _COL),
    (r"attn/o/w$", _ROW),
    (r"attn/(q|k|v|qkv)/b$", P("model")),
    (r"attn/kv_a/", P(None, None)),  # tiny latent projection: replicate
    (r"attn/kv_b/w$", _COL),
    # MLPs (gateup = the fused gate|up group, column-parallel like members)
    (r"(mlp|shared)/(gate|up|gateup)/w$", _COL),
    (r"(mlp|shared)/down/w$", _ROW),
    (r"(mlp|shared)/(up|gateup)/b$", P("model")),
    (r"(mlp|shared)/down/b$", P(None)),
    # SSM (d_inner sharded on model)
    (r"ssm/in_proj/w$", _COL),
    (r"ssm/out_proj/w$", _ROW),
    (r"ssm/conv_w$", P(None, "model")),
    (r"ssm/conv_b$", P("model")),
    (r"ssm/x_proj/w$", P("model", None)),
    (r"ssm/dt_proj/w$", P(None, "model")),
    (r"ssm/dt_proj/b$", P("model")),
    (r"ssm/a_log$", P("model", None)),
    (r"ssm/d_skip$", P("model")),
    # RWKV time/channel mix
    (r"tm/(r|k|v|g)/w$", _COL),
    (r"tm/out/w$", _ROW),
    (r"tm/bonus$", P("model", None)),
    # decay-LoRA output + per-head norm scales sharded on "model": keeps the
    # (B, T, D) decay tensors head-sharded end to end
    (r"tm/decay_w2$", P(None, "model")),
    (r"tm/ln_x_(scale|bias)$", P("model")),
    (r"cm/key/w$", _COL),
    (r"cm/value/w$", _ROW),
    (r"cm/receptance/w$", _COL),
]


def _base_spec(path: str, ndim: int, fsdp: bool):
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            if spec == _COL:
                return P("data" if fsdp else None, "model")
            if spec == _ROW:
                return P("model", "data" if fsdp else None)
            return spec
    return None  # replicate


def _packed_leaf_spec(path: str, ndim: int, fsdp: bool):
    """Specs for packed leaves: derive from the parent linear's (in, out)
    rule.  Weight-shaped operands (w_q, folded A) shard like w; the
    reference's blocked (K padded, N padded) codes and folded B shard the
    out dim only; the port's K-major codes ``w_qbt`` (N padded, ldt) the
    same out dim, which is their dim 0; per-output vectors (c, c0, sum_qw,
    bias, fold delta) shard like the out dim, the epilogue table on its
    columns; scalars/meta replicate."""
    m = re.search(
        r"(.*)/(pack|a_qp|blocked|fold)/"
        r"(w_q|sum_qw|c|c0|bias|w_scale|w_zp|scale|zero_point"
        r"|w_qb|w_qbt|epilogue|meta|A|B|delta|sa|za)$", path)
    if not m:
        return None
    parent, _, leaf = m.groups()
    base = _base_spec(parent + "/w", 2, fsdp)
    if base is None:
        return P()
    out_axis = base[1] if len(base) > 1 else None
    if leaf in ("w_q", "A"):
        return base
    if leaf == "w_qb" or leaf == "B":
        # K axis is padded/stacked in tile multiples: shard the out dim only
        return P(None, out_axis)
    if leaf == "w_qbt":
        return P(out_axis, None)
    if leaf in ("sum_qw", "c", "c0", "bias", "delta"):
        return P(out_axis)
    if leaf == "epilogue":
        return P(None, out_axis)
    return P()  # scalars / meta


def _stacked_shape(leaf, stack) -> tuple[int, ...]:
    shape = _shape(leaf)
    return shape if stack is None else (stack[0],) + shape


def param_spec(path: str, shape: tuple[int, ...], mesh, fsdp: bool = False,
               dp_only: bool = False) -> P:
    """The reference's spec of one leaf of ``shape`` at ``path``."""
    ndim = len(shape)
    if dp_only:
        all_axes = tuple(mesh.axis_names)
        if ndim >= 2:
            # shard the largest trailing dim over the flat mesh
            target = max(range(ndim), key=lambda i: (shape[i], -i))
            spec = P(*(all_axes if i == target else None
                       for i in range(ndim)))
        elif ndim == 1:
            spec = P(all_axes)
        else:
            spec = P()
        return fit_spec(spec, shape, mesh)
    spec = _packed_leaf_spec(path, ndim, fsdp)
    if spec is None:
        spec = _base_spec(path, ndim, fsdp)
    if spec is None:
        spec = P()
    # pad leading stacked dims (layer stacks / per-layer packs)
    if len(spec) < ndim:
        spec = P(*((None,) * (ndim - len(spec)) + tuple(spec)))
    return fit_spec(spec, shape, mesh)


def param_shardings(params: Any, mesh, cfg: ArchConfig | None = None,
                    fsdp: bool = False, dp_only: bool = False) -> Any:
    """Spec tree for a (possibly packed/stacked) parameter tree (``meta``
    tensors do: only shapes are read).

    dp_only: ZeRO-3 layout — every weight 1D-sharded over ALL mesh axes
    combined, no tensor parallelism."""
    return _map_specs(params, lambda path, leaf, stack: _per_layer(
        param_spec(path, _stacked_shape(leaf, stack), mesh, fsdp, dp_only),
        stack))


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------


def batch_spec(path: str, shape: tuple[int, ...], mesh,
               dp_only: bool = False) -> P:
    dp = tuple(mesh.axis_names) if dp_only else _dp_axes(mesh)
    if dp is None or not shape:
        return P()
    if path.endswith("positions") and len(shape) == 3:
        spec = P(None, dp, None)
    else:
        spec = P(*((dp,) + (None,) * (len(shape) - 1)))
    return fit_spec(spec, shape, mesh)


def batch_shardings(batch: Any, mesh, dp_only: bool = False) -> Any:
    """Shard the leading (batch) dim over ("pod","data") — or over ALL axes
    in dp_only (ZeRO-3) mode; positions for M-RoPE are (3, B, T) -> batch is
    dim 1."""
    return _map_specs(batch, lambda path, leaf, _: batch_spec(
        path, _shape(leaf), mesh, dp_only))


def batch_rows(batch: dict, mesh, dp_only: bool = False):
    """(this rank's rows of a global batch, the axes they are split over:
    a model's ``mesh.batch_axes``)."""
    specs = batch_shardings(batch, mesh, dp_only)
    key = "embeds" if "embeds" in batch else "tokens"
    return ({k: shard(v, specs[k], mesh) for k, v in batch.items()},
            _entry_axes(specs[key][0]))


def cache_spec(path: str, shape: tuple[int, ...], mesh,
               cfg: ArchConfig) -> P:
    dp = _dp_axes(mesh)
    heads_ok = cfg.kv_heads % mesh.shape.get("model", 1) == 0
    if not shape:
        return P()
    if re.search(r"(dense_)?(k|v)$", path) and len(shape) == 5:
        spec = (P(None, dp, "model", None, None) if heads_ok
                else P(None, dp, None, "model", None))
    elif re.search(r"(dense_)?latent$", path):
        spec = P(None, dp, "model", None)
    elif re.search(r"(dense_)?rope$", path):
        spec = P(None, dp, "model", None)
    elif path.endswith("ssm_conv"):
        spec = P(None, dp, None, "model")
    elif path.endswith("ssm_h"):
        spec = P(None, dp, "model", None)
    elif path.endswith("wkv"):
        spec = P(None, dp, "model", None, None)
    elif path.endswith("shift_tm") or path.endswith("shift_cm"):
        spec = P(None, dp, None)
    else:
        spec = P()
    return fit_spec(spec, shape, mesh)


def cache_shardings(cache: Any, mesh, cfg: ArchConfig) -> Any:
    """Decode-cache specs.

    GQA k/v (L, B, H, S, d): heads on "model" when divisible, else the
    SEQUENCE is sharded on "model".  MLA latent (L, B, S, r): sequence on
    "model" (no head dim exists).  SSM / RWKV states: inner/head dims on
    "model"."""
    return _map_specs(cache, lambda path, leaf, _: cache_spec(
        path, _shape(leaf), mesh, cfg))


# ---------------------------------------------------------------------------
# specs on a live mesh
# ---------------------------------------------------------------------------


def _check_order(spec: P, mesh) -> None:
    for entry in spec:
        axes = _entry_axes(entry)
        order = [mesh.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: the axes of one dim must be in mesh "
                             f"order {mesh.axis_names}")


def placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh.device_mesh``: mesh dim i
    is ``Shard(d)`` where its axis shards dim d, else ``Replicate()``.  A
    dim sharded over several axes is split in mesh-dim order, the first
    axis major, which is the reference's layout of P(("pod", "data"))."""
    from torch.distributed.tensor import Replicate, Shard

    _check_order(spec, mesh)
    out = [Replicate() for _ in mesh.axis_names]
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[mesh.axis_names.index(a)] = Shard(d)
    return out


def local_slices(spec: P, shape: tuple[int, ...], mesh,
                 coord: dict | None = None) -> tuple[slice, ...]:
    """The index of the piece of a ``shape`` leaf that the rank at
    ``coord`` (default: this rank's) holds under ``spec``: what JAX's
    ``NamedSharding.devices_indices_map`` gives the device at the same
    mesh coordinate."""
    coord = mesh.coord if coord is None else coord
    out = []
    for d, n in enumerate(shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        k = mesh.axes_size(axes)
        step = n // k
        i = mesh.axes_index(coord, axes)
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's piece of the whole leaf ``x`` (a contiguous copy)."""
    if not isinstance(x, torch.Tensor) or x.ndim == 0:
        return x
    return x[local_slices(spec, tuple(x.shape), mesh)].contiguous()


def gather(x: torch.Tensor, spec: P, mesh,
           differentiable: bool = False) -> torch.Tensor:
    """The whole leaf from every rank's piece ``x``: one all-gather a
    sharded dim, over the axes that shard it."""
    from repro_torch.parallel import comm

    _check_order(spec, mesh)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes:
            continue
        g = mesh.group(axes)
        x = (comm.gather_dim(x, g, d) if differentiable
             else comm.all_gather(x, g, d))
    return x


def replicated_axes(spec: P, mesh) -> tuple[str, ...]:
    """The mesh axes a leaf under ``spec`` is replicated over."""
    used = {a for e in spec for a in _entry_axes(e)}
    return tuple(a for a in mesh.axis_names if a not in used)


def owns(spec: P, mesh) -> bool:
    """Whether this rank holds the copy of its piece that counts once in a
    sum over the mesh (coordinate 0 on every replicated axis)."""
    c = mesh.coord
    return all(c[a] == 0 for a in replicated_axes(spec, mesh))


def tree_shard(tree: Any, specs: Any, mesh) -> Any:
    from repro_torch.optim.adamw import tree_map

    return tree_map(lambda _, x, s: shard(x, s, mesh), tree, specs)


def tree_gather(tree: Any, specs: Any, mesh) -> Any:
    from repro_torch.optim.adamw import tree_map

    return tree_map(lambda _, x, s: x if not isinstance(x, torch.Tensor)
                    or x.ndim == 0 else gather(x, s, mesh), tree, specs)
