"""The approximation-aware dense op used by every model in the port.

Port of ``repro.core.approx_linear``.  Two parameter representations for a
linear layer:

  * float dict ``{"w": (k, n), "b": (n,)?}`` (or a (layers, k, n) stack);
  * :class:`QuantizedDense` — an ``nn.Module`` whose buffers are the
    offline pack (uint8 codes, quant params, CV constants) and, for
    ``backend: "pallas"`` packs, the blocked kernel layout, or, for other
    single-CV packs at fan-ins up to 258, the folded float32 operands.

``dense(p, x)`` dispatches on the representation, so model code is the
same for float, exact-int8 and approximate+CV numerics.  A packed
(layers, k, n) stack becomes a :class:`LayerStack` of per-layer modules at
the same path; ``layer_params`` slices layer i out of a block tree.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from repro_torch.core.policy import ApproxPolicy, PolicyFn
from repro_torch.quant import error_probe, faults, observers
from repro_torch.quant.quantize import (BlockedPack, PackedLinear, QuantParams,
                                        build_blocked_layout, build_fold,
                                        calibrate_minmax, concat_packs,
                                        folded_linear, pack_linear,
                                        quantized_linear, serving_blocks)

_PACK_FIELDS = ("w_q", "w_scale", "w_zp", "sum_qw", "c", "c0", "bias")
_BLOCKED_FIELDS = ("w_qbt", "epilogue", "meta")


class _Packed(nn.Module):
    """Buffers of one pack (+ activation quant params, + blocked layout or
    folded operands, held as ``fold_<key>`` buffers)."""

    def __init__(self, pack: PackedLinear, a_qp: QuantParams,
                 policy: ApproxPolicy, blocked: BlockedPack | None,
                 fold: dict | None = None):
        super().__init__()
        self.policy = policy
        for f in _PACK_FIELDS:
            self.register_buffer(f, getattr(pack, f))
        self.register_buffer("a_scale", a_qp.scale)
        self.register_buffer("a_zp", a_qp.zero_point)
        self._blocked_dims = None
        for f in _BLOCKED_FIELDS:
            self.register_buffer(f, getattr(blocked, f) if blocked else None)
        if blocked is not None:
            self._blocked_dims = (blocked.k, blocked.n, blocked.bk, blocked.bn)
        self._fold_keys = tuple(fold) if fold is not None else ()
        for key in self._fold_keys:
            self.register_buffer(f"fold_{key}", fold[key])

    @property
    def pack(self) -> PackedLinear:
        return PackedLinear(**{f: getattr(self, f) for f in _PACK_FIELDS})

    @property
    def a_qp(self) -> QuantParams:
        return QuantParams(self.a_scale, self.a_zp)

    @property
    def blocked(self) -> BlockedPack | None:
        if self._blocked_dims is None:
            return None
        k, n, bk, bn = self._blocked_dims
        return BlockedPack(self.w_qbt, self.epilogue, self.meta, k, n, bk, bn)

    @property
    def fold(self) -> dict | None:
        """The folded serving operands (``build_fold``), or None."""
        if not self._fold_keys:
            return None
        return {key: getattr(self, f"fold_{key}") for key in self._fold_keys}


class QuantizedDense(_Packed):
    """Packed approximate linear layer; ``policy`` is static metadata."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _packed_forward(self, x)


class QuantizedDenseGroup(_Packed):
    """Fan-out-fused sibling linears (Q|K|V, gate|up) sharing one input.

    One concatenated pack (per-column weight quant params) runs every
    member in a single wide-N call: activations are quantized once and the
    per-row statistics (sumx, sumqa) computed once, so the fused outputs
    equal the separate member calls bit for bit.  ``members`` are the
    individually packed layers for decode-shaped calls (see
    :func:`dense_group`); their K-major codes are row slices of the
    group's, so the weights are on the card once."""

    def __init__(self, pack, a_qp, policy, blocked, names: tuple[str, ...],
                 splits: tuple[int, ...], members: list[QuantizedDense],
                 fold: dict | None = None):
        super().__init__(pack, a_qp, policy, blocked, fold)
        self.names, self.splits = names, splits
        self.members = nn.ModuleList(members)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        return dense_group(self, x)


class LayerStack(nn.Module):
    """A packed (layers, k, n) stack: one packed module per layer, held at
    the stack's parameter path (the reference keeps one vmapped pack)."""

    def __init__(self, layers: list[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def __getitem__(self, i: int) -> nn.Module:
        return self.layers[i]

    def __len__(self) -> int:
        return len(self.layers)


def is_linear_params(p: Any) -> bool:
    """Float linear leaf: 2D weights, or 3D = (layers, k, n) stack (or a
    standalone (experts, k, n) stack).  A model's 4-D (layers, experts, k,
    n) expert stacks are not linear leaves, as in the reference: they stay
    float (ROADMAP queue 3)."""
    return isinstance(p, dict) and "w" in p and getattr(p["w"], "ndim", 0) in (2, 3)


def layer_params(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked block tree (tensors sliced on axis 0,
    packed stacks indexed)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, LayerStack):
        return tree[i]
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return tree


def _packed_forward(p: _Packed, x: torch.Tensor) -> torch.Tensor:
    """Forward dispatch for one packed leaf (or fused group's wide call),
    the reference's order: a pallas-backend single-CV approximate pack runs
    the kernel; any other pack its folded operands when it carries them,
    else the exact-integer path (grouped CV included)."""
    pol = p.policy
    if pol.backend == "pallas" and pol.is_approx and pol.groups == 1:
        from repro_torch.kernels import ops as kops

        if not isinstance(p, QuantizedDenseGroup):
            return kops.quantized_dense_pallas(x, p).to(x.dtype)
        blocked = p.blocked
        if blocked is not None:
            return kops.quantized_dense_fused_op(
                x, blocked, mode=pol.mode, m=pol.m, use_cv=pol.use_cv)
    fold = p.fold
    if fold is not None:
        return folded_linear(x, fold, pol.mode, pol.m,
                             pol.use_cv).to(x.dtype)
    return quantized_linear(x, p.pack, p.a_qp, pol.mode, pol.m,
                            use_cv=pol.use_cv, groups=pol.groups).to(x.dtype)


def _probed_forward(p: _Packed, x: torch.Tensor, name: str) -> torch.Tensor:
    """:func:`_packed_forward` under the error probe's hooks.  With no
    :class:`~repro_torch.quant.error_probe.ProbeRecorder` active (always,
    outside a probe) this is one thread-local lookup.  Mode "exact"
    returns the exact-int8 reference on the same codes; mode "observe"
    lets an armed fault injector corrupt the approximate output (a
    degraded MAC array shows in the probe's variance), then records the
    delta from that reference under the layer path."""
    probe = error_probe.active()
    if probe is None:
        return _packed_forward(p, x)
    if probe.mode == "exact":
        return error_probe.exact_dense(p, x).to(x.dtype)
    y = _packed_forward(p, x)
    path = observers.current_path()
    flt = faults.active()
    if flt is not None:
        y = flt.corrupt_dense(path, name, y)
    probe.observe(path, name, y.to(torch.float64)
                  - error_probe.exact_dense(p, x).to(torch.float64))
    return y


def dense(p: Any, x: torch.Tensor, name: str | None = None) -> torch.Tensor:
    """y = x @ W (+ b), under whatever numerics ``p`` encodes.

    ``name`` (optional) names the layer under the current
    :func:`~repro_torch.quant.observers.scope`: on the float path, with a
    :class:`~repro_torch.quant.observers.CalibrationRecorder` active, the
    input's range is recorded under that path (the one :func:`pack_params`
    looks up), and the error probe's hooks see a packed layer under it
    (:func:`_probed_forward`)."""
    if isinstance(p, QuantizedDense):
        return _probed_forward(p, x, name or "dense")
    if name is not None:
        with observers.scope(name):
            observers.record(x)
    else:
        observers.record(x)
    w = p["w"]
    dt = torch.promote_types(x.dtype, w.dtype)
    y = torch.matmul(x.to(dt), w.to(dt))
    if p.get("b") is not None:
        y = y + p["b"]
    return y


def _fuse_m_min() -> int:
    """Smallest flattened row count that runs the wide fused group call.

    Decode-shaped calls (M <= DECODE_M_MAX) run the members instead: the
    kernel's split-K decode launches stream each member's weights once
    either way, and the members' outputs need no split.  Both paths are
    bit-identical, so the choice is only about latency."""
    from repro_torch.kernels import ops as kops

    return kops.DECODE_M_MAX + 1


def dense_group(g: QuantizedDenseGroup, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Run a fused fan-out group: one wide-N call, outputs split per member
    (or, at decode shapes, the members one by one, each under its own
    name).  The error probe's hooks see the group under the joined member
    names (``q|k|v``)."""
    rows = math.prod(x.shape[:-1]) if x.ndim > 1 else 1
    if len(g.members) and rows < _fuse_m_min():
        return {name: dense(member, x, name=name)
                for name, member in zip(g.names, g.members)}
    y = _probed_forward(g, x, "|".join(g.names))
    return dict(zip(g.names, torch.split(y, list(g.splits), dim=-1)))


def init_dense(k: int, n: int, *, generator: torch.Generator, bias: bool = True,
               scale: float | None = None, device=None,
               dtype=torch.float32) -> dict:
    """Trunc-normal linear init (1/sqrt(k) fan-in scaling)."""
    if scale is None:
        scale = k ** -0.5
    w = torch.empty(k, n, device=device, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    p = {"w": (w * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros(n, device=device, dtype=dtype)
    return p


# ---------------------------------------------------------------------------
# Offline packing: float params + calibration stats -> packed modules
# ---------------------------------------------------------------------------


def _maybe_blocked(pack: PackedLinear, a_qp: QuantParams,
                   policy: ApproxPolicy) -> BlockedPack | None:
    """Offline-blocked kernel layout for pallas-backend single-CV packs."""
    if not (policy.backend == "pallas" and policy.is_approx
            and policy.groups == 1):
        return None
    k, n = pack.w_q.shape[-2:]
    bn, bk = serving_blocks(k, n)
    return build_blocked_layout(pack, a_qp, bn, bk)


def _maybe_fold(pack: PackedLinear, a_qp: QuantParams,
                policy: ApproxPolicy) -> dict | None:
    """Folded float32 serving operands for packs that do not run the
    kernel (``build_fold``: single-CV, fan-in up to 258)."""
    if policy.backend == "pallas" and policy.is_approx and policy.groups == 1:
        return None
    return build_fold(pack, a_qp, policy.mode, policy.m, policy.use_cv)


def _per_layer(p: dict):
    """[(w, b)] per layer for a 2D leaf or a (layers, k, n) stack."""
    w, b = p["w"], p.get("b")
    if w.ndim == 2:
        return [(w, b)]
    return [(w[i], None if b is None else b[i]) for i in range(w.shape[0])]


def _pack_one(w, b, policy, a_qp, fold: bool) -> QuantizedDense:
    pack = pack_linear(w, b, policy.mode, policy.m, policy.groups)
    return QuantizedDense(pack, a_qp, policy, _maybe_blocked(pack, a_qp, policy),
                          _maybe_fold(pack, a_qp, policy) if fold else None)


def pack_dense(p: dict, policy: ApproxPolicy,
               act_range: tuple[float, float], fold: bool = True) -> nn.Module:
    """Pack one float linear layer (2D, or a (layers, k, n) stack whose
    slices get their own quant/CV constants) for the approximate array;
    ``fold`` adds the folded operands where :func:`build_fold` builds
    them."""
    a_qp = calibrate_minmax(act_range[0], act_range[1], device=p["w"].device)
    layers = [_pack_one(w, b, policy, a_qp, fold) for w, b in _per_layer(p)]
    return layers[0] if p["w"].ndim == 2 else LayerStack(layers)


def pack_dense_group(members: list[tuple[str, dict]], policy: ApproxPolicy,
                     act_range: tuple[float, float],
                     fold: bool = True) -> nn.Module:
    """Pack sibling linears that consume the SAME activations into one
    fan-out-fused wide-N pack, keeping the member packs for decode shapes."""
    names = tuple(name for name, _ in members)
    leaves = [leaf for _, leaf in members]
    splits = tuple(int(leaf["w"].shape[-1]) for leaf in leaves)
    a_qp = calibrate_minmax(act_range[0], act_range[1],
                            device=leaves[0]["w"].device)
    per_member = [_per_layer(leaf) for leaf in leaves]
    groups = []
    for li in range(len(per_member[0])):
        mods = [_pack_one(w, b, policy, a_qp, fold)
                for w, b in (pm[li] for pm in per_member)]
        pack = concat_packs([mod.pack for mod in mods])
        group = QuantizedDenseGroup(
            pack, a_qp, policy, _maybe_blocked(pack, a_qp, policy), names,
            splits, mods, _maybe_fold(pack, a_qp, policy) if fold else None)
        if group.w_qbt is not None:
            # a member's columns are a contiguous range of the group's, so
            # its K-major codes are those rows of the group's (same ldt)
            lo = 0
            for mod, n in zip(mods, splits):
                mod.w_qbt = group.w_qbt[lo:lo + n]
                lo += n
        groups.append(group)
    return groups[0] if leaves[0]["w"].ndim == 2 else LayerStack(groups)


#: Sibling sets eligible for fan-out fusion: (member names, fused key,
#: companion key).  The companion anchors the dict to the module shape
#: whose call sites feed every member the same input.
FUSABLE_GROUPS: tuple[tuple[tuple[str, ...], str, str], ...] = (
    (("q", "k", "v"), "qkv", "o"),
    (("gate", "up"), "gateup", "down"),
)


def _fusable(node: dict, names, companion, path, policy_fn, act_ranges,
             default_range):
    if companion not in node:
        return None
    if not all(n in node and is_linear_params(node[n]) for n in names):
        return None
    leaves = [node[n] for n in names]
    w0 = leaves[0]["w"]
    if any(leaf["w"].shape[:-1] != w0.shape[:-1]
           or leaf["w"].ndim != w0.ndim for leaf in leaves):
        return None
    if len({leaf.get("b") is not None for leaf in leaves}) > 1:
        return None
    policies = [policy_fn(path + (n,)) for n in names]
    if policies[0] is None or any(p != policies[0] for p in policies):
        return None
    ranges = [tuple(float(v) for v in (act_ranges or {}).get(
        "/".join(path + (n,)), default_range)) for n in names]
    if any(r != ranges[0] for r in ranges):
        return None
    return policies[0], ranges[0]


def pack_params(params: Any, policy_fn: PolicyFn,
                act_ranges: dict[str, tuple[float, float]] | None = None,
                default_range: tuple[float, float] = (-8.0, 8.0),
                fuse: bool = True, fold: bool = True) -> Any:
    """Walk a parameter tree, replacing float linear leaves with packed
    modules (``policy_fn(path)`` None keeps a leaf float).  With ``fuse``,
    sibling sets of :data:`FUSABLE_GROUPS` sharing a policy and activation
    range become one :class:`QuantizedDenseGroup` at key "qkv"/"gateup"
    (never inside an ``experts`` dict, whose stacks pack per expert,
    without folded operands).
    With ``fold`` (the default, as the reference's), packs that do not run
    the kernel carry the folded float32 operands where ``build_fold``
    builds them; ``fold=False`` keeps every such pack on the exact-integer
    path."""

    def walk(node: Any, path: tuple[str, ...]) -> Any:
        if is_linear_params(node):
            policy = policy_fn(path)
            if policy is None:
                return node
            rng = (act_ranges or {}).get("/".join(path), default_range)
            # expert stacks run the grouped path, which reads only the
            # canonical packs: folded operands would be dead weight
            leaf_fold = fold and path[-2:-1] != ("experts",)
            return pack_dense(node, policy, rng, fold=leaf_fold)
        if isinstance(node, dict):
            groups: dict[str, tuple[str, Any]] = {}
            consumed: set[str] = set()
            # an "experts" dict holds gate/up/down stacks that run through
            # the grouped path, never a fused group
            if fuse and path[-1:] != ("experts",):
                for names, gkey, companion in FUSABLE_GROUPS:
                    if consumed.intersection(names):
                        continue
                    hit = _fusable(node, names, companion, path, policy_fn,
                                   act_ranges, default_range)
                    if hit is None:
                        continue
                    policy, rng = hit
                    groups[names[0]] = (gkey, pack_dense_group(
                        [(n, node[n]) for n in names], policy, rng,
                        fold=fold))
                    consumed.update(names)
            out: dict[str, Any] = {}
            for k, v in node.items():
                if k in groups:
                    gkey, g = groups[k]
                    out[gkey] = g
                elif k not in consumed:
                    out[k] = walk(v, path + (str(k),))
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        return node

    return walk(params, ())


def packed_layer_paths(params: Any) -> list[str]:
    """All paths that hold packed layers, fused groups reported by their
    member paths, sorted (stable across fused and unfused packs)."""
    out: list[str] = []

    def walk(node: Any, path: tuple[str, ...]):
        if isinstance(node, LayerStack):
            node = node[0]
        if isinstance(node, QuantizedDenseGroup):
            out.extend("/".join(path[:-1] + (name,)) for name in node.names)
        elif isinstance(node, QuantizedDense):
            out.append("/".join(path))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))

    walk(params, ())
    return sorted(out)


def iter_tensors(tree: Any):
    """Every tensor of a parameter or cache tree (dicts, lists, modules)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.buffers()
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from iter_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from iter_tensors(v)
