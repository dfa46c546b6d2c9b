"""Mixture-of-Experts layer (port of ``repro.nn.moe``): shared experts plus
top-k routed experts, dropless, tokens sorted by expert.

Routing follows DeepSeek-V2-lite / Moonlight: a float32 softmax router,
top-k (k=6) of 64 routed experts with renormalized gates, and the shared
experts added on every token.

Execution strategies (``MoEConfig.impl``, identical math):

  local      every expert on every device: the pairs sorted by expert,
             the grouped GEMM, the outputs unsorted.  Used on a single
             device and as the per-shard body under EP.
  ep_psum    expert stacks sharded over the ``ep_axis`` mesh axis.  Each
             rank takes its data shard of the tokens, selects the (token,
             expert) pairs that hit its ``n_experts / n_shards`` experts
             (capacity-bounded, GShard-style drops: the reference's
             positional rule), runs the local grouped GEMM and does one
             all-reduce (sum) over the axis a layer.

The router stays float (the serving rules keep ``router`` float).  An
expert stack is an (E, k, n) leaf inside a layer and (L, E, k, n) in a
model's stacked ``blocks``; the pack walker packs only 2-D and 3-D leaves
(as the reference's), so a model's experts stay float and a standalone
3-D stack packs per expert (``core.grouped_approx``).

The routed experts take the call's tokens in pieces of at most
``TOKEN_CHUNK`` rows.  In a piece, the float expert GEMMs run as one
batched GEMM a projection over EVERY expert, each expert's rows padded to
the piece's token count: a row's output then depends on neither the other
rows nor their routing (cuBLAS picks its algorithm by the GEMM's shape,
which is fixed by the call's shape and the row's piece), so a request's
tokens do not depend on its neighbours in the batch.  The piece bounds
the padded buffers at E x TOKEN_CHUNK rows, whatever the prompt's length.
The reference's ragged dot computes the same products on the sorted rows
alone.  The dispatch makes no host synchronisation.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.approx_linear import LayerStack, dense, init_dense
from repro_torch.nn.layers import init_swiglu, swiglu

#: most tokens a padded expert GEMM takes: an engine step of 4 slots x 32
#: tokens is one piece; a long prompt is several
TOKEN_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int  # per-expert FFN width (1408 for dsv2-lite)
    n_experts: int  # routed experts
    top_k: int
    n_shared: int = 0  # shared experts (width = n_shared * d_ff_expert)
    capacity_factor: float = 1.25
    impl: str = "local"  # "local" | "ep_psum"
    ep_axis: str = "model"


def init_moe(cfg: MoEConfig, *, generator, device=None) -> dict:
    """The reference's distributions: a trunc-normal float32 router,
    normal expert stacks scaled by 1/sqrt(fan-in), a swiglu of width
    n_shared * d_ff_expert for the shared experts."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts

    def stack(k, n):
        return {"w": torch.randn(e, k, n, generator=generator,
                                 device=device) * k ** -0.5}

    p = {"router": init_dense(d, e, generator=generator, bias=False,
                              device=device),
         "experts": {"gate": stack(d, f), "up": stack(d, f),
                     "down": stack(f, d)}}
    if cfg.n_shared:
        p["shared"] = init_swiglu(d, cfg.n_shared * f, generator=generator,
                                  device=device)
    return p


def _route(p: dict, x_flat: torch.Tensor, cfg: MoEConfig):
    """Top-k routing with renormalized gates, x_flat (N, D) -> (gates (N,
    k) float32, expert ids (N, k), probs (N, E)).  The router runs in
    float32 whatever its leaf's dtype: ``dense`` promotes a bf16 serving
    leaf to the float32 input's type, as ``jnp.matmul`` does."""
    logits = dense(p["router"], x_flat.to(torch.float32), name="router")
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _batched_expert(w: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """(E, cap, k) rows against the (E, k, n) stack, in the promoted
    dtype."""
    dt = torch.promote_types(buf.dtype, w.dtype)
    return torch.bmm(buf.to(dt), w.to(dt))


def _expert_ffn_sorted(experts: dict, xs: torch.Tensor,
                       group_sizes: torch.Tensor, cap: int) -> torch.Tensor:
    """Grouped swiglu over expert-sorted rows: xs (M, D) sorted by expert,
    group_sizes (E + 1,), the last group the pairs that no local expert
    takes (dropped or another rank's), whose rows come out with some
    expert's finite values for the caller to gate to zero.  A packed
    (per-expert) stack runs the per-expert approximate path
    (``core.grouped_approx``; those rows join the last expert); a float
    stack the padded batched GEMMs, ``cap`` rows an expert (no expert has
    more), those rows parked in one scratch row of the buffer."""
    e = group_sizes.shape[0] - 1
    if isinstance(experts["gate"], LayerStack):
        from repro_torch.core.grouped_approx import grouped_quantized_swiglu

        gs = group_sizes[:e].clone()
        gs[-1] += group_sizes[e]
        return grouped_quantized_swiglu(experts, xs, gs)
    m_rows = xs.shape[0]
    ids = torch.repeat_interleave(
        torch.arange(e + 1, device=xs.device), group_sizes,
        output_size=m_rows)
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    slot = torch.arange(m_rows, device=xs.device) - starts[ids]
    flat = torch.where(ids < e, ids * cap + slot, e * cap)
    buf = xs.new_zeros(e * cap + 1, xs.shape[1])
    buf[flat] = xs
    buf = buf[:-1].view(e, cap, xs.shape[1])
    g = _batched_expert(experts["gate"]["w"], buf)
    u = _batched_expert(experts["up"]["w"], buf)
    out = _batched_expert(experts["down"]["w"], F.silu(g) * u)
    return out.reshape(e * cap, -1)[flat.clamp(max=e * cap - 1)]


def _piece(experts: dict, x_flat: torch.Tensor, gates: torch.Tensor,
           idx: torch.Tensor, keep: torch.Tensor, e_local: int
           ) -> torch.Tensor:
    """The routed output of one piece of tokens: ``idx`` (n, k) local
    expert ids, ``keep`` (n, k) the pairs the local experts take.  The
    kept pairs sorted by expert (stable, so a token's pairs keep its order
    within an expert), the grouped swiglu, each token's gated outputs
    summed in ascending expert order (the order the reference's
    scatter-add meets them); a pair not kept adds an exact zero."""
    n, k = idx.shape
    pair_expert = torch.where(keep, idx, e_local).reshape(-1)
    order = torch.argsort(pair_expert, stable=True)
    sel_expert = pair_expert[order]
    sel_token = order // k
    group_sizes = torch.zeros(e_local + 1, dtype=torch.long,
                              device=x_flat.device)
    group_sizes.scatter_add_(0, sel_expert, torch.ones_like(sel_expert))
    xs = x_flat[sel_token]
    # a token routes to distinct experts, so an expert gets at most n rows
    ys = _expert_ffn_sorted(experts, xs, group_sizes, cap=n)
    gate = torch.where(keep, gates, torch.zeros_like(gates))
    ys = ys * gate.reshape(-1)[order][:, None].to(ys.dtype)
    # each token's pairs, by ascending expert id, as rows of the sorted ys
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    by_expert = torch.argsort(idx, dim=1, stable=True)
    rows = inv.reshape(n, k).gather(1, by_expert)
    out = torch.zeros(n, x_flat.shape[1], dtype=ys.dtype,
                      device=x_flat.device)
    for j in range(k):
        out = out + ys[rows[:, j]]
    return out


def _moe_local(p: dict, x_flat: torch.Tensor, cfg: MoEConfig,
               e_start: int = 0, e_local: int | None = None,
               capacity: int | None = None) -> torch.Tensor:
    """Dropless (or capacity-bounded) MoE over experts [e_start, e_start +
    e_local) (default: all), ``p["experts"]`` holding just those.  Returns
    the routed output (N, D) of the local token buffer.

    Routing runs a ``TOKEN_CHUNK`` piece at a time.  The capacity rule is
    the reference's, over the whole buffer: the (token, expert) pairs are
    stable-sorted by local expert with the other ranks' pairs last, and
    the first ``capacity`` of them are kept, so drops fall on the
    highest-numbered local experts' last tokens.  The expert GEMMs then
    run a piece of tokens at a time on the kept pairs."""
    n, _ = x_flat.shape
    k = cfg.top_k
    e_local = cfg.n_experts if e_local is None else e_local
    routes = [_route(p, x_flat[i:i + TOKEN_CHUNK], cfg)[:2]
              for i in range(0, n, TOKEN_CHUNK)]
    gates = torch.cat([r[0] for r in routes])
    idx = torch.cat([r[1] for r in routes]) - e_start
    keep = (idx >= 0) & (idx < e_local)
    if capacity is not None and capacity < n * k:
        sort_key = torch.where(keep, idx, e_local).reshape(-1)
        order = torch.argsort(sort_key, stable=True)
        kept = torch.zeros(n * k, dtype=torch.bool, device=x_flat.device)
        kept[order[:capacity]] = True
        keep = keep & kept.reshape(n, k)
    return torch.cat([
        _piece(p["experts"], x_flat[i:i + TOKEN_CHUNK],
               gates[i:i + TOKEN_CHUNK], idx[i:i + TOKEN_CHUNK],
               keep[i:i + TOKEN_CHUNK], e_local)
        for i in range(0, n, TOKEN_CHUNK)])


def _local_experts(experts: dict, n_experts: int, e_start: int,
                   e_local: int) -> dict:
    """The stacks of experts [e_start, e_start + e_local): a whole stack
    (E, k, n) is sliced; a stack that already holds only them (a rank's
    shard in the sharded train step) is taken as it is."""
    def pick(stack):
        if isinstance(stack, LayerStack):  # per-expert packs
            if len(stack) == n_experts and e_local != n_experts:
                return LayerStack(list(stack.layers)[e_start:
                                                     e_start + e_local])
            return stack
        leaf = stack["w"]
        if leaf.shape[0] == n_experts and e_local != n_experts:
            leaf = leaf[e_start:e_start + e_local]
        return {"w": leaf}

    return {name: pick(experts[name]) for name in experts}


def _moe_ep_psum(p: dict, x_flat: torch.Tensor, cfg: MoEConfig,
                 mesh) -> torch.Tensor:
    """Expert-parallel execution: experts sharded over ``cfg.ep_axis``.

    The reference's layout: the tokens split over every other axis (the
    data axes), each rank of the ``ep_axis`` group running its experts on
    its data shard with capacity ``max(int(n_loc * k * cf / n_shards),
    k)``, then one all-reduce (sum) over the group.  ``mesh.batch_axes``
    says how the caller's rows are laid out: already split over the data
    axes (the sharded train step), on every rank (serving: each rank
    takes its data piece first and the pieces are gathered after), or
    split over every axis (``dp_only``: the group's rows are gathered
    first and each rank keeps its own after)."""
    from repro_torch.parallel import comm

    ep = cfg.ep_axis
    n_shards = mesh.shape.get(ep, 1)
    if cfg.n_experts % n_shards:
        raise ValueError(f"{cfg.n_experts} experts over {n_shards} shards")
    e_local = cfg.n_experts // n_shards
    shard_id = mesh.coord.get(ep, 0)
    data_axes = tuple(a for a in mesh.axis_names if a != ep)
    held = set(mesh.batch_axes)
    x_loc, after = x_flat, None
    if held == set(data_axes):
        pass
    elif not held:
        n = mesh.axes_size(data_axes)
        if n > 1:
            x_loc = comm.slice_dim(x_flat, 0, n,
                                   mesh.axes_index(mesh.coord, data_axes))
            after = "gather"
    elif held == set(mesh.axis_names):
        x_loc = comm.gather_dim(x_flat, mesh.group((ep,)), 0)
        after = "slice"
    else:
        raise ValueError(f"EP over {ep!r} with the rows split over "
                         f"{sorted(held)} of {mesh.axis_names}")
    n_loc = x_loc.shape[0]
    cap = max(int(n_loc * cfg.top_k * cfg.capacity_factor / n_shards),
              cfg.top_k)
    p_loc = {"router": p["router"],
             "experts": _local_experts(p["experts"], cfg.n_experts,
                                       shard_id * e_local, e_local)}
    out = _moe_local(p_loc, x_loc, cfg, shard_id * e_local, e_local, cap)
    if ep in mesh.axis_names:
        out = comm.psum(out, mesh.group((ep,)))
    if after == "gather":
        out = comm.gather_dim(out, mesh.group(data_axes), 0)
    elif after == "slice":
        out = comm.slice_dim(out, 0, n_shards, shard_id)
    return out


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig,
              mesh=None) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D): the routed experts (``impl`` "local", or
    "ep_psum" under ``mesh``) plus the shared ones."""
    b, t, d = x.shape
    x_flat = x.reshape(-1, d)
    if cfg.impl == "local" or mesh is None:
        routed = _moe_local(p, x_flat, cfg)
    elif cfg.impl == "ep_psum":
        routed = _moe_ep_psum(p, x_flat, cfg, mesh)
    else:
        raise ValueError(cfg.impl)
    out = routed.reshape(b, t, d).to(x.dtype)
    if "shared" in p:
        out = out + swiglu(p["shared"], x)
    return out
