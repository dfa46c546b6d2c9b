"""Mixture-of-Experts layer (port of ``repro.nn.moe``): shared experts plus
top-k routed experts, dropless, tokens sorted by expert.

Routing follows DeepSeek-V2-lite / Moonlight: a float32 softmax router,
top-k (k=6) of 64 routed experts with renormalized gates, and the shared
experts added on every token.

Every expert runs on the device.  The reference's ``impl="ep_psum"``,
experts sharded over a mesh axis with one all-reduce a layer, is expert
parallelism, which the port does not have yet (ROADMAP queue 1, the
distributed item); its config fields are left out until then.

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
    group_sizes (E,).  A packed (per-expert) stack runs the per-expert
    approximate path (``core.grouped_approx``); a float stack the padded
    batched GEMMs, ``cap`` rows an expert (no expert has more)."""
    if isinstance(experts["gate"], LayerStack):
        from repro_torch.core.grouped_approx import grouped_quantized_swiglu

        return grouped_quantized_swiglu(experts, xs, group_sizes)
    m_rows = xs.shape[0]
    e = group_sizes.shape[0]
    ids = torch.repeat_interleave(
        torch.arange(e, device=xs.device), group_sizes, output_size=m_rows)
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    slot = torch.arange(m_rows, device=xs.device) - starts[ids]
    buf = xs.new_zeros(e, cap, xs.shape[1])
    buf[ids, slot] = xs
    g = _batched_expert(experts["gate"]["w"], buf)
    u = _batched_expert(experts["up"]["w"], buf)
    return _batched_expert(experts["down"]["w"], F.silu(g) * u)[ids, slot]


def _moe_local(p: dict, x_flat: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Dropless MoE over every expert: the (token, expert) pairs sorted by
    expert (stable, so a token's pairs keep its order within an expert),
    the grouped swiglu, each token's gated outputs summed in ascending
    expert order (the order the reference's scatter-add meets them).
    Returns the routed output (N, D)."""
    n, _ = x_flat.shape
    k, e = cfg.top_k, cfg.n_experts
    gates, idx, _ = _route(p, x_flat, cfg)
    pair_expert = idx.reshape(-1)
    order = torch.argsort(pair_expert, stable=True)
    sel_expert = pair_expert[order]
    sel_token = order // k
    group_sizes = torch.zeros(e, dtype=torch.long, device=x_flat.device)
    group_sizes.scatter_add_(0, sel_expert, torch.ones_like(sel_expert))
    xs = x_flat[sel_token]
    # a token routes to distinct experts, so an expert gets at most n rows
    ys = _expert_ffn_sorted(p["experts"], xs, group_sizes, cap=n)
    ys = ys * gates.reshape(-1)[order][:, None].to(ys.dtype)
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


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D): the routed experts, over TOKEN_CHUNK
    tokens at a time, plus the shared ones."""
    b, t, d = x.shape
    x_flat = x.reshape(-1, d)
    out = torch.cat([_moe_local(p, x_flat[i:i + TOKEN_CHUNK], cfg)
                     for i in range(0, x_flat.shape[0], TOKEN_CHUNK)])
    out = out.reshape(b, t, d).to(x.dtype)
    if "shared" in p:
        out = out + swiglu(p["shared"], x)
    return out
