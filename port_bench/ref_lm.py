"""Plain reference of a dense GQA decoder LM served on the approximate
MAC array (OLMo-style: non-parametric LayerNorm, rotary positions,
SwiGLU, tied embeddings), in float32 with the exact integer products of
:mod:`port_bench.approx_ref`.  Whole sequences, causal attention, no
cache, no batching, no kernel; it imports nothing of the program.

Every linear of every block runs the configuration's approximate
product with activation codes over the configuration's fixed range; the
embedding is float, as the configuration states.  Activations are held
in the configuration's compute type where the served model holds them,
so that the activation codes are those of the published arithmetic on
the values as served.  It runs the first blocks, whose keys and values
the check compares, or every block, the final norm and the tied head,
whose logits the check compares at the positions of served tokens.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench import approx_ref, weights


def norm(kind: str, x: torch.Tensor) -> torch.Tensor:
    """The configuration's norm at its initial parameters."""
    if kind == "rmsnorm":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x (T, H, D) at positions 0..T-1."""
    t, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, r=lambda t: t) -> torch.Tensor:
    """Causal grouped-head attention; q (T, Hq, D), k/v (T, Hkv, D); ``r``
    holds the scores and the weights as served (the softmax in float32)."""
    t, hq, d = q.shape
    rep = hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = r(r(torch.einsum("qhd,khd->hqk", q, k)) * d ** -0.5)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    p = r(torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1))
    return torch.einsum("hqk,khd->qhd", p, v).reshape(t, hq * d)


def forward(config: dict, seed: int, seqs: list[list[int]], device,
            hold: torch.dtype = torch.float32, kv_layers: int = 0,
            logits_at: list[list[int]] | None = None) -> dict:
    """Causal forward over each sequence of ``seqs``, the model's weights
    made again from ``seed`` a layer at a time: through the first
    ``kv_layers`` layers, or, given ``logits_at`` (positions, one list a
    sequence), through every layer, the final norm and the tied head.
    Arithmetic in float32 (integer products exact); every activation is
    held in ``hold`` where the served model holds it (the table, norm
    outputs, products, rotated q and k, attention output, the residual
    stream, the MLP's gate, the logits); a float8 ``hold`` saturates at
    its largest finite value, as a float8 pipeline's scaled casts do.
    Returns ``{"kv": per sequence, the first ``kv_layers`` layers' (k, v)
    as (positions, kv_heads, head_dim), k rotated; "logits": per sequence,
    (len(positions), vocab) float32, given ``logits_at``}``."""
    arch, ap = config["arch"], config["approx"]
    hd = arch.get("head_dim") or arch["d_model"] // arch["n_heads"]
    a_scale, a_zp = approx_ref.qparams(*config["act_range"], device=device)
    theta = arch.get("rope_theta", 10000.0)

    fmax = (torch.finfo(hold).max if hold.is_floating_point
            and torch.finfo(hold).bits == 8 else None)

    def r(t):
        if fmax is not None:
            t = t.clamp(-fmax, fmax)
        return t.to(hold).to(torch.float32)

    def lin(x, wt):
        return r(approx_ref.linear(x, wt, a_scale, a_zp, ap["mode"], ap["m"],
                                   ap["use_cv"]))

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {"kv": [[] for _ in seqs]}
    try:
        # the float weights (the table) as served
        table = weights.lm_table(arch, seed, device).to(getattr(
            torch, config["float_weight_dtype"])).to(torch.float32)
        xs = [r(table[torch.as_tensor(s, device=device)]) for s in seqs]
        depth = arch["n_layers"] if logits_at is not None else kv_layers
        for i in range(depth):
            w = weights.lm_layer(arch, seed, i, device)
            pk = {n: approx_ref.pack(w[n], None, ap["mode"], ap["m"])
                  for n in w}
            del w
            for j, x in enumerate(xs):
                t = x.shape[0]
                h = r(norm(arch["norm"], x))
                q = r(rope(lin(h, pk["q"]).view(t, arch["n_heads"], hd), theta))
                k = r(rope(lin(h, pk["k"]).view(t, arch["kv_heads"], hd), theta))
                v = lin(h, pk["v"]).view(t, arch["kv_heads"], hd)
                if i < kv_layers:
                    out["kv"][j].append((k, v))
                x = r(x + lin(r(attention(q, k, v, r)), pk["o"]))
                h = r(norm(arch["norm"], x))
                gate = r(F.silu(lin(h, pk["gate"])))
                xs[j] = r(x + lin(r(gate * lin(h, pk["up"])), pk["down"]))
            del pk
        if logits_at is not None:
            out["logits"] = [
                r(r(norm(arch["norm"], x[torch.as_tensor(at, dtype=torch.long,
                                                          device=device)]))
                  @ table.T) for x, at in zip(xs, logits_at)]
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev

