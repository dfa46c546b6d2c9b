"""Common layers: norms, embeddings, swiglu and gelu MLPs, rotary
embeddings (RoPE, and qwen2-vl's M-RoPE).

Port of ``repro.nn.layers`` (the parts the dense GQA and RWKV6 paths run).  Linear
leaves are ``{"w": (k, n)[, "b": (n,)]}`` or packed modules, consumed by
:func:`repro_torch.core.approx_linear.dense`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.approx_linear import dense, dense_group, init_dense


def init_rmsnorm(d: int, device=None) -> dict:
    return {"scale": torch.ones(d, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"]).to(dt)


def layernorm(p: dict | None, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parametric LN, or non-parametric (olmo-style) when ``p`` is None."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if p is not None:
        x = x * p["scale"] + p["bias"]
    return x.to(dt)


def init_norm(kind: str, d: int, device=None) -> dict:
    """Norm parameters: a scale for rmsnorm, scale and bias for the
    parametric LN, none for the non-parametric one."""
    if kind == "rmsnorm":
        return init_rmsnorm(d, device)
    if kind == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    if kind == "nonparametric_ln":
        return {}
    raise ValueError(f"unknown norm {kind!r}")


def apply_norm(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(p, x)
    if kind == "layernorm":
        return layernorm(p, x)
    if kind == "nonparametric_ln":
        return layernorm(None, x)
    raise ValueError(f"unknown norm {kind!r}")


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def init_swiglu(d: int, ff: int, *, generator, device=None) -> dict:
    return {name: init_dense(k, n, generator=generator, bias=False,
                             device=device)
            for name, (k, n) in (("gate", (d, ff)), ("up", (d, ff)),
                                 ("down", (ff, d)))}


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "gateup" in p:  # fan-out-fused serving pack
        gu = dense_group(p["gateup"], x)
        g, u = gu["gate"], gu["up"]
    else:
        g = dense(p["gate"], x, name="gate")
        u = dense(p["up"], x, name="up")
    return dense(p["down"], F.silu(g) * u, name="down")


def init_gelu_mlp(d: int, ff: int, *, generator, device=None) -> dict:
    return {name: init_dense(k, n, generator=generator, bias=True,
                             device=device)
            for name, (k, n) in (("up", (d, ff)), ("down", (ff, d)))}


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh form, so this is too (the exact
    erf form is a different function)."""
    return dense(p["down"], F.gelu(dense(p["up"], x, name="up"),
                                   approximate="tanh"), name="down")


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """cos/sin for integer positions (..., T) -> (..., T, head_dim//2)."""
    ang = positions[..., None].to(torch.float32) * rope_freqs(
        head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D) with cos/sin (B, T, D//2); rotate-half convention."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos, sin = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mrope_angles(positions_3d: torch.Tensor, head_dim: int,
                 sections: tuple[int, int, int], theta: float = 10000.0):
    """qwen2-vl M-RoPE: the head_dim // 2 frequency slots are split into
    (temporal, height, width) sections, each driven by its own position id
    of ``positions_3d`` (3, B, T).  Returns cos/sin (B, T, head_dim // 2),
    the sections concatenated in [t | h | w] order; with three equal ids it
    is plain RoPE."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover "
                         f"head_dim {head_dim} // 2")
    freqs = rope_freqs(head_dim, theta, positions_3d.device)
    parts_cos, parts_sin, lo = [], [], 0
    for i, n in enumerate(sections):
        ang = positions_3d[i][..., None].to(torch.float32) * freqs[lo:lo + n]
        parts_cos.append(torch.cos(ang))
        parts_sin.append(torch.sin(ang))
        lo += n
    return torch.cat(parts_cos, dim=-1), torch.cat(parts_sin, dim=-1)
