"""RWKV6 "Finch" blocks (arXiv:2404.05892), port of ``repro.nn.rwkv``.

Time-mix: token-shift DDLerp (low-rank data-dependent interpolation between
x_t and x_{t-1} per r/k/v/w/g stream), data-dependent per-channel decay
w_t = exp(-exp(.)), the WKV linear-attention recurrence, per-head GroupNorm,
silu-gated output.  Channel-mix: token-shift + squared-ReLU FFN with
receptance gate.

Prefill's WKV goes through :func:`repro_torch.kernels.rwkv6_scan.rwkv6_scan`:
the hand-written scan kernel on the card, its plain version
(:func:`wkv_chunked`, the reference's chunked algebra) on the CPU.  Decode
keeps (shift, state) per layer and is O(1) per token (:func:`time_mix_step`,
plain PyTorch as in the reference).

Projections are ``dense`` leaves (approximable); the recurrence and the
normalization are exact, matching the paper's array/non-array split.  The
DDLerp and decay low-rank products (``mix_w1/mix_w2/decay_w1/decay_w2``) are
plain arrays, never packed, and run as ``torch.matmul``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.approx_linear import dense, init_dense
from repro_torch.kernels import rwkv6_scan as rsk
from repro_torch.kernels.rwkv6_scan import wkv_chunked  # noqa: F401  (the plain path)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    d_ff: int
    head_dim: int = 64
    mix_rank: int = 32  # DDLerp LoRA dim (TIME_MIX_EXTRA_DIM)
    decay_rank: int = 64  # decay LoRA dim (TIME_DECAY_EXTRA_DIM)
    wkv_chunk: int = 32

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def _normal(shape, std, mean, gen, device):
    return torch.randn(shape, generator=gen, device=device) * std + mean


def init_time_mix(cfg: RWKVConfig, *, generator, device=None) -> dict:
    """The reference's distributions (its random numbers differ)."""
    d, h, g = cfg.d_model, cfg.n_heads, generator
    p = {
        "mu_x": torch.full((d,), 0.5, device=device),
        "mu_rkvwg": _normal((5, d), 0.02, 0.5, g, device),
        "mix_w1": _normal((d, 5 * cfg.mix_rank), 0.02, 0.0, g, device),
        "mix_w2": _normal((5, cfg.mix_rank, d), 0.02, 0.0, g, device),
        "decay_base": _normal((d,), 0.5, -6.0, g, device),
        "decay_w1": _normal((d, cfg.decay_rank), 0.02, 0.0, g, device),
        "decay_w2": _normal((cfg.decay_rank, d), 0.02, 0.0, g, device),
        "bonus": _normal((h, cfg.head_dim), 0.02, 0.0, g, device),
    }
    for name in ("r", "k", "v", "g", "out"):
        p[name] = init_dense(d, d, generator=g, bias=False, device=device)
    p["ln_x_scale"] = torch.ones(d, device=device)
    p["ln_x_bias"] = torch.zeros(d, device=device)
    return p


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """matmul in the promoted dtype, as ``jnp.matmul`` of mixed operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _group_norm_heads(x: torch.Tensor, scale, bias, n_heads: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with one group per head.  x (B, T, d_model)."""
    b, t, d = x.shape
    xh = x.reshape(b, t, n_heads, d // n_heads).to(torch.float32)
    mu = xh.mean(-1, keepdim=True)
    var = ((xh - mu) ** 2).mean(-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b, t, d) * scale + bias).to(x.dtype)


def _ddlerp(p: dict, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token-shift interpolation -> (xw, xk, xv, xr, xg)."""
    dx = x_prev - x
    xx = x + dx * p["mu_x"]
    low = torch.tanh(_mm(xx, p["mix_w1"]))  # (B, T, 5*rank)
    low = low.reshape(*low.shape[:-1], 5, -1)  # (B, T, 5, rank)
    w2 = p["mix_w2"]
    dt = torch.promote_types(low.dtype, w2.dtype)
    deltas = torch.einsum("btfr,frd->fbtd", low.to(dt), w2.to(dt))
    return [x + dx * (p["mu_rkvwg"][i] + deltas[i]) for i in range(5)]


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay in (0, 1): exp(-exp(base + lora)), float32."""
    lora = _mm(torch.tanh(_mm(xw, p["decay_w1"])), p["decay_w2"])
    return torch.exp(-torch.exp((p["decay_base"] + lora).to(torch.float32)))


def time_mix(p: dict, x: torch.Tensor, cfg: RWKVConfig):
    """Prefill time-mix from a zero state, x (B, T, D).  Returns
    (out, last token (B, D), WKV state (B, H, hd, hd) float32)."""
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)
    r = dense(p["r"], xr).reshape(b, t, h, hd)
    k = dense(p["k"], xk).reshape(b, t, h, hd)
    v = dense(p["v"], xv).reshape(b, t, h, hd)
    g = dense(p["g"], xg)
    w = _decay(p, xw).reshape(b, t, h, hd)
    out, state = rsk.rwkv6_scan(r, k, v, w, p["bonus"], chunk=cfg.wkv_chunk)
    out = out.reshape(b, t, d).to(x.dtype)
    out = _group_norm_heads(out, p["ln_x_scale"], p["ln_x_bias"], h)
    out = out * F.silu(g)
    return dense(p["out"], out), x[:, -1, :], state


def time_mix_step(p: dict, x: torch.Tensor, cfg: RWKVConfig, shift_state,
                  wkv_state):
    """Single-token time-mix: x (B, 1, D); O(1) state update."""
    b, _, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    xw, xk, xv, xr, xg = _ddlerp(p, x, shift_state[:, None, :])
    f32 = torch.float32
    r = dense(p["r"], xr).reshape(b, h, hd)
    k = dense(p["k"], xk).reshape(b, h, hd)
    v = dense(p["v"], xv).reshape(b, h, hd)
    g = dense(p["g"], xg)
    w = _decay(p, xw).reshape(b, h, hd)
    kv = k.to(f32)[..., :, None] * v.to(f32)[..., None, :]
    att = wkv_state + p["bonus"][None, :, :, None].to(f32) * kv
    out = torch.einsum("bhk,bhkv->bhv", r.to(f32), att)
    new_state = w[..., :, None].to(f32) * wkv_state + kv
    out = out.reshape(b, 1, d).to(x.dtype)
    out = _group_norm_heads(out, p["ln_x_scale"], p["ln_x_bias"], h)
    out = out * F.silu(g)
    return dense(p["out"], out), x[:, -1, :], new_state


def init_channel_mix(cfg: RWKVConfig, *, generator, device=None) -> dict:
    d, g = cfg.d_model, generator
    return {
        "mu_k": torch.full((d,), 0.5, device=device),
        "mu_r": torch.full((d,), 0.5, device=device),
        "key": init_dense(d, cfg.d_ff, generator=g, bias=False, device=device),
        "value": init_dense(cfg.d_ff, d, generator=g, bias=False,
                            device=device),
        "receptance": init_dense(d, d, generator=g, bias=False, device=device),
    }


def channel_mix(p: dict, x: torch.Tensor, shift_state=None):
    """x (B, T, D); ``shift_state`` (B, D) the previous token (zero when
    None).  Returns (out, last token (B, D))."""
    if shift_state is None:
        shift_state = torch.zeros_like(x[:, 0])
    x_prev = torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)
    dx = x_prev - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    k = torch.square(torch.relu(dense(p["key"], xk)))
    kv = dense(p["value"], k)
    return torch.sigmoid(dense(p["receptance"], xr)) * kv, x[:, -1, :]
