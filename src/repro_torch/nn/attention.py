"""GQA attention (port of the GQA half of ``repro.nn.attention``): config,
RoPE / M-RoPE angles (or none), the Q/K/V projection (optional QKV bias
and per-head qk-norm), the plain full-sequence attention ``_sdpa``
(causal or bidirectional), the KV-cache storage casts
(bf16, f32, or int8 fixed point) and the one-token decode step.  The
slot attention lives in ``repro_torch.models.lm._gqa_slots``; the prefill
attention on the card is the flash kernel
(:mod:`repro_torch.kernels.flash_attention`).

GQA cache: ``{"k": (B, Hkv, S, hd), "v": (B, Hkv, S, hd), "pos": int}``.
:func:`attention_decode_step` writes it IN PLACE.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.approx_linear import dense, dense_group, init_dense
from repro_torch.nn.layers import (apply_rope, init_rmsnorm, mrope_angles,
                                   rmsnorm, rope_angles)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    causal: bool = True
    qk_norm: bool = False
    rope: Literal["rope", "mrope", "none"] = "rope"
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    qkv_bias: bool = False

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


def init_attention(cfg: AttnConfig, *, generator, device=None) -> dict:
    shapes = (("q", cfg.d_model, cfg.q_dim, cfg.qkv_bias),
              ("k", cfg.d_model, cfg.kv_dim, cfg.qkv_bias),
              ("v", cfg.d_model, cfg.kv_dim, cfg.qkv_bias),
              ("o", cfg.q_dim, cfg.d_model, False))
    p = {name: init_dense(k, n, generator=generator, bias=bias, device=device)
         for name, k, n, bias in shapes}
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(cfg.head_dim, device)
        p["k_norm"] = init_rmsnorm(cfg.head_dim, device)
    return p


def _angles(cfg: AttnConfig, positions: torch.Tensor):
    """positions (B, T) int, or (3, B, T) for M-RoPE -> (cos, sin), or None
    without positional rotation."""
    if cfg.rope == "none":
        return None
    if cfg.rope == "mrope":
        if positions.dim() == 2:  # text only: the same ids on every axis
            positions = positions[None].expand(3, *positions.shape)
        return mrope_angles(positions, cfg.head_dim, cfg.mrope_sections,
                            cfg.rope_theta)
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _project_qkv(p: dict, x: torch.Tensor, cfg: AttnConfig, angles):
    b, t, _ = x.shape
    if "qkv" in p:  # fan-out-fused serving pack
        qkv = dense_group(p["qkv"], x)
        q, k, v = qkv["q"], qkv["k"], qkv["v"]
    else:
        q = dense(p["q"], x, name="q")
        k = dense(p["k"], x, name="k")
        v = dense(p["v"], x, name="v")
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.kv_heads, cfg.head_dim)
    if cfg.qk_norm:  # per head, after the reshape and before RoPE
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if angles is not None:
        cos, sin = angles
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k, v


#: fixed-point scale of int8 KV caches (values are O(1) after qk-norm and
#: RoPE; steps of 1/16)
KV_INT8_SCALE = 16.0


def _to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.int8:
        return torch.clip(torch.round(x * KV_INT8_SCALE), -127,
                          127).to(torch.int8)
    return x.to(dtype)


def _from_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if x.dtype == torch.int8:
        return x.to(dtype) * (1.0 / KV_INT8_SCALE)
    return x.to(dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
          window: int | None = None) -> torch.Tensor:
    """Grouped-head attention without materializing repeated KV heads.
    q (B, Tq, Hq, d), k/v (B, Tk, Hkv, d); query rows aligned to the END of
    the key axis."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, tq, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * (d ** -0.5)
    q_pos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    k_pos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return ctx.reshape(b, tq, hq, d)


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "pos": 0}


def attention_decode_step(p: dict, x: torch.Tensor, cache: dict,
                          cfg: AttnConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode against the (B, Hkv, S, d) cache, x (B, 1, D).
    Writes the token's K/V at ``cache["pos"]`` IN PLACE (the reference
    returns a new cache) and returns (y, cache with pos + 1)."""
    b = x.shape[0]
    pos = int(cache["pos"])
    s = cache["k"].shape[2]
    if pos >= s:
        raise ValueError(f"decode write at {pos} past the cache capacity {s}")
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, _angles(cfg, positions))
    cache["k"][:, :, pos] = _to_cache(k[:, 0], cache["k"].dtype)
    cache["v"][:, :, pos] = _to_cache(v[:, 0], cache["v"].dtype)
    hq, hkv, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    qg = q.reshape(b, 1, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qg,
                          _from_cache(cache["k"], q.dtype)) * (d ** -0.5)
    mask = torch.arange(s, device=x.device) < pos + 1
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    ctx = torch.einsum("bhgqk,bhkd->bqhgd", probs,
                       _from_cache(cache["v"], q.dtype))
    y = dense(p["o"], ctx.reshape(b, 1, cfg.q_dim), name="o")
    return y, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
