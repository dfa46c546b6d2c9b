"""Attention (port of ``repro.nn.attention``).

  * GQA: config, RoPE / M-RoPE angles (or none), the Q/K/V projection
    (optional QKV bias and per-head qk-norm), the plain full-sequence
    attention ``_sdpa`` (causal, bidirectional or sliding-window), the
    KV-cache storage casts (bf16, f32, or int8 fixed point), the one-token
    decode step and the sliding-window decode over a ring cache of length
    W (hymba).
    The prefill attention on the card is the flash kernel
    (:mod:`repro_torch.kernels.flash_attention`).
  * MLA, DeepSeek-V2's multi-head latent attention: the decompressed
    prefill and the weight-absorbed decode over the latent cache.  Both
    are plain PyTorch, as the reference's are plain jnp.

The slot attention of both lives in ``repro_torch.models.lm``
(``_gqa_slots``, ``_mla_slots``).  Caches:

  GQA: ``{"k": (B, Hkv, S, hd), "v": (B, Hkv, S, hd), "pos": int}``
  (a sliding-window ring: S = W, absolute position a at slot a mod W)
  MLA: ``{"latent": (B, S, r), "rope": (B, S, dr), "pos": int}``

:func:`attention_decode_step`, :func:`attention_decode_ring` and
:func:`mla_decode_step` write them IN PLACE.
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
    window: int | None = None  # sliding-window size (hymba)
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
    j = torch.arange(s, device=x.device)
    mask = j < pos + 1
    if cfg.window is not None:
        mask = mask & (j > pos - cfg.window)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    ctx = torch.einsum("bhgqk,bhkd->bqhgd", probs,
                       _from_cache(cache["v"], q.dtype))
    y = dense(p["o"], ctx.reshape(b, 1, cfg.q_dim), name="o")
    return y, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def attention_decode_ring(p: dict, x: torch.Tensor, cache: dict,
                          cfg: AttnConfig) -> tuple[torch.Tensor, dict]:
    """Sliding-window decode against a RING cache of length W, x (B, 1, D),
    k/v (B, Hkv, W, d).

    Invariant: absolute position a lives at slot a mod W, so the ring only
    ever holds the last W positions and the window mask is implicit; slots
    not yet written (pos < W) are masked through the recovered absolute
    position abs_j = pos - ((pos - j) mod W) >= 0.  Writes the token's K/V
    at slot pos mod W IN PLACE through the cache's storage cast (the
    reference writes a raw cast: ROADMAP queue 3) and returns (y, cache
    with pos + 1)."""
    b = x.shape[0]
    pos = int(cache["pos"])
    w_len = cache["k"].shape[2]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, _angles(cfg, positions))
    slot = pos % w_len
    cache["k"][:, :, slot] = _to_cache(k[:, 0], cache["k"].dtype)
    cache["v"][:, :, slot] = _to_cache(v[:, 0], cache["v"].dtype)
    hq, hkv, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    qg = q.reshape(b, 1, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qg,
                          _from_cache(cache["k"], q.dtype)) * (d ** -0.5)
    j = torch.arange(w_len, device=x.device)
    mask = pos - torch.remainder(pos - j, w_len) >= 0
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    ctx = torch.einsum("bhgqk,bhkd->bqhgd", probs,
                       _from_cache(cache["v"], q.dtype))
    y = dense(p["o"], ctx.reshape(b, 1, cfg.q_dim), name="o")
    return y, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


# ---------------------------------------------------------------------------
# MLA: DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def init_mla(cfg: MLAConfig, *, generator, device=None) -> dict:
    """q, the latent down-projection ``kv_a`` (latent | shared rope key)
    with its norm, the up-projection ``kv_b`` (per-head nope key | value)
    and o.  ``kv_a`` and ``kv_b`` stay float under the serving rules: the
    absorbed decode reads ``kv_b``'s raw matrix."""
    h = cfg.n_heads
    shapes = (("q", cfg.d_model, h * cfg.qk_head_dim),
              ("kv_a", cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim),
              ("kv_b", cfg.kv_lora_rank,
               h * (cfg.qk_nope_dim + cfg.v_head_dim)),
              ("o", h * cfg.v_head_dim, cfg.d_model))
    p = {name: init_dense(k, n, generator=generator, bias=False,
                          device=device) for name, k, n in shapes}
    p["kv_a_norm"] = init_rmsnorm(cfg.kv_lora_rank, device)
    return p


def _mla_q(p: dict, x: torch.Tensor, cfg: MLAConfig, positions):
    """(q_nope (B, T, H, dn), q_rope (B, T, H, dr) rotated)."""
    b, t, _ = x.shape
    q = dense(p["q"], x, name="q").reshape(b, t, cfg.n_heads,
                                           cfg.qk_head_dim)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    cos, sin = rope_angles(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_latent(p: dict, x: torch.Tensor, cfg: MLAConfig, positions):
    """(latent (B, T, r) normed, k_rope (B, T, dr) rotated, shared by the
    heads)."""
    kv_a = dense(p["kv_a"], x, name="kv_a")
    latent = rmsnorm(p["kv_a_norm"], kv_a[..., :cfg.kv_lora_rank])
    k_rope = kv_a[..., cfg.kv_lora_rank:][:, :, None, :]
    cos, sin = rope_angles(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return latent, apply_rope(k_rope, cos, sin)[:, :, 0, :]


def _mla_absorbed(p: dict, cfg: MLAConfig):
    """``kv_b``'s matrix split per head: (W_UK (r, H, dn), W_UV (r, H,
    dv))."""
    w_b = p["kv_b"]["w"].reshape(cfg.kv_lora_rank, cfg.n_heads,
                                 cfg.qk_nope_dim + cfg.v_head_dim)
    return w_b[..., :cfg.qk_nope_dim], w_b[..., cfg.qk_nope_dim:]


def _ein(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-operand einsum in the promoted dtype (``jnp.einsum``'s rule: a
    bf16 serving leaf meets float32 activations in float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def mla_attend_latent(p: dict, q_nope, q_rope, lat, rope, mask,
                      cfg: MLAConfig, dtype) -> torch.Tensor:
    """Weight-absorbed attention in latent space: q~ = q_nope W_UK a head,
    logits = q~ . latent + q_rope . k_rope, ctx = (probs . latent) W_UV.
    q (B, Tq, H, .), lat (B, S, r), rope (B, S, dr), mask broadcastable to
    (B, H, Tq, S).  Returns ctx (B, Tq, H * dv)."""
    w_uk, w_uv = _mla_absorbed(p, cfg)
    q_lat = _ein("bqhd,rhd->bqhr", q_nope, w_uk)
    logits = (_ein("bqhr,bkr->bhqk", q_lat, lat)
              + _ein("bqhd,bkd->bhqk", q_rope, rope)
              ) * cfg.qk_head_dim ** -0.5
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(dtype)
    ctx_lat = _ein("bhqk,bkr->bqhr", probs, lat)
    ctx = _ein("bqhr,rhd->bqhd", ctx_lat, w_uv)
    return ctx.reshape(ctx.shape[0], ctx.shape[1], -1)


def mla_kv(p: dict, latent: torch.Tensor, cfg: MLAConfig):
    """Decompressed per-head keys and values from the (B, T, r) latent:
    (k_nope (B, T, H, dn), v (B, T, H, dv))."""
    b, t, _ = latent.shape
    kv = dense(p["kv_b"], latent, name="kv_b").reshape(
        b, t, cfg.n_heads, cfg.qk_nope_dim + cfg.v_head_dim)
    return kv[..., :cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim:]


def mla_attend_full(q_nope, q_rope, k_nope, k_rope, v, q_off: int,
                    cfg: MLAConfig, dtype) -> torch.Tensor:
    """Causal decompressed attention of the queries at positions q_off,
    q_off + 1, ... over every key: ctx (B, Tq, H, dv)."""
    t = k_nope.shape[1]
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)
              ) * cfg.qk_head_dim ** -0.5
    q_pos = q_off + torch.arange(q_nope.shape[1], device=k_nope.device)
    mask = torch.arange(t, device=k_nope.device)[None, :] <= q_pos[:, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mla_prefill(p: dict, x: torch.Tensor, cfg: MLAConfig,
                positions=None) -> torch.Tensor:
    """Decompressed path: per-head K/V materialized from the latent."""
    b, t, _ = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device).expand(b, t)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    latent, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope, v = mla_kv(p, latent, cfg)
    ctx = mla_attend_full(q_nope, q_rope, k_nope, k_rope, v, 0, cfg, x.dtype)
    return dense(p["o"], ctx.reshape(b, t, -1), name="o")


def init_mla_cache(cfg: MLAConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {"latent": torch.zeros(batch, max_len, cfg.kv_lora_rank,
                                  dtype=dtype, device=device),
            "rope": torch.zeros(batch, max_len, cfg.qk_rope_dim, dtype=dtype,
                                device=device),
            "pos": 0}


def mla_decode_step(p: dict, x: torch.Tensor, cache: dict,
                    cfg: MLAConfig) -> tuple[torch.Tensor, dict]:
    """One-token weight-absorbed decode, x (B, 1, D): attention runs in
    latent space over the (B, S, r) cache.  Writes the token's latent and
    rope key at ``cache["pos"]`` IN PLACE with the reference's raw cast
    (no int8 fixed point: ROADMAP queue 3), returns (y, cache with pos +
    1)."""
    b = x.shape[0]
    pos = int(cache["pos"])
    s = cache["latent"].shape[1]
    if pos >= s:
        raise ValueError(f"decode write at {pos} past the cache capacity {s}")
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    latent_t, k_rope_t = _mla_latent(p, x, cfg, positions)
    cache["latent"][:, pos] = latent_t[:, 0].to(cache["latent"].dtype)
    cache["rope"][:, pos] = k_rope_t[:, 0].to(cache["rope"].dtype)
    mask = torch.arange(s, device=x.device) < pos + 1
    ctx = mla_attend_latent(p, q_nope, q_rope, cache["latent"].to(x.dtype),
                            cache["rope"].to(x.dtype), mask, cfg, x.dtype)
    y = dense(p["o"], ctx, name="o")
    return y, {"latent": cache["latent"], "rope": cache["rope"],
               "pos": pos + 1}
