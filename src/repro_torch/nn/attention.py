"""GQA attention pieces of the slot-serving path (port of the GQA half of
``repro.nn.attention``): config, RoPE angles, the Q/K/V projection and the
KV-cache storage casts.  The score/softmax/context math lives in
``repro_torch.models.lm._gqa_slots``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.approx_linear import dense, dense_group, init_dense
from repro_torch.nn.layers import apply_rope, rope_angles


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    causal: bool = True
    rope_theta: float = 10000.0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


def init_attention(cfg: AttnConfig, *, generator, device=None) -> dict:
    shapes = (("q", cfg.d_model, cfg.q_dim), ("k", cfg.d_model, cfg.kv_dim),
              ("v", cfg.d_model, cfg.kv_dim), ("o", cfg.q_dim, cfg.d_model))
    return {name: init_dense(k, n, generator=generator, bias=False,
                             device=device) for name, k, n in shapes}


def _angles(cfg: AttnConfig, positions: torch.Tensor):
    """positions (B, T) int -> RoPE (cos, sin)."""
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def _project_qkv(p: dict, x: torch.Tensor, cfg: AttnConfig, angles):
    b, t, _ = x.shape
    if "qkv" in p:  # fan-out-fused serving pack
        qkv = dense_group(p["qkv"], x)
        q, k, v = qkv["q"], qkv["k"], qkv["v"]
    else:
        q, k, v = dense(p["q"], x), dense(p["k"], x), dense(p["v"], x)
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.kv_heads, cfg.head_dim)
    if angles is not None:
        cos, sin = angles
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k, v


def _to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype)


def _from_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype)
