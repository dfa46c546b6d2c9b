"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — Finch: data-dependent decay, DDLerp token shift, WKV
linear-attention recurrence.  [arXiv:2404.05892]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # wkv heads = d_model / rwkv_head_dim
    kv_heads=32,
    d_ff=7168,
    vocab=65536,
    attn="none",
    rwkv=True,
    rwkv_head_dim=64,
    norm="layernorm",
    remat="full",
)
