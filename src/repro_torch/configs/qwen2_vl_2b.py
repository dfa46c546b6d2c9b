"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE (sections 16/24/24 over head_dim 128), QKV bias,
tied embeddings, rope theta 1e6.  [arXiv:2409.12191; hf]

The vision frontend is a stub, as in the reference: prefill consumes
precomputed patch/text embeddings (B, T, d_model) plus 3D M-RoPE position
ids (3, B, T); decode consumes generated token ids through the embedding
table, its positions continuing from the cache's and broadcast to the
three axes.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    rope="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
    remat="full",
)
