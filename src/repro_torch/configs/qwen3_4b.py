"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm (per-head RMSNorm on q/k), GQA, explicit head_dim=128, tied
embeddings, rope theta 1e6.  [hf:Qwen/Qwen3-8B family; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    remat="full",
)
