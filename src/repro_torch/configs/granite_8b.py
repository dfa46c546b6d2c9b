"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code model (rope theta 1e7, tied embeddings).
[arXiv:2405.04324; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=49152,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
    remat="full",
)
