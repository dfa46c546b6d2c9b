"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch, untied LM head.  [arXiv:2401.02954; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=102400,
    rope_theta=10000.0,
)
