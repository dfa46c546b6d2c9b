"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per layer,
sliding-window attention (window 1024).  [arXiv:2411.13676; hf]

The reference's simplifications, kept: meta-tokens and the few
global-attention layers are omitted; all layers use SWA + parallel SSM, so
the arch is sub-quadratic.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    window=1024,
    parallel_ssm=True,
    ssm_state=16,
    ssm_expand=2,
    remat="full",
)
