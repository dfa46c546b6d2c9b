"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16)
d_ff_expert=1408 vocab=163840, MoE 64 routed experts top-6 + 2 shared
(kimi/moonlight family).  [hf:moonshotai/Moonlight-16B-A3B]

The assigned config specifies GQA (kv=16) and 48 layers; all layers MoE.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    mlp="moe",
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    d_ff_expert=1408,
    first_dense_layers=0,
)
