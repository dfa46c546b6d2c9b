"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff_expert=1408
vocab=102400, MLA kv_lora=512, MoE 64 routed experts top-6 + 2 shared,
first layer dense (d_ff 10944).  [arXiv:2405.04434; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    d_ff=10944,  # the first (dense) layer's FFN width
    vocab=102400,
    attn="mla",
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mlp="moe",
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    d_ff_expert=1408,
    first_dense_layers=1,
    remat="full",
)
