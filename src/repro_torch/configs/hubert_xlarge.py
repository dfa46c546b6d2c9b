"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16, head_dim 80)
d_ff=5120 vocab=504 — encoder-only transformer (the wav2vec2 layout):
parametric layernorm, gelu MLP with biases, no positional rotation,
bidirectional attention, untied head.  [arXiv:2106.07447]

The convolutional waveform frontend is a stub, as in the reference: inputs
are precomputed frame embeddings (B, T, d_model).  Encoder-only: no decode
step in the engine (the slot pool refuses it).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    kv_heads=16,
    d_ff=5120,
    vocab=504,
    norm="layernorm",
    mlp="gelu",
    rope="none",
    causal=False,
)
