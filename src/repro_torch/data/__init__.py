"""Data pipeline: procedural datasets (no downloads) and a sharded,
prefetching, deterministically-resumable host loader."""

from repro_torch.data.synthetic import lm_batch_stream, SyntheticLMConfig
from repro_torch.data.vision import make_vision_dataset, VisionConfig
from repro_torch.data.loader import ShardedLoader

__all__ = [
    "lm_batch_stream",
    "SyntheticLMConfig",
    "make_vision_dataset",
    "VisionConfig",
    "ShardedLoader",
]
