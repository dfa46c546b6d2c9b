"""Optimizer substrate (port of ``repro.optim``): AdamW with decoupled
weight decay, global-norm clipping, LR schedules, and int8 error-feedback
gradient compression."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.grad_compress import (CompressorState,
                                             compress_decompress,
                                             compressor_init)
from repro_torch.optim.schedules import constant_lr, warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "warmup_cosine", "constant_lr", "CompressorState",
           "compressor_init", "compress_decompress"]
