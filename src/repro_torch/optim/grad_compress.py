"""int8 error-feedback gradient compression (port of
``repro.optim.grad_compress``).

Each gradient leaf (plus the residual carried from the last step) is
quantized to int8 with a per-leaf absmax scale and dequantized; the
quantization residual is carried to the next step, so the bias vanishes
over steps.  This is the numerics a data-parallel all-reduce of int8
gradients would see (the collective is ``runtime.overlap.
compressed_psum``).  ``round`` is half-to-even, as ``jnp.round``."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_map

CompressorState = Any  # a tree of float32 residuals shaped like the grads


def compressor_init(grads_like: Any) -> CompressorState:
    return tree_map(lambda _, g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads_like)


def _quantize_leaf(g: torch.Tensor, reduce_max=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(g))
    if reduce_max is not None:
        amax = reduce_max(amax)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clip(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads: Any, state: CompressorState,
                        reduce_max=None) -> tuple[Any, CompressorState]:
    """Error-feedback int8 round trip: (decompressed grads, new
    residuals).  ``reduce_max`` makes a leaf's absmax the whole leaf's
    where ``grads`` hold a rank's pieces (a sharded step)."""
    def leaf(_, g, r):
        g32 = g.to(torch.float32) + r
        q, scale = _quantize_leaf(g32, reduce_max)
        deq = q.to(torch.float32) * scale
        return deq.to(g.dtype), g32 - deq

    out = tree_map(leaf, grads, state)
    return (tree_map(lambda _, t: t[0], out),
            tree_map(lambda _, t: t[1], out))
