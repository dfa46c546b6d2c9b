"""Uniform model API (port of ``repro.models.registry``): the lock-step
and slot-serving surfaces of every ported arch."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    device: torch.device
    init: Callable  # (seed) -> float params on ``device``
    #: (params, {"tokens": (B, T)} or {"embeds": (B, T, D)}, optionally
    #: with "positions") -> logits (B, T, V) float32
    forward: Callable
    #: (params, the same batch with "labels" (B, T) and an optional "mask")
    #: -> the mean cross-entropy, on the training path (plain attention and
    #: WKV, which have backward passes)
    train_loss: Callable
    #: (params, the same batch, max_len, cache_dtype) -> (logits (B, V),
    #: cache)
    prefill: Callable
    #: (params, tokens (B, 1), cache) -> (logits (B, V), cache updated in
    #: place)
    decode_step: Callable
    #: (batch, max_len, dtype) -> lock-step cache on ``device``
    init_cache: Callable
    #: (slots, max_len, dtype) -> pooled slot cache on ``device``; None for
    #: an arch without a slot surface (the engine refuses it)
    init_slot_cache: Callable | None = None
    #: (params, tokens, cache, n_valid, block_tables=None, kv_len=None) ->
    #: (logits, cache updated in place); block_tables selects the paged
    #: layout (``repro_torch.serving.paged``)
    decode_slots: Callable | None = None
    #: (num_blocks, block_size, slots, dtype) -> block-pool cache on
    #: ``device``; None for an arch without a KV sequence to page
    init_paged_cache: Callable | None = None

    @property
    def supports_slots(self) -> bool:
        """True when the arch can serve through the slot engine: an
        encoder-only arch (no decode step) cannot, nor can a
        sliding-window or parallel-SSM arch (:attr:`slot_refusal`)."""
        if not self.cfg.has_decode:
            return False
        return self.cfg.rwkv or self.slot_refusal is None

    @property
    def slot_refusal(self) -> str | None:
        """Why a transformer arch has no slot surface (the reference's
        ``_slot_unsupported`` reasons), or None."""
        if self.cfg.rwkv:
            return None
        from repro_torch.models.lm import _slot_unsupported

        return _slot_unsupported(self.cfg)

    @property
    def supports_paged(self) -> bool:
        """True when the arch can serve through the paged KV layout:
        recurrent archs (RWKV) hold per-slot state, not a KV sequence, so
        there is nothing to page."""
        return self.init_paged_cache is not None and self.supports_slots


def build_model(cfg: ArchConfig, device=None) -> ModelApi:
    """The model API on ``device`` (default ``cuda``; raises without it)."""
    dev = resolve_device(device)
    if cfg.rwkv:
        from repro_torch.models import rwkv_lm as m

        return ModelApi(
            cfg=cfg, device=dev,
            init=lambda seed=0: m.init_params(cfg, seed, dev),
            forward=lambda p, b: m.forward(p, b, cfg),
            train_loss=lambda p, b: m.train_loss(p, b, cfg),
            prefill=lambda p, b, max_len=0, cache_dtype=torch.bfloat16:
                m.prefill(p, b, cfg, max_len, cache_dtype),
            decode_step=lambda p, t, c: m.decode_step(p, t, c, cfg),
            init_cache=lambda batch, max_len=0, dtype=torch.bfloat16:
                m.init_cache(cfg, batch, max_len, dtype, dev),
            init_slot_cache=lambda slots, max_len=0, dtype=torch.bfloat16:
                m.init_slot_cache(cfg, slots, max_len, dtype, dev),
            decode_slots=lambda p, t, c, n_valid: m.decode_slots(p, t, c, cfg,
                                                                 n_valid),
        )
    from repro_torch.models import lm as m

    slots = m._slot_unsupported(cfg) is None
    return ModelApi(
        cfg=cfg, device=dev,
        init=lambda seed=0: m.init_params(cfg, seed, dev),
        forward=lambda p, b: m.forward(p, b, cfg),
        train_loss=lambda p, b: m.train_loss(p, b, cfg),
        prefill=lambda p, b, max_len, cache_dtype=torch.bfloat16:
            m.prefill(p, b, cfg, max_len, cache_dtype),
        decode_step=lambda p, t, c: m.decode_step(p, t, c, cfg),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16:
            m.init_cache(cfg, batch, max_len, dtype, dev),
        init_slot_cache=(lambda n, max_len, dtype=torch.bfloat16:
                         m.init_slot_cache(cfg, n, max_len, dtype, dev))
        if slots else None,
        decode_slots=(lambda p, t, c, n_valid, block_tables=None, kv_len=None:
                      m.decode_slots(p, t, c, cfg, n_valid, block_tables,
                                     kv_len)) if slots else None,
        init_paged_cache=(lambda num_blocks, block_size, n,
                          dtype=torch.bfloat16: m.init_paged_slot_cache(
                              cfg, num_blocks, block_size, n, dtype, dev))
        if slots else None,
    )
