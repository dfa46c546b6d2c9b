"""Uniform model API (port of ``repro.models.registry``): the lock-step
and slot-serving surfaces of every ported arch (each takes ``mesh=None``,
as the reference's), and the per-shape input specs of the dry run:
``input_specs(cfg, shape)`` returns ``meta`` tensors for every model input
of an assigned input shape (shapes and dtypes, no allocation)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the reference's skip rules."""
    s = SHAPES[shape]
    if s.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch; 500k decode assigned to "
                       "SSM/hybrid only")
    return True, ""


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
            forward=lambda p, b, mesh=None: m.forward(p, b, cfg, mesh),
            train_loss=lambda p, b, mesh=None: m.train_loss(p, b, cfg,
                                                            mesh),
            prefill=lambda p, b, max_len=0, cache_dtype=torch.bfloat16,
            mesh=None: m.prefill(p, b, cfg, max_len, cache_dtype, mesh),
            decode_step=lambda p, t, c, mesh=None: m.decode_step(p, t, c,
                                                                 cfg, mesh),
            init_cache=lambda batch, max_len=0, dtype=torch.bfloat16:
                m.init_cache(cfg, batch, max_len, dtype, dev),
            init_slot_cache=lambda slots, max_len=0, dtype=torch.bfloat16:
                m.init_slot_cache(cfg, slots, max_len, dtype, dev),
            decode_slots=lambda p, t, c, n_valid, mesh=None: m.decode_slots(
                p, t, c, cfg, n_valid, mesh),
        )
    from repro_torch.models import lm as m

    slots = m._slot_unsupported(cfg) is None
    return ModelApi(
        cfg=cfg, device=dev,
        init=lambda seed=0: m.init_params(cfg, seed, dev),
        forward=lambda p, b, mesh=None: m.forward(p, b, cfg, mesh),
        train_loss=lambda p, b, mesh=None: m.train_loss(p, b, cfg, mesh),
        prefill=lambda p, b, max_len, cache_dtype=torch.bfloat16, mesh=None:
            m.prefill(p, b, cfg, max_len, cache_dtype, mesh),
        decode_step=lambda p, t, c, mesh=None: m.decode_step(p, t, c, cfg,
                                                             mesh),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16:
            m.init_cache(cfg, batch, max_len, dtype, dev),
        init_slot_cache=(lambda n, max_len, dtype=torch.bfloat16:
                         m.init_slot_cache(cfg, n, max_len, dtype, dev))
        if slots else None,
        decode_slots=(lambda p, t, c, n_valid, block_tables=None, kv_len=None,
                      mesh=None: m.decode_slots(p, t, c, cfg, n_valid,
                                                block_tables, kv_len, mesh))
        if slots else None,
        init_paged_cache=(lambda num_blocks, block_size, n,
                          dtype=torch.bfloat16: m.init_paged_slot_cache(
                              cfg, num_blocks, block_size, n, dtype, dev))
        if slots else None,
    )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: str) -> dict:
    """Model-input stand-ins (``meta`` tensors) for one (arch, shape) cell.

    Archs that take embeddings (the vision and audio families) get stub
    precomputed embeddings for the sequence body; decode still consumes
    token ids through the embedding table.  Token ids are int64 here (the
    port's index type) where the reference's are int32."""
    s = SHAPES[shape]
    b, t = s.global_batch, s.seq_len
    embeds_input = cfg.family in ("vlm", "audio")

    if s.kind == "train":
        if embeds_input:
            batch = {"embeds": _meta((b, t, cfg.d_model), torch.bfloat16),
                     "labels": _meta((b, t), torch.int64)}
            if cfg.family == "audio":
                batch["mask"] = _meta((b, t), torch.float32)
        else:
            batch = {"tokens": _meta((b, t), torch.int64),
                     "labels": _meta((b, t), torch.int64)}
        return {"batch": batch}

    if s.kind == "prefill":
        if embeds_input:
            batch = {"embeds": _meta((b, t, cfg.d_model), torch.bfloat16)}
            if cfg.rope == "mrope":
                batch["positions"] = _meta((3, b, t), torch.int64)
        else:
            batch = {"tokens": _meta((b, t), torch.int64)}
        return {"batch": batch, "max_len": t}

    # decode: one new token against a cache of seq_len
    cache = build_model(cfg, "meta").init_cache(b, t, torch.bfloat16)
    return {"tokens": _meta((b, 1), torch.int64), "cache": cache}
