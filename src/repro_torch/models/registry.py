"""Uniform model API, slot-serving surface (port of
``repro.models.registry``)."""

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
    #: (slots, max_len, dtype) -> pooled slot cache on ``device``
    init_slot_cache: Callable
    #: (params, tokens, cache, n_valid) -> (logits, cache updated in place)
    decode_slots: Callable


def build_model(cfg: ArchConfig, device=None) -> ModelApi:
    """The model API on ``device`` (default ``cuda``; raises without it)."""
    from repro_torch.models import lm as m

    dev = resolve_device(device)
    return ModelApi(
        cfg=cfg, device=dev,
        init=lambda seed=0: m.init_params(cfg, seed, dev),
        init_slot_cache=lambda slots, max_len, dtype=torch.bfloat16:
            m.init_slot_cache(cfg, slots, max_len, dtype, dev),
        decode_slots=lambda p, t, c, n_valid: m.decode_slots(p, t, c, cfg,
                                                             n_valid),
    )
