"""Pooled, slot-indexed KV-cache manager (port of
``repro.serving.kv_pool``).

One preallocated cache holds the decode state of every slot with a
per-slot write cursor (``cache["lengths"]``): attention archs get
``(L, slots, heads, max_len, head_dim)`` K/V in the serving cache dtype,
RWKV the per-slot recurrent state.  An attention slot is recycled by
resetting its cursor (the attention mask hides stale entries and the next
occupant overwrites them); recurrent state has no mask, so a recycled
slot's state is zeroed.  The model step updates the cache in place.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.registry import ModelApi

_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "int8": torch.int8}


class SlotPool:
    """Fixed number of sequence slots over one pooled cache."""

    def __init__(self, api: ModelApi, slots: int, max_len: int,
                 cache_dtype: str = "bfloat16") -> None:
        if not api.supports_slots:
            raise NotImplementedError(
                f"{api.cfg.name}: architecture not servable through the slot "
                "engine yet (ring-buffer / SSM slot state are ROADMAP items)")
        try:
            dtype = _CACHE_DTYPES[cache_dtype]
        except KeyError:
            raise ValueError(f"unknown cache_dtype {cache_dtype!r}; valid "
                             f"choices: {sorted(_CACHE_DTYPES)}") from None
        self.slots = slots
        self.max_len = max_len
        self.cache = api.init_slot_cache(slots, max_len, dtype)
        self._recurrent = bool(api.cfg.rwkv)
        self._free: list[int] = list(range(slots - 1, -1, -1))  # slot 0 first
        self._owner: dict[int, int] = {}

    def acquire(self, rid: int) -> int | None:
        """Claim a free slot for request ``rid`` (cursor reset to 0; a
        recurrent arch's state of the slot zeroed)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._owner[slot] = rid
        self.cache["lengths"][slot] = 0
        if self._recurrent:  # state leaves are (L, slots, ...)
            for key, leaf in self.cache.items():
                if key != "lengths":
                    leaf[:, slot] = 0
        return slot

    def acquire_for(self, req) -> int | None:
        return self.acquire(req.rid)

    def release(self, slot: int) -> None:
        del self._owner[slot]
        self._free.append(slot)

    def lengths(self) -> np.ndarray:
        """The per-slot write cursors, on the host."""
        return self.cache["lengths"].cpu().numpy().astype(np.int64)

    def set_lengths(self, new_lengths) -> None:
        """Move the write cursors (speculative rollback: a pure cursor
        move over the position-indexed cache)."""
        from repro_torch.models.lm import rollback_slots

        rollback_slots(self.cache, new_lengths)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.slots - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.n_active / self.slots
