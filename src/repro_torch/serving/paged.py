"""Paged KV cache: block-granular allocation with copy-on-write prefix
reuse (port of ``repro.serving.paged``).

* :class:`BlockAllocator` — refcounted free list over a pool of
  fixed-size KV blocks; block 0 is the NULL block that padding table
  entries point at, never allocated.
* :class:`BlockTable` — one request's logical -> physical block map plus
  the reserve copy-on-write draws from.
* :class:`PrefixCache` — sha256 chain hash over full prompt blocks ->
  physical block id, LRU-evicted under pressure.  A request attaches to
  every cached full block of its prompt and skips that prefill.
* :class:`PagedKVPool` — the engine-facing manager, with ``SlotPool``'s
  surface (``acquire_for`` / ``release`` / ``cache``) plus block tables,
  the host cursor mirror, the COW barrier, block statistics and the
  cross-pool prefix export and import a fleet's replicas share blocks by.

Shared blocks are immutable: every sharer's cursor starts past them.  The
one write into a shared block is the re-prefill of a fully cached
prompt's last token (the match is capped one token short so the request
gets first-token logits): ``ensure_writable`` swaps in a reserve block and
queues a (src, dst) copy that ``flush_copies`` makes before the step, as
one batched ``index_copy_`` a cache leaf.  Every block a request can need
is reserved at admission, so admission waits on free blocks, never a
running request.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.configs.base import EngineConfig
from repro_torch.models.registry import ModelApi
from repro_torch.serving.kv_pool import _CACHE_DTYPES

#: physical block id the padding entries of every block table point at;
#: never allocated or written, so it stays all zeros
NULL_BLOCK = 0


def block_hashes(tokens, block_size: int) -> list[bytes]:
    """Chain hash over the FULL blocks of a token sequence: ``out[i]``
    commits to tokens ``[0, (i+1)*block_size)`` (the reference's bytes, so
    both packages key blocks alike)."""
    out: list[bytes] = []
    h = hashlib.sha256(b"kv-prefix-v1:%d" % block_size).digest()
    for i in range(len(tokens) // block_size):
        blk = np.asarray(tokens[i * block_size:(i + 1) * block_size],
                         np.int64).tobytes()
        h = hashlib.sha256(h + blk).digest()
        out.append(h)
    return out


class BlockAllocator:
    """Refcounted free list over physical KV blocks ``1..num_blocks-1``."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError("need at least 1 usable block + the NULL block")
        self.num_blocks = num_blocks
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))  # pop -> 1
        self._ref: dict[int, int] = {}
        self.peak_used = 0

    def alloc(self) -> int:
        """Claim a free block (refcount 1).  Callers check ``n_free``."""
        if not self._free:
            raise RuntimeError("block pool exhausted (caller must reserve)")
        bid = self._free.pop()
        self._ref[bid] = 1
        self.peak_used = max(self.peak_used, self.n_used)
        return bid

    def incref(self, bid: int) -> None:
        self._ref[bid] += 1

    def decref(self, bid: int) -> bool:
        """Drop one reference; True when the block was freed."""
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            del self._ref[bid]
            self._free.append(bid)
            return True
        return False

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._ref)


class BlockTable:
    """One request's logical-block -> physical-block map; ``reserve`` holds
    pre-allocated ids for copy-on-write swaps.  Both are owned (one
    refcount each) until :meth:`PagedKVPool.release`."""

    def __init__(self, blocks: list[int], reserve: list[int]) -> None:
        self.blocks = blocks
        self.reserve = reserve

    def owned(self) -> list[int]:
        return self.blocks + self.reserve


class PrefixCache:
    """Chain hash -> physical block id for FULL, frozen prompt blocks.
    Holds one refcount per entry; LRU order is refreshed on attach."""

    def __init__(self) -> None:
        self._entries: OrderedDict[bytes, int] = OrderedDict()

    def match(self, hashes: list[bytes]) -> list[int]:
        """Longest cached prefix of ``hashes`` (a pure lookup: recency is
        refreshed by :meth:`touch` only when the caller attaches)."""
        bids: list[int] = []
        for h in hashes:
            bid = self._entries.get(h)
            if bid is None:
                break
            bids.append(bid)
        return bids

    def touch(self, hashes: list[bytes]) -> None:
        for h in hashes:
            if h in self._entries:
                self._entries.move_to_end(h)

    def register(self, h: bytes, bid: int, allocator: BlockAllocator) -> bool:
        """Publish a frozen full block (the cache takes its own reference);
        a known hash only refreshes its LRU position."""
        if h in self._entries:
            self._entries.move_to_end(h)
            return False
        allocator.incref(bid)
        self._entries[h] = bid
        return True

    def items(self) -> list[tuple[bytes, int]]:
        """(chain hash, physical block id) pairs, LRU first (a copy, so
        callers cannot skew recency)."""
        return list(self._entries.items())

    def __contains__(self, h: bytes) -> bool:
        return h in self._entries

    def evict_lru(self, allocator: BlockAllocator) -> bool:
        """Drop the coldest entry whose block only the cache holds;
        entries of blocks live requests hold free nothing and are kept.
        False when nothing is freeable."""
        victim = next((h for h, bid in self._entries.items()
                       if allocator.refcount(bid) == 1), None)
        if victim is None:
            return False
        allocator.decref(self._entries.pop(victim))
        return True

    def __len__(self) -> int:
        return len(self._entries)


class PagedKVPool:
    """Engine-facing paged KV manager (drop-in for ``SlotPool``).  Per
    iteration the engine calls ``ensure_writable`` for every scheduled
    row, ``flush_copies``, the step (with ``block_tables_array()`` and
    ``max_len``), then ``advance`` with the batch's ``n_valid``."""

    def __init__(self, api: ModelApi, ecfg: EngineConfig) -> None:
        if not api.supports_paged:
            raise NotImplementedError(
                f"{api.cfg.name}: paged KV layout needs an attention-style "
                "KV sequence (recurrent per-slot state has nothing to page)")
        self.slots = ecfg.slots
        self.max_len = ecfg.max_len
        self.block_size = ecfg.kv_block_size
        if self.block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        self.blocks_per_slot = -(-ecfg.max_len // self.block_size)
        usable = ecfg.kv_blocks or ecfg.slots * self.blocks_per_slot
        try:
            dtype = _CACHE_DTYPES[ecfg.cache_dtype]
        except KeyError:
            raise ValueError(f"unknown cache_dtype {ecfg.cache_dtype!r}; "
                             f"valid choices: {sorted(_CACHE_DTYPES)}") from None
        self.cache = api.init_paged_cache(usable + 1, self.block_size,
                                          ecfg.slots, dtype)
        self.allocator = BlockAllocator(usable + 1)
        self.prefix = PrefixCache() if ecfg.prefix_cache else None
        self._block_keys = [k for k in self.cache if k != "lengths"]
        self._free_slots: list[int] = list(range(ecfg.slots - 1, -1, -1))
        self._owner: dict[int, int] = {}
        self._tables: dict[int, BlockTable] = {}
        self._cursors = np.zeros(ecfg.slots, np.int64)  # host mirror
        self._hashes: dict[int, list[bytes]] = {}  # slot -> prompt chain
        self._registered: dict[int, int] = {}  # slot -> blocks published
        self._pending_copies: list[tuple[int, int]] = []
        self.cow_copies = 0
        self.prefix_evictions = 0
        self.prefix_imports = 0

    # -- allocation ----------------------------------------------------------

    def _make_room(self, n: int) -> bool:
        """Evict cold prefix-cache entries until ``n`` blocks are free (or
        nothing evictable remains)."""
        while self.allocator.n_free < n:
            if self.prefix is None or not self.prefix.evict_lru(self.allocator):
                break
            self.prefix_evictions += 1
        return self.allocator.n_free >= n

    def acquire_for(self, req) -> int | None:
        """Admit one request: match its prompt against the prefix cache,
        then reserve every block its lifetime can need.  Returns the slot,
        or None when slots or blocks are short (the request stays queued).
        The match is capped at ``prompt_len - 1``; when the cap falls
        inside a shared block, one reserve block is added for the
        copy-on-write its re-prefill triggers."""
        if not self._free_slots:
            return None
        bs = self.block_size
        plen, gen = len(req.prompt), req.max_new_tokens
        need_total = -(-(plen + gen) // bs)
        if need_total > self.blocks_total:
            raise ValueError(
                f"request {req.rid} needs {need_total} blocks; the pool "
                f"holds {self.blocks_total}")
        hashes = [] if self.prefix is None else req.block_hashes
        if hashes is None:
            hashes = req.block_hashes = block_hashes(req.prompt, bs)
        matched = self.prefix.match(hashes) if self.prefix is not None else []
        matched_tokens = min(len(matched) * bs, plen - 1)
        cow_reserve = 1 if matched_tokens < len(matched) * bs else 0
        fresh_needed = need_total - len(matched) + cow_reserve
        # hold the shared blocks before making room: eviction must not
        # free what this request is about to attach to
        for bid in matched:
            self.allocator.incref(bid)
        if not self._make_room(fresh_needed):
            for bid in matched:
                self.allocator.decref(bid)
            return None
        fresh = [self.allocator.alloc() for _ in range(fresh_needed)]
        n_tail = need_total - len(matched)
        table = BlockTable(matched + fresh[:n_tail], fresh[n_tail:])
        slot = self._free_slots.pop()
        if self.prefix is not None and matched:
            self.prefix.touch(hashes[:len(matched)])
        self._owner[slot] = req.rid
        self._tables[slot] = table
        self._cursors[slot] = matched_tokens
        self._hashes[slot] = hashes
        self._registered[slot] = len(matched)
        self.cache["lengths"][slot] = matched_tokens
        req.prefix_hit_tokens = matched_tokens
        return slot

    def release(self, slot: int) -> None:
        """Drop the request's references; blocks live on while the prefix
        cache (or another sharer) holds them."""
        for bid in self._tables[slot].owned():
            self.allocator.decref(bid)
        del self._tables[slot], self._owner[slot]
        self._hashes.pop(slot, None)
        self._registered.pop(slot, None)
        self._free_slots.append(slot)

    # -- the write barrier (copy-on-write) -----------------------------------

    def ensure_writable(self, slot: int, n_tokens: int) -> None:
        """Every block the next ``n_tokens``-token write of ``slot``
        touches becomes uniquely owned: a shared one is swapped for a
        reserve block and its copy queued."""
        if n_tokens <= 0:
            return
        bs = self.block_size
        cur = int(self._cursors[slot])
        table = self._tables[slot]
        for lb in range(cur // bs, (cur + n_tokens - 1) // bs + 1):
            bid = table.blocks[lb]
            if self.allocator.refcount(bid) > 1:
                assert table.reserve, (
                    "COW without a reserve block: acquire_for accounting bug")
                dst = table.reserve.pop()
                self._pending_copies.append((bid, dst))
                self.allocator.decref(bid)
                table.blocks[lb] = dst
                self.cow_copies += 1

    def flush_copies(self) -> None:
        """Makes the queued copies: one ``index_copy_`` a cache leaf over
        every (src, dst) pair (destinations are fresh reserve blocks,
        never a source)."""
        if not self._pending_copies:
            return
        src, dst = (torch.as_tensor(v, device=self.cache["lengths"].device)
                    for v in zip(*self._pending_copies))
        for k in self._block_keys:
            leaf = self.cache[k]
            leaf.index_copy_(1, dst, leaf.index_select(1, src))
        self._pending_copies.clear()

    def advance(self, n_valid) -> None:
        """Mirror the step's cursor advance on the host."""
        self._cursors += np.asarray(n_valid, np.int64)

    # -- prefix publication --------------------------------------------------

    def register_prefix(self, slot: int, prompt_len: int,
                        prefilled: int) -> int:
        """Publish every newly FULL prompt block of ``slot`` (as chunked
        prefill advances, so concurrent requests can hit them).  The tail
        block also takes generated tokens and is never published."""
        if self.prefix is None:
            return 0
        n_full = min(prefilled, prompt_len) // self.block_size
        table, hashes = self._tables[slot], self._hashes[slot]
        published = 0
        for lb in range(self._registered.get(slot, 0), n_full):
            published += self.prefix.register(hashes[lb], table.blocks[lb],
                                              self.allocator)
        self._registered[slot] = max(self._registered.get(slot, 0), n_full)
        return published

    # -- cross-pool prefix sharing -------------------------------------------

    def export_prefix_entries(self) -> list[tuple[bytes, dict]]:
        """Every prefix-cache entry as (chain hash, block content): the
        block's slice of each K/V leaf, ``(L, Hkv, block_size, hd)``, as a
        host tensor in the cache's own dtype (bf16 and int8 included, which
        numpy could not carry).  The hash commits to the whole token prefix
        and the block size, so a pool with the same model and cache config
        adopts the block sight unseen; registered blocks are frozen full
        prompt blocks, so the copy never races a write."""
        if self.prefix is None:
            return []
        return [(h, {k: self.cache[k][:, bid].cpu() for k in self._block_keys})
                for h, bid in self.prefix.items()]

    def import_prefix_entries(self, entries) -> int:
        """Adopt another pool's exported entries: each new one is copied
        into a fresh block on this pool's device and published under its
        hash, held by the prefix cache alone (refcount 1, LRU-evictable).
        Known hashes are skipped, and when no room can be made the rest is
        dropped (sharing is an optimization).  Returns the blocks
        imported."""
        if self.prefix is None:
            return 0
        imported = 0
        for h, content in entries:
            if h in self.prefix:
                continue
            if not self._make_room(1):
                break
            bid = self.allocator.alloc()
            for k, v in content.items():
                self.cache[k][:, bid].copy_(v)
            self.prefix.register(h, bid, self.allocator)  # the cache's ref
            self.allocator.decref(bid)  # drop the alloc ref: cache-owned
            imported += 1
        self.prefix_imports += imported
        return imported

    # -- state ---------------------------------------------------------------

    def lengths(self) -> np.ndarray:
        """The host cursor mirror (equal to ``cache["lengths"]``)."""
        return self._cursors.copy()

    def set_lengths(self, new_lengths) -> None:
        """Move the device cursors and the host mirror (speculative
        rollback): block tables are position-stable, so a rollback frees
        and copies nothing, even across a block boundary."""
        from repro_torch.models.lm import rollback_slots

        rollback_slots(self.cache, new_lengths)
        self._cursors[:] = np.asarray(new_lengths, np.int64)

    def block_tables_array(self) -> np.ndarray:
        """(slots, blocks_per_slot) int32 for the step; idle slots and the
        unallocated tail of short tables point at NULL_BLOCK."""
        bt = np.full((self.slots, self.blocks_per_slot), NULL_BLOCK, np.int32)
        for slot, table in self._tables.items():
            bt[slot, :len(table.blocks)] = table.blocks
        return bt

    # -- observability -------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def n_active(self) -> int:
        return self.slots - len(self._free_slots)

    @property
    def occupancy(self) -> float:
        return self.n_active / self.slots

    @property
    def blocks_total(self) -> int:
        return self.allocator.num_blocks - 1

    def reset_peak_blocks(self) -> None:
        self.allocator.peak_used = self.allocator.n_used

    def per_block_bytes(self) -> int:
        """Bytes of one block across every layer's K/V leaves."""
        return sum(v.numel() * v.element_size() // self.allocator.num_blocks
                   for k, v in self.cache.items() if k != "lengths")

    def block_stats(self) -> dict:
        """Block utilization (in-use blocks over the usable pool) and
        fragmentation (the allocated-but-unwritten share of active
        requests' blocks; shared blocks counted once at their fullest)."""
        filled: dict[int, int] = {}
        bs = self.block_size
        for slot, table in self._tables.items():
            cur = int(self._cursors[slot])
            for lb, bid in enumerate(table.blocks):
                f = min(max(cur - lb * bs, 0), bs)
                filled[bid] = max(filled.get(bid, 0), f)
            for bid in table.reserve:
                filled.setdefault(bid, 0)
        active_blocks = len(filled)
        written = sum(filled.values())
        return {
            "blocks_total": self.blocks_total,
            "blocks_in_use": self.allocator.n_used,
            "peak_blocks_in_use": self.allocator.peak_used,
            "block_util": self.allocator.n_used / self.blocks_total,
            "block_frag": (1.0 - written / (active_blocks * bs)
                           if active_blocks else 0.0),
            "prefix_cache_entries": len(self.prefix) if self.prefix else 0,
            "cow_copies": self.cow_copies,
            "prefix_evictions": self.prefix_evictions,
        }
