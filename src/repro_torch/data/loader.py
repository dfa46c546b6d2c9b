"""Sharded, prefetching, deterministically-resumable host data loader
(port of ``repro.data.loader``).

Each process builds only its shard of the global batch (shard = the
``torch.distributed`` rank when a process group is up, else 0 of 1), a
background thread keeps a bounded prefetch queue ahead of the training
loop, and ``skip_to(step)`` makes restart-after-failure deterministic (the
synthetic sources are pure functions of (step, shard), so skip-ahead is
O(1); a file-backed source would seek).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import torch


def _dist() -> tuple[int, int]:
    """(rank, world size) of the process group, or (0, 1) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedLoader:
    def __init__(
        self,
        # (step, shard, n_shards) -> batch
        batch_fn: Callable[[int, int, int], dict],
        *,
        prefetch: int = 2,
        shard: int | None = None,
        n_shards: int | None = None,
    ) -> None:
        rank, world = _dist()
        self._batch_fn = batch_fn
        self._shard = rank if shard is None else shard
        self._n_shards = world if n_shards is None else n_shards
        self._step = 0
        self._prefetch = prefetch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- deterministic resume ------------------------------------------------

    def skip_to(self, step: int) -> None:
        """Position the stream at ``step`` (restart path)."""
        self._drain()
        self._step = step

    # -- iteration -----------------------------------------------------------

    def _worker(self, start: int) -> None:
        step = start
        while not self._stop.is_set():
            batch = self._batch_fn(step, self._shard, self._n_shards)
            batch = dict(batch)
            batch["_step"] = step
            self._q.put(batch)
            step += 1

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._worker, args=(self._step,), daemon=True
            )
            self._thread.start()

    def _drain(self) -> None:
        self._stop.set()
        if self._thread is not None:
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=5)
            self._thread = None
        # recreate queue: any in-flight put lands in the old one
        self._q = queue.Queue(maxsize=self._prefetch)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        self._ensure_thread()
        batch = self._q.get()
        self._step = batch["_step"] + 1
        batch.pop("_step")
        return batch

    def close(self) -> None:
        self._drain()
