"""Fault tolerance for the training loop (port of
``repro.runtime.fault_tolerance``, same semantics).

  Heartbeat        background thread stamping liveness to a file an external
                   supervisor (or co-trainer) watches; stale stamp => kill &
                   reschedule the worker.
  StragglerMonitor per-step timing with EMA + MAD threshold; flags slow
                   steps/hosts so the launcher can trigger mitigation
                   (checkpoint-and-replace, or exclude the host at the next
                   elastic re-mesh).
  RetryPolicy /    restart-from-checkpoint loop: wraps the step loop,
  run_resilient    catches worker failures, restores the latest checkpoint,
                   skips the data stream ahead deterministically, and
                   resumes.  Simulated failures are injected in tests via a
                   hook.

A step on the card returns once its kernels are queued, so the monitor
times the step only if ``step_fn`` synchronises (the train CLI's step
reads its loss back every step).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 5.0) -> None:
        self.path = path
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Heartbeat":
        def run():
            while not self._stop.wait(self.interval):
                self.beat()

        self.beat()
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def beat(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, self.path)

    def age(self) -> float:
        try:
            with open(self.path) as f:
                return time.time() - float(f.read())
        except FileNotFoundError:
            return float("inf")

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


class StragglerMonitor:
    """EMA + deviation threshold over step wall-times."""

    def __init__(self, threshold: float = 2.0, warmup: int = 5) -> None:
        self.threshold = threshold
        self.warmup = warmup
        self.ema: float | None = None
        self.dev: float = 0.0
        self.n = 0
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.ema is None:
            self.ema, self.dev = seconds, seconds * 0.1
            return False
        is_straggler = (
            self.n > self.warmup
            and seconds > self.ema + self.threshold * max(self.dev, 1e-6)
            and seconds > 1.5 * self.ema
        )
        if is_straggler:
            self.flagged.append((step, seconds))
        else:  # only track the typical distribution
            a = 0.1
            self.dev = (1 - a) * self.dev + a * abs(seconds - self.ema)
            self.ema = (1 - a) * self.ema + a * seconds
        return is_straggler


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_failures: int = 3
    backoff_s: float = 0.1
    checkpoint_every: int = 50


def run_resilient(
    *,
    init_state: Callable[[], Any],  # () -> (state pytree)
    step_fn: Callable[[Any, dict, int], Any],  # (state, batch, step) -> state
    loader,  # ShardedLoader
    manager,  # CheckpointManager
    total_steps: int,
    policy: RetryPolicy = RetryPolicy(),
    monitor: StragglerMonitor | None = None,
    on_step: Callable[[int, Any], None] | None = None,
    failure_hook: Callable[[int], None] | None = None,  # tests inject faults
) -> Any:
    """Checkpoint/restart step loop.  Any exception from step_fn (or the
    injected failure hook) triggers restore-from-latest + deterministic data
    skip-ahead; state survives worker death up to policy.max_failures."""
    state = init_state()
    start = 0
    try:
        state, start = manager.restore(state)
        start += 1
    except FileNotFoundError:
        pass
    loader.skip_to(start)

    failures = 0
    step = start
    it = iter(loader)
    while step < total_steps:
        try:
            batch = next(it)
            if failure_hook is not None:
                failure_hook(step)
            t0 = time.perf_counter()
            state = step_fn(state, batch, step)
            if monitor is not None:
                monitor.record(step, time.perf_counter() - t0)
            if on_step is not None:
                on_step(step, state)
            if ((step + 1) % policy.checkpoint_every == 0
                    or step + 1 == total_steps):
                manager.save(state, step, blocking=False)
            step += 1
        except (FileNotFoundError, KeyboardInterrupt):
            raise
        except Exception:
            failures += 1
            if failures > policy.max_failures:
                raise
            time.sleep(policy.backoff_s * (2 ** (failures - 1)))
            manager.wait()
            try:
                state, last = manager.restore(init_state())
                step = last + 1
            except FileNotFoundError:
                state, step = init_state(), 0
            loader.skip_to(step)
            it = iter(loader)
    manager.wait()
    return state
