"""The device trace of a ``--trace 1`` run: torch.profiler over a traced
window, reduced in memory (nothing is written to disk) to the seconds the
device was busy, the operations that took most time, and the idle gaps
by what the host was doing.

The harness marks its own host work with ``record_function`` ranges named
``bench.*`` (an engine step, the model step, a client's submission, a
batch's copy or forward); the traced window itself is the range
``bench.window``, whose ends give the window on the trace's clock.
"""

from __future__ import annotations

import contextlib
import time

#: device operation names are cut to this many characters (templates)
NAME_CHARS = 96
#: idle gaps shorter than this are launch latency between queued kernels;
#: they are summed under one name instead of being attributed
SHORT_GAP_NS = 10_000
WINDOW_RANGE = "bench.window"


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1e3)


def _dur_ns(e) -> int:
    return (e.duration_ns() if hasattr(e, "duration_ns")
            else int(e.duration_us() * 1e3))


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type() == DeviceType.CUDA


@contextlib.contextmanager
def traced():
    """Profiles the block (host and device) inside a ``bench.window``
    range; the card is synchronised at both ends so that every operation
    launched in the block ends in it.  Yields a dict that holds the
    profiler once the block has closed (``"prof"``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    box: dict = {}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW_RANGE):
            t0 = time.perf_counter()
            yield box
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            box["host_s"] = time.perf_counter() - t0
    box["prof"] = prof


def warm() -> None:
    """Starts and stops the profiler once, so that its own start-up is paid
    in set-up and not inside the window."""
    import torch

    with traced():
        if torch.cuda.is_available():
            torch.ones(1, device="cuda").add_(1)


def summarise(prof) -> dict | None:
    """``busy_s`` (the union of the device's operations), ``window_s``,
    ``device_ops`` (the 10 names that took most device time, seconds),
    ``idle_gaps`` (the 10 host activities under which the device idled
    longest, seconds) and ``device_s_by_name`` (every name's seconds).
    None when the trace holds no device operation."""
    events = prof.profiler.kineto_results.events()
    host, dev = [], []
    w0 = w1 = None
    for e in events:
        name = e.name()
        if _is_device(e):
            if (getattr(e, "is_user_annotation", lambda: False)()
                    or name.startswith(("bench.", "ProfilerStep"))):
                continue
            s = _start_ns(e)
            dev.append((s, s + _dur_ns(e), name))
        else:
            s = _start_ns(e)
            if name == WINDOW_RANGE:
                w0, w1 = s, s + _dur_ns(e)
            else:
                host.append((s, s + _dur_ns(e), name))
    if not dev or w0 is None:
        return None
    by_name: dict[str, float] = {}
    for s, t, name in dev:
        key = name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (t - s) / 1e9
    dev.sort()
    # the union of the device's operations, clipped to the window
    busy, gaps = 0, []
    cur_s, cur_t = max(dev[0][0], w0), min(dev[0][1], w1)
    if cur_s > w0:
        gaps.append((w0, cur_s))
    for s, t, _ in dev[1:]:
        s, t = max(s, w0), min(t, w1)
        if s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += max(0, cur_t - cur_s)
    if cur_t < w1:
        gaps.append((cur_t, w1))
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": top(by_name),
            "idle_gaps": top(attribute_gaps(gaps, host)),
            "device_s_by_name": by_name}


def top(d: dict[str, float], n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def attribute_gaps(gaps, host) -> dict[str, float]:
    """Seconds of device idle by what the host was doing at each gap's
    middle: the innermost ``bench.*`` range and the innermost host
    operation there (``"bench.engine_step / aten::nonzero"``)."""
    out: dict[str, float] = {}
    host.sort()
    active: list = []
    i = 0
    for g0, g1 in sorted(gaps):
        if g1 - g0 < SHORT_GAP_NS:
            key = "short gaps between queued operations"
        else:
            mid = (g0 + g1) // 2
            while i < len(host) and host[i][0] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            bench = [h[2] for h in active if h[2].startswith("bench.")]
            ops = [h[2] for h in active if not h[2].startswith("bench.")]
            key = (bench[-1] if bench else "outside the harness's ranges")
            if ops:
                key += f" / {ops[-1][:NAME_CHARS]}"
        out[key] = out.get(key, 0.0) + (g1 - g0) / 1e9
    return out
