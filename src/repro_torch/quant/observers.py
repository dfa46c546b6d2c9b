"""Activation-range calibration (port of ``repro.quant.observers``).

Usage:

    with CalibrationRecorder() as rec:
        for batch in calib_batches:
            model_apply(params, batch)          # float path
    ranges = rec.ranges()                        # {"layer/path": (lo, hi)}
    packed = pack_params(params, policy_fn, act_ranges=ranges)

Model code cooperates via :func:`scope`/:func:`record`: the float path of
:func:`~repro_torch.core.approx_linear.dense` records its input's min/max
when a recorder is active, under the path that model layers push with
``scope("blocks", i)``.  Calibration is offline, so reading the two values
back to the host (one sync per layer call) is fine; with no recorder
active, ``record`` costs one thread-local lookup.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_STATE = threading.local()


def _stack() -> list[str]:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


def _recorder():
    return getattr(_STATE, "recorder", None)


@contextlib.contextmanager
def scope(*names):
    """Push path components for calibration bookkeeping."""
    st = _stack()
    n = len(st)
    st.extend(str(x) for x in names)
    try:
        yield
    finally:
        del st[n:]


def current_path() -> str:
    return "/".join(_stack())


def record(x: torch.Tensor) -> None:
    """Record min/max of an activation under the current scope."""
    rec = _recorder()
    if rec is None:
        return
    lo, hi = torch.aminmax(x.detach())
    rec._update(current_path(), float(lo), float(hi))


class CalibrationRecorder:
    """Accumulates per-scope activation ranges across calibration batches."""

    def __init__(self) -> None:
        self._ranges: dict[str, tuple[float, float]] = {}

    def _update(self, path: str, lo: float, hi: float) -> None:
        if path in self._ranges:
            plo, phi = self._ranges[path]
            self._ranges[path] = (min(plo, lo), max(phi, hi))
        else:
            self._ranges[path] = (lo, hi)

    def ranges(self) -> dict[str, tuple[float, float]]:
        return dict(self._ranges)

    def __enter__(self) -> "CalibrationRecorder":
        if _recorder() is not None:
            raise RuntimeError("nested CalibrationRecorder")
        _STATE.recorder = self
        return self

    def __exit__(self, *exc) -> None:
        _STATE.recorder = None
