"""Deterministic fault injection for the approximate serving path (port of
``repro.quant.faults``).

The governor (:mod:`repro_torch.serving.governor`) and the engine's
quarantine exist to survive a misbehaving approximate multiplier: a MAC
array drifting out of its calibrated envelope, a stuck-at bit, a
transient upset.  Testing that needs faults on demand, reproducibly.  Two
corruption surfaces:

  * **step surface** (kinds ``nan`` / ``inf`` / ``spike``): the engine
    corrupts a copy of the step's logits for deterministically chosen
    rows, modeling a transient corruption of the step's output.  The
    engine's detector must catch every one: the row is quarantined, its KV
    cursor rolled back, and the step replayed on the exact pack before any
    token is emitted.
  * **dense surface** (kind ``dense-noise``): a thread-local hook in
    :func:`repro_torch.core.approx_linear.dense` / ``dense_group`` adds
    deterministic Gaussian noise to the APPROXIMATE output of packed layers
    matching a path pattern, on the error probe's observe forward only
    (the injector is armed nowhere else, so serving steps never see it).
    This models a degraded MAC array as the probe observes it: the probe's
    delta variance breaches the SLO and drives the governor's ladder.

Determinism: rows and noise derive from ``np.random.default_rng((seed,
step, salt))``, the reference's generator, so the same seed and step
sequence injects the same faults (the same noise values, the same rows)
on either KV layout and in either package.  Every injection appends to
``FaultInjector.log``, in the reference's tuple form.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import re
import threading
import zlib

import numpy as np
import torch

_STATE = threading.local()

#: logit magnitude on the consumed column above which a row is treated as
#: divergent even when finite (trained logits are O(10); a stuck-at-style
#: offset spike lands far outside this)
DIVERGENCE_ABS = 1e3

KINDS = ("nan", "inf", "spike", "dense-noise")


def active():
    """The thread-local armed :class:`FaultInjector`, or None (the common
    case: armed only around a probe's observe forward)."""
    return getattr(_STATE, "injector", None)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault campaign.

    ``kind``   — ``nan`` | ``inf`` | ``spike`` (step surface: corrupt
                 chosen rows' logits) or ``dense-noise`` (dense surface:
                 Gaussian noise on matching packed layers' probe outputs).
    ``every``  — fire on engine steps where ``(step - start) % every == 0``.
    ``start``/``stop`` — half-open step window ``[start, stop)`` the
                 campaign is live in (``stop=None`` = forever).
    ``rows``   — max batch rows corrupted per fired step (step surface).
    ``scale``  — spike offset magnitude / dense-noise sigma.
    ``layers`` — ``fnmatch`` pattern over layer paths (dense surface).
    """

    kind: str = "nan"
    every: int = 8
    seed: int = 0
    start: int = 0
    stop: int | None = None
    rows: int = 1
    scale: float = 1e4
    layers: str = "*"

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"fault kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if self.every < 1:
            raise ValueError(f"fault every must be >= 1, got {self.every}")
        if self.rows < 1:
            raise ValueError(f"fault rows must be >= 1, got {self.rows}")
        if self.stop is not None and self.stop <= self.start:
            raise ValueError("fault window is empty: "
                             f"start={self.start} stop={self.stop}")

    @property
    def surface(self) -> str:
        return "dense" if self.kind == "dense-noise" else "step"

    @staticmethod
    def parse(text: str, seed: int = 0) -> "FaultSpec":
        """Parse the CLI form ``KIND@EVERY[@START-STOP][@LAYERS]``:
        ``nan@5``, ``spike@7@20-60``, ``dense-noise@1@10-30``,
        ``dense-noise@1@blocks/0/*``, ``dense-noise@1@10-30@blocks/0/o``.
        The third segment is a step range when it looks like one
        (``N-M``/``N-``/``-M``, digits only), a layer pattern otherwise."""
        parts = text.split("@")
        if not 2 <= len(parts) <= 4:
            raise ValueError(f"fault spec {text!r} is not "
                             "KIND@EVERY[@START-STOP][@LAYERS]")
        kind, every = parts[0], int(parts[1])
        start, stop = 0, None
        layers = "*"
        rest = parts[2:]
        if rest and re.fullmatch(r"\d*-\d*", rest[0]) and rest[0] != "-":
            lo, _, hi = rest[0].partition("-")
            start = int(lo) if lo else 0
            stop = int(hi) if hi else None
            rest = rest[1:]
        if rest:
            if len(rest) > 1:
                raise ValueError(f"fault spec {text!r}: at most one layer "
                                 "pattern segment")
            layers = rest[0]
        return FaultSpec(kind=kind, every=every, seed=seed,
                         start=start, stop=stop, layers=layers)


class FaultInjector:
    """Stateful executor of one :class:`FaultSpec` campaign.  The engine
    owns one injector; quarantine replays never consult it, so a
    corrupted step's exact replay is always clean."""

    def __init__(self, spec: FaultSpec) -> None:
        self.spec = spec
        self.injected_steps = 0
        self.injected_rows = 0
        #: ``("step", step, kind, (rows...))`` and ``("dense", step,
        #: layer_key)`` entries, comparable across engines and packages
        self.log: list[tuple] = []
        self._armed_step: int | None = None

    # -- schedule ------------------------------------------------------------

    def fires(self, step: int) -> bool:
        s = self.spec
        if step < s.start or (s.stop is not None and step >= s.stop):
            return False
        return (step - s.start) % s.every == 0

    def _rng(self, step: int, salt: int = 0) -> np.random.Generator:
        return np.random.default_rng((self.spec.seed, step, salt))

    def plan_rows(self, step: int, live_rows) -> list[int]:
        """Deterministic subset of live batch rows to corrupt this step
        (depends on the SET of live rows, not their order)."""
        live = sorted(int(r) for r in live_rows)
        if not live:
            return []
        k = min(self.spec.rows, len(live))
        picked = self._rng(step).choice(len(live), size=k, replace=False)
        return sorted(live[int(i)] for i in picked)

    # -- step surface (logits corruption) ------------------------------------

    def corrupt_logits(self, step: int, logits, rows: list[int]) -> torch.Tensor:
        """A corrupted copy of ``logits`` (slots, cols, vocab), on its
        device, with the chosen rows overwritten per the campaign kind;
        the input is untouched."""
        lg = torch.as_tensor(logits).clone()
        s = self.spec
        for r in rows:
            if s.kind == "nan":
                lg[r] = float("nan")
            elif s.kind == "inf":
                lg[r] = float("inf")
            else:  # spike: stuck-at-style constant offset, still finite
                lg[r] = lg[r] + s.scale
        self.injected_steps += 1
        self.injected_rows += len(rows)
        self.log.append(("step", step, s.kind, tuple(rows)))
        return lg

    # -- dense surface (probe-forward hook) ----------------------------------

    @contextlib.contextmanager
    def armed(self, step: int):
        """Arm the thread-local hook for one probe forward; a no-op (still
        a valid context) when the campaign does not fire on ``step`` or is
        not dense-surface."""
        if self.spec.surface != "dense" or not self.fires(step):
            yield self
            return
        if active() is not None:
            raise RuntimeError("nested FaultInjector arming")
        _STATE.injector = self
        self._armed_step = step
        try:
            yield self
        finally:
            _STATE.injector = None
            self._armed_step = None

    def corrupt_dense(self, path: str, name: str,
                      y: torch.Tensor) -> torch.Tensor:
        """Called from the dense() probe hook: add deterministic Gaussian
        noise to a matching packed layer's approximate output.  The
        float64 noise is the reference's, rounded to ``y``'s dtype."""
        key = f"{path}/{name}" if path else name
        if not fnmatch.fnmatch(key, self.spec.layers):
            return y
        step = self._armed_step or 0
        rng = self._rng(step, salt=zlib.crc32(key.encode()))
        noise = rng.normal(0.0, self.spec.scale, tuple(y.shape))
        self.injected_rows += 1
        self.log.append(("dense", step, key))
        return y + torch.as_tensor(noise).to(device=y.device, dtype=y.dtype)


def suspect_rows(cols) -> np.ndarray:
    """Boolean mask (host numpy) over the rows of ``cols`` (rows, vocab),
    each row's consumed logits column, flagging non-finite or divergent
    rows.  The reduction runs where ``cols`` lives; only the mask comes to
    the host."""
    cols = torch.as_tensor(cols).to(torch.float32)
    finite = torch.isfinite(cols)
    nonfinite = ~finite.all(dim=-1)
    magnitude = torch.where(finite, cols, 0.0).abs().amax(dim=-1)
    return (nonfinite | (magnitude > DIVERGENCE_ABS)).cpu().numpy()
