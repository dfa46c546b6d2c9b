"""Accuracy-SLO numerics governor (port of ``repro.serving.governor``):
adaptive approximation under a live error budget.

The deployed CV constants are calibration-time, and a drifting MAC array
(or a miscalibrated spec) can silently blow the accuracy budget while
serving.  The governor turns the error probe into an enforced SLO:

  * every probe report's logits moments fold into the current **window**
    (a fixed count of probe runs, so windows are deterministic and
    layout-independent);
  * closed windows Chan-merge (:func:`repro_torch.serving.metrics.
    _merge_moments`) into a bounded history: the running variance
    estimate the SLO is checked against;
  * a breach **escalates** one rung up the degradation ladder
    (:mod:`repro_torch.numerics.ladder`; e.g. perforated-m2-cv -> int8 ->
    float); a detected fault (NaN: unbounded variance) escalates at once;
  * after ``clean_windows_to_relax`` consecutive windows comfortably under
    the SLO the governor **relaxes** one rung back to re-harvest power.

The governor is pure bookkeeping: it consumes probe reports and returns
:class:`GovernorDecision`\\ s; the engine executes them by hot-swapping
the live pack.  History resets on every switch, so the estimate describes
the current rung, not a mixture of regimes.
"""

from __future__ import annotations

import collections
import dataclasses
import fnmatch

from repro_torch.numerics.ladder import LadderRung
from repro_torch.serving.metrics import _merge_moments, merge_layer_moments

__all__ = ["GovernorConfig", "GovernorDecision", "NumericsGovernor"]


@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    """Accuracy-SLO policy knobs.

    ``slo_err_var``   — max acceptable running logits err-var (the probe's
                        approx-vs-exact delta variance).
    ``window_probes`` — probe reports per governor window (count-based, so
                        window boundaries are deterministic).
    ``history_windows`` — closed windows Chan-merged into the running
                        estimate (bounded; resets on every switch).
    ``clean_windows_to_relax`` — consecutive clean windows required before
                        stepping back down the ladder.
    ``relax_headroom`` — a window only counts as *clean* when its running
                        estimate is under ``relax_headroom * slo_err_var``
                        (hysteresis: relaxing at 0.99x the SLO would
                        oscillate).
    ``severe_factor`` — a breach with running err-var >=
                        ``severe_factor * slo_err_var`` is *severe*: the
                        governor jumps directly to the first rung whose
                        modeled residual clears the SLO instead of walking
                        one rung per window (each intermediate rung would
                        burn a full window while the SLO stays blown).
                        None (the default) keeps the one-rung walk.
    ``layer_slo``     — opt-in per-layer ceilings: fnmatch patterns over
                        probe layer paths (e.g. ``"blocks/3/*"``) mapped
                        to max acceptable per-layer err-var.  A breach on
                        any watched layer escalates with the breaching
                        layer NAMED in the decision (``reason
                        "layer_slo_breach"``), catching a single
                        mis-specced layer before it dilutes into the
                        logits-level SLO.  Accepts a dict at construction;
                        normalized to a sorted tuple of (pattern, ceiling)
                        pairs so the config stays hashable.  First
                        matching pattern wins per layer.
    """

    slo_err_var: float
    window_probes: int = 4
    history_windows: int = 8
    clean_windows_to_relax: int = 3
    relax_headroom: float = 0.25
    severe_factor: float | None = None
    layer_slo: tuple = ()

    def __post_init__(self) -> None:
        if isinstance(self.layer_slo, dict):
            object.__setattr__(self, "layer_slo",
                               tuple(sorted(self.layer_slo.items())))
        else:
            object.__setattr__(self, "layer_slo",
                               tuple(tuple(p) for p in self.layer_slo))
        for pat, ceiling in self.layer_slo:
            if not pat:
                raise ValueError("layer_slo pattern must be non-empty")
            if ceiling <= 0:
                raise ValueError(f"layer_slo ceiling for {pat!r} must be "
                                 f"> 0, got {ceiling}")
        if self.slo_err_var <= 0:
            raise ValueError(
                f"slo_err_var must be > 0, got {self.slo_err_var}")
        if self.window_probes < 1:
            raise ValueError(
                f"window_probes must be >= 1, got {self.window_probes}")
        if self.clean_windows_to_relax < 1:
            raise ValueError("clean_windows_to_relax must be >= 1, got "
                             f"{self.clean_windows_to_relax}")
        if not 0 < self.relax_headroom <= 1:
            raise ValueError("relax_headroom must be in (0, 1], got "
                             f"{self.relax_headroom}")
        if self.severe_factor is not None and self.severe_factor < 1:
            raise ValueError("severe_factor must be >= 1 (a severe breach "
                             f"is at least a breach), got "
                             f"{self.severe_factor}")


@dataclasses.dataclass(frozen=True)
class GovernorDecision:
    """One ladder move for the engine to execute (pack hot-swap)."""

    action: str  # "escalate" | "relax"
    reason: str  # "slo_breach" | "layer_slo_breach" | "fault"
    #          #   | "clean_windows"
    rung_from: LadderRung
    rung_to: LadderRung
    window: int  # windows closed when the decision fired
    err_var: float | None  # running estimate that drove it (None: fault)
    #: the breaching layer path for reason "layer_slo_breach" (its
    #: per-layer estimate is then what ``err_var`` carries); None for
    #: logits-level decisions
    layer: str | None = None

    @property
    def power_delta_pct(self) -> float:
        """Modeled MAC-array power-saving change: negative = the switch
        SPENDS power (escalation), positive = re-harvests it (relax)."""
        return round(self.rung_to.power_saving_pct
                     - self.rung_from.power_saving_pct, 2)

    def to_dict(self) -> dict:
        d = {"action": self.action, "reason": self.reason,
             "from": self.rung_from.name, "to": self.rung_to.name,
             "window": self.window, "err_var": self.err_var,
             "power_delta_pct": self.power_delta_pct}
        if self.layer is not None:
            d["layer"] = self.layer
        return d


class NumericsGovernor:
    """Pure SLO bookkeeping over probe reports for one engine."""

    def __init__(self, ladder: list[LadderRung], cfg: GovernorConfig,
                 start: int = 0) -> None:
        if len(ladder) < 2:
            raise ValueError("governor needs a ladder of >= 2 rungs")
        if not 0 <= start < len(ladder):
            raise ValueError(f"start rung {start} outside ladder of "
                             f"{len(ladder)}")
        self.ladder = list(ladder)
        self.cfg = cfg
        self.rung_idx = start
        self.windows_closed = 0
        self.first_breach_window: int | None = None
        self.decisions: list[GovernorDecision] = []
        self._history: collections.deque = collections.deque(
            maxlen=cfg.history_windows)
        self._win: tuple[int, float, float] = (0, 0.0, 0.0)
        self._win_probes = 0
        self._clean = 0
        # per-layer mirrors of the window/history state, populated only
        # when layer SLOs are configured (layer folding is otherwise
        # skipped so the unwatched path stays exactly as cheap)
        self._layer_history: collections.deque = collections.deque(
            maxlen=cfg.history_windows)
        self._layer_win: dict = {}

    @property
    def rung(self) -> LadderRung:
        return self.ladder[self.rung_idx]

    @property
    def err_var_estimate(self) -> float | None:
        """Running logits err-var over history + the open window (None
        until any probe sample exists)."""
        est = (0, 0.0, 0.0)
        for m in self._history:
            est = _merge_moments(est, m)
        est = _merge_moments(est, self._win)
        return est[2] if est[0] else None

    @property
    def layer_err_estimates(self) -> dict:
        """Running per-layer ``(n, mean, var)`` over history + the open
        window (empty unless ``layer_slo`` is configured)."""
        return merge_layer_moments(*self._layer_history, self._layer_win)

    def _layer_ceiling(self, path: str) -> float | None:
        for pat, ceiling in self.cfg.layer_slo:
            if fnmatch.fnmatch(path, pat):
                return ceiling
        return None

    # -- inputs --------------------------------------------------------------

    def observe_probe(self, report: dict) -> GovernorDecision | None:
        """Fold one error-probe report; returns a decision when it closes
        a window that demands a switch.  Reports without logits moments
        (or with n=0 — a zero-sample window) are exact no-ops."""
        lg = (report or {}).get("logits")
        if lg is None or not lg.get("n"):
            return None
        self._win = _merge_moments(
            self._win, (lg["n"], lg["mean"], lg["var"]))
        if self.cfg.layer_slo:
            self._layer_win = merge_layer_moments(
                self._layer_win,
                {path: (st["n"], st["mean"], st["var"])
                 for path, st in (report.get("layers") or {}).items()
                 if st.get("n")})
        self._win_probes += 1
        if self._win_probes < self.cfg.window_probes:
            return None
        return self._close_window()

    def note_fault(self) -> GovernorDecision | None:
        """A detected NaN/divergence fault: unbounded error variance —
        escalate immediately, no window arithmetic."""
        if self.first_breach_window is None:
            self.first_breach_window = self.windows_closed
        return self._switch("escalate", "fault", err_var=None)

    # -- internals -----------------------------------------------------------

    def _close_window(self) -> GovernorDecision | None:
        est = self.err_var_estimate
        layer_ests = (self.layer_err_estimates if self.cfg.layer_slo
                      else {})
        self._history.append(self._win)
        self._win = (0, 0.0, 0.0)
        if self.cfg.layer_slo:
            self._layer_history.append(self._layer_win)
            self._layer_win = {}
        self._win_probes = 0
        self.windows_closed += 1
        if est is None:
            return None
        # per-layer SLOs check FIRST: a single blown layer usually drags
        # the logits estimate over the global SLO too, and the per-layer
        # decision is the one that NAMES the culprit
        worst: tuple[float, str, float] | None = None  # (ratio, path, var)
        layers_clean = True
        for path, (n, _, var) in layer_ests.items():
            ceiling = self._layer_ceiling(path)
            if ceiling is None or not n:
                continue
            if var > ceiling:
                ratio = var / ceiling
                if worst is None or ratio > worst[0]:
                    worst = (ratio, path, var)
            if var > self.cfg.relax_headroom * ceiling:
                layers_clean = False
        if worst is not None:
            if self.first_breach_window is None:
                self.first_breach_window = self.windows_closed - 1
            self._clean = 0
            return self._switch("escalate", "layer_slo_breach",
                                err_var=worst[2], layer=worst[1])
        if est > self.cfg.slo_err_var:
            if self.first_breach_window is None:
                self.first_breach_window = self.windows_closed - 1
            self._clean = 0
            return self._switch("escalate", "slo_breach", err_var=est)
        if est <= self.cfg.relax_headroom * self.cfg.slo_err_var \
                and layers_clean:
            self._clean += 1
            if self._clean >= self.cfg.clean_windows_to_relax:
                return self._switch("relax", "clean_windows", err_var=est)
        else:
            # inside the hysteresis band: neither a breach nor clean
            self._clean = 0
        return None

    def _severe_target(self, est: float) -> int:
        """Severe breach: the first rung past the current one whose
        *modeled* residual clears the SLO.  The probe's err-var tracks the
        approximate array's aggressiveness, which the cost model's power
        saving proxies: ``residual_j ~= est * saving_j / saving_current``
        (an exact rung, saving 0, models residual 0, so the most-exact
        rung always qualifies).  When the current rung's saving is already
        0 the proxy has no signal — fall back to the one-rung walk."""
        cur = self.ladder[self.rung_idx].power_saving_pct
        if cur <= 0:
            return self.rung_idx + 1
        for j in range(self.rung_idx + 1, len(self.ladder)):
            if est * (self.ladder[j].power_saving_pct / cur) \
                    <= self.cfg.slo_err_var:
                return j
        return len(self.ladder) - 1

    def _switch(self, action: str, reason: str, err_var: float | None,
                layer: str | None = None) -> GovernorDecision | None:
        step = 1 if action == "escalate" else -1
        target = self.rung_idx + step
        if not 0 <= target < len(self.ladder):
            return None  # already at the ladder end
        if (action == "escalate" and err_var is not None and layer is None
                and self.cfg.severe_factor is not None
                and err_var >= self.cfg.severe_factor * self.cfg.slo_err_var):
            # severe-jump arithmetic compares err_var against the LOGITS
            # SLO scale, so layer-driven escalations (whose err_var is a
            # per-layer variance) keep the one-rung walk
            target = self._severe_target(err_var)
        d = GovernorDecision(action=action, reason=reason,
                             rung_from=self.ladder[self.rung_idx],
                             rung_to=self.ladder[target],
                             window=self.windows_closed, err_var=err_var,
                             layer=layer)
        self.rung_idx = target
        self.decisions.append(d)
        # new numerics regime: the running estimate must restart
        self._history.clear()
        self._win = (0, 0.0, 0.0)
        self._win_probes = 0
        self._clean = 0
        self._layer_history.clear()
        self._layer_win = {}
        return d
