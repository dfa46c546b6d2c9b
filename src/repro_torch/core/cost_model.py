"""Analytical MAC-array area/power model (port of
``repro.core.cost_model``; paper Sec. 4-5.1, Figs. 7-9, Table 5).

The paper synthesizes N x N systolic arrays at 14nm and reports power/area
of the approximate+CV arrays normalized to the exact array.  This is a
component-count cost model of the microarchitecture the paper describes:

  MAC   (exact):   8x8 multiplier (64 pp bits, reduction tree, 16b CPA) +
                   W_acc-bit accumulator adder + pipeline FFs,
                   W_acc = ceil(log2(N * (2^16 - 1))).
  MAC*  (approx):  multiplier with pruned pp bits (per multiplier family and
                   m), accumulator reduced by m bits, PLUS the sumX path:
                   perforated/recursive — ceil(log2(N*(2^m-1)))-bit adder+FFs;
                   truncated — m-input OR + ceil(log2 N)-bit adder+FFs.
  MAC+  (CV col):  exact multiplier of width (sumX bits x 8) + W_acc adder
                   + FFs (one column of N units, Sec. 4.4).

Partial-product bits removed:  perforated m -> 8m;  truncated m ->
m(m+1)/2;  recursive m -> m^2.  Reduction-tree compressor count scales with
pp bits; final CPA width is 16 - m for all three families (Sec. 4.1-4.3).

Unit energies/areas (AND gate, FA in tree, CPA bit, FF bit, OR input) are
the model's free parameters, least-squares calibrated once against the
paper's reported power/area percentages (the constants below quote the
paper text; Fig. 9's per-point recursive values are stated as
ranges/averages in the text, so its midpoints are annotated as inferred).
Pure numpy and Python: the numbers equal the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from repro_torch.core.multipliers import Mode

ACC_BITS_FULL = 16  # product width of the exact 8x8 multiplier


def _clog2(x: float) -> int:
    return int(math.ceil(math.log2(x)))


def pp_bits_removed(mode: Mode, m: int) -> int:
    if mode == "exact" or m == 0:
        return 0
    if mode == "perforated":
        return 8 * m
    if mode == "truncated":
        return m * (m + 1) // 2
    if mode == "recursive":
        return m * m
    raise ValueError(mode)


@dataclasses.dataclass(frozen=True)
class UnitCosts:
    """Relative cost of primitive components (calibrated), plus family
    activity factors.

    For POWER the removed partial-product hardware is weighted by a
    per-family activity factor: perforation removes entire high-toggle pp
    *rows* (and their reduction-tree glitching, plus iso-delay gate
    downsizing from the shortened tree — Sec. 4.4's "delay slack ... boosts
    further the area and power savings"), truncation removes the glitchiest
    low-significance *columns*, recursion removes a square low x low block.
    For AREA all activity factors are 1 (area is purely structural).
    ``plus_activity`` discounts the MAC+ column (C operand is static per
    filter, so its multiplier toggles far less — calibrated to Table 5).
    """

    and_gate: float  # pp generation AND
    fa: float  # compressor/full-adder in reduction tree
    cpa_bit: float  # carry-propagate adder bit
    ff: float  # flip-flop bit
    or_in: float  # OR-gate input (truncated x_j)
    act_perforated: float = 1.0  # activity weight of removed pp hardware
    act_truncated: float = 1.0
    act_recursive: float = 1.0
    plus_activity: float = 1.0  # MAC+ switching discount

    def activity(self, mode: Mode) -> float:
        return {
            "perforated": self.act_perforated,
            "truncated": self.act_truncated,
            "recursive": self.act_recursive,
            "exact": 1.0,
        }[mode]


@dataclasses.dataclass(frozen=True)
class UnitBreakdown:
    mult: float
    acc_adder: float
    sumx: float
    ffs: float

    @property
    def total(self) -> float:
        return self.mult + self.acc_adder + self.sumx + self.ffs


def mac_cost(mode: Mode, m: int, n_array: int, u: UnitCosts,
             with_cv: bool = True) -> UnitBreakdown:
    """Cost of one MAC (exact) or MAC* (approx) processing element.

    The exact-MAC cost is computed with activity 1; the approximate MAC's
    *removed* hardware is credited at the family activity weight (>=1 means
    the removed bits were hotter than average — see UnitCosts docstring).
    """
    w_acc = _clog2(n_array * (2**ACC_BITS_FULL - 1))
    removed = pp_bits_removed(mode, m) * u.activity(mode)
    pp = max(64.0 - removed, 0.0)
    prod_bits = ACC_BITS_FULL if mode == "exact" or m == 0 else ACC_BITS_FULL - m
    mult = u.and_gate * pp + u.fa * max(pp - prod_bits, 0) + u.cpa_bit * prod_bits
    acc = u.cpa_bit * (w_acc - (ACC_BITS_FULL - prod_bits))
    # pipeline FFs: product reg + accumulator reg
    ffs = u.ff * (prod_bits + w_acc)
    sumx = 0.0
    if with_cv and mode != "exact" and m > 0:
        if mode in ("perforated", "recursive"):
            sx_bits = _clog2(n_array * (2**m - 1))
            sumx = u.cpa_bit * sx_bits * 0.5 + u.ff * sx_bits  # ripple-carry: 0.5x
        else:  # truncated: m-input OR + log2(N) counter
            sx_bits = _clog2(n_array)
            sumx = u.or_in * m + u.cpa_bit * sx_bits * 0.5 + u.ff * sx_bits
    return UnitBreakdown(mult=mult, acc_adder=acc, sumx=sumx, ffs=ffs)


def mac_plus_cost(mode: Mode, m: int, n_array: int, u: UnitCosts) -> UnitBreakdown:
    """Cost of one MAC+ unit (the extra CV column, Sec. 4.4).

    The whole unit is scaled by ``plus_activity``: the C operand is a
    per-filter constant, so the multiplier's switching is far below a MAC*'s
    (for area calibration plus_activity stays 1).
    """
    w_acc = _clog2(n_array * (2**ACC_BITS_FULL - 1))
    if mode in ("perforated", "recursive"):
        mul_w = _clog2(n_array * (2**m - 1))
    else:
        mul_w = _clog2(n_array)
    pp = mul_w * 8
    s = u.plus_activity
    mult = s * (u.and_gate * pp + u.fa * max(pp - (mul_w + 8), 0) + u.cpa_bit * (mul_w + 8))
    acc = s * u.cpa_bit * w_acc
    ffs = s * u.ff * (w_acc + mul_w + 8)
    return UnitBreakdown(mult=mult, acc_adder=acc, sumx=0.0, ffs=ffs)


def array_cost(mode: Mode, m: int, n_array: int, u: UnitCosts,
               with_cv: bool = True) -> float:
    """Total cost of the N x N (+1 CV column) array."""
    pe = mac_cost(mode, m, n_array, u, with_cv=with_cv).total * n_array * n_array
    plus = (
        mac_plus_cost(mode, m, n_array, u).total * n_array
        if with_cv and mode != "exact" and m > 0
        else 0.0
    )
    return pe + plus


def normalized_cost(mode: Mode, m: int, n_array: int, u: UnitCosts,
                    with_cv: bool = True) -> float:
    """Approximate-array cost normalized to the exact array (paper's y-axis)."""
    return array_cost(mode, m, n_array, u, with_cv) / array_cost(
        "exact", 0, n_array, u, with_cv=False
    )


def mac_plus_fraction(mode: Mode, m: int, n_array: int, u: UnitCosts) -> float:
    """Table 5: MAC+ share of total array cost (percent)."""
    plus = mac_plus_cost(mode, m, n_array, u).total * n_array
    return 100.0 * plus / array_cost(mode, m, n_array, u, with_cv=True)


# ---------------------------------------------------------------------------
# Paper-reported savings (percent power/area reduction vs exact array).
# Midpoints of the ranges given in Sec. 5.1; entries marked inferred=True are
# reconstructed from textual averages/maxima because the figure axis values
# are not in the text.
# ---------------------------------------------------------------------------

PAPER_POWER_SAVINGS: dict[tuple[str, int], float] = {
    ("perforated", 1): 28.45,
    ("perforated", 2): 35.10,
    ("perforated", 3): 45.25,
    ("truncated", 5): 24.45,
    ("truncated", 6): 31.80,
    ("truncated", 7): 40.15,
    ("recursive", 2): 9.0,  # inferred: avg 17%, max 26% over m in [2,4]
    ("recursive", 3): 17.0,  # inferred
    ("recursive", 4): 25.0,  # inferred
}

PAPER_AREA_SAVINGS: dict[tuple[str, int], float] = {
    ("perforated", 1): 1.0,  # "almost the same as the accurate MAC"
    ("perforated", 2): 10.0,  # average 10%
    ("perforated", 3): 21.0,  # up to 22%
    ("truncated", 5): 23.0,  # avg 31%, max 39% at m=7 (inferred spread)
    ("truncated", 6): 31.0,
    ("truncated", 7): 38.0,
    ("recursive", 2): -7.0,  # m=2: overhead (up to -14% at N=16)
    ("recursive", 3): 2.0,  # inferred
    ("recursive", 4): 7.0,  # max 8%
}


#: Table 5 (power %, perforated) — MAC+ share of total array power, used to
#: calibrate ``plus_activity``.
PAPER_TABLE5_POWER_PERF = {
    (1, 16): 1.22, (1, 32): 0.63, (1, 48): 0.43, (1, 64): 0.32,
    (2, 16): 1.32, (2, 32): 0.68, (2, 48): 0.46, (2, 64): 0.35,
    (3, 16): 1.52, (3, 32): 0.80, (3, 48): 0.53, (3, 64): 0.40,
}
PAPER_TABLE5_AREA_PERF = {
    (1, 16): 1.07, (1, 32): 0.55, (1, 48): 0.38, (1, 64): 0.28,
    (2, 16): 1.18, (2, 32): 0.61, (2, 48): 0.41, (2, 64): 0.31,
    (3, 16): 1.36, (3, 32): 0.71, (3, 48): 0.47, (3, 64): 0.36,
}


def _calibrate(
    target: dict[tuple[str, int], float],
    table5: dict[tuple[int, int], float],
    fit_activity: bool,
    n_array: int = 64,
) -> UnitCosts:
    """Least-squares fit of unit costs (+ optional activity factors) to the
    paper's normalized savings, then ``plus_activity`` to Table 5.

    Coordinate-descent keeps it dependency-free (no scipy).
    """
    pts = list(target.items())

    def loss(u: UnitCosts) -> float:
        err = 0.0
        for (mode, m), saving in pts:
            model = normalized_cost(mode, m, n_array, u)
            err += (model - (1.0 - saving / 100.0)) ** 2
        return err

    fields = ["and_gate", "fa", "cpa_bit", "ff", "or_in"]
    if fit_activity:
        fields += ["act_perforated", "act_truncated", "act_recursive"]

    u = UnitCosts(0.5, 3.0, 2.0, 1.0, or_in=0.3)
    best_l = loss(u)
    step = 0.5
    for _ in range(400):
        improved = False
        for field in fields:
            for d in (+step, -step):
                cand = dataclasses.replace(
                    u, **{field: min(max(getattr(u, field) + d, 0.01), 8.0)}
                )
                l = loss(cand)
                if l < best_l:
                    u, best_l, improved = cand, l, True
        if not improved:
            step *= 0.5
            if step < 1e-3:
                break

    # Second stage: plus_activity against Table 5 (closed-form-ish scan).
    def t5_loss(u: UnitCosts) -> float:
        err = 0.0
        for (m, n), frac in table5.items():
            err += (mac_plus_fraction("perforated", m, n, u) - frac) ** 2
        return err

    best_pa, best = 1.0, float("inf")
    for pa in np.linspace(0.02, 1.5, 149):
        cand = dataclasses.replace(u, plus_activity=float(pa))
        l = t5_loss(cand)
        if l < best:
            best_pa, best = float(pa), l
    return dataclasses.replace(u, plus_activity=best_pa)


@functools.cache
def power_units() -> UnitCosts:
    """Unit costs fitted to the paper's power savings (computed once)."""
    return _calibrate(PAPER_POWER_SAVINGS, PAPER_TABLE5_POWER_PERF,
                      fit_activity=True)


@functools.cache
def area_units() -> UnitCosts:
    """Unit costs fitted to the paper's area savings (computed once)."""
    return _calibrate(PAPER_AREA_SAVINGS, PAPER_TABLE5_AREA_PERF,
                      fit_activity=False)


def power_saving(mode: Mode, m: int, n_array: int) -> float:
    """Modeled % power reduction of the CV array vs the exact array."""
    return 100.0 * (1.0 - normalized_cost(mode, m, n_array, power_units()))


def area_saving(mode: Mode, m: int, n_array: int) -> float:
    return 100.0 * (1.0 - normalized_cost(mode, m, n_array, area_units()))
