"""Paper Figs. 7-9: power and area of the approximate+CV MAC arrays,
normalized to the exact array, across multipliers x m x array sizes N.

Synthesis tooling is unavailable offline, so these come from the calibrated
component-count cost model (``repro_torch.core.cost_model``); the rows
report model vs paper side by side with deltas, so the calibration quality
is part of the record.
"""

from __future__ import annotations

import time

from repro_torch.core import cost_model as cm

N_SIZES = (16, 32, 48, 64)


def run() -> list[dict]:
    rows = []
    t0 = time.perf_counter()
    cm.power_units(), cm.area_units()  # calibrate once
    calib_us = (time.perf_counter() - t0) * 1e6

    for (mode, m), paper_power in cm.PAPER_POWER_SAVINGS.items():
        paper_area = cm.PAPER_AREA_SAVINGS[(mode, m)]
        per_n_power = {n: round(cm.power_saving(mode, m, n), 1) for n in N_SIZES}
        per_n_area = {n: round(cm.area_saving(mode, m, n), 1) for n in N_SIZES}
        rows.append({
            "name": f"fig7_9/{mode}/m{m}",
            "us_per_call": round(calib_us, 0),
            "power_saving_model_pct": per_n_power,
            "power_saving_paper_pct": paper_power,
            "power_delta_pct": round(per_n_power[64] - paper_power, 1),
            "area_saving_model_pct": per_n_area,
            "area_saving_paper_pct": paper_area,
            "area_delta_pct": round(per_n_area[64] - paper_area, 1),
        })
    return rows
