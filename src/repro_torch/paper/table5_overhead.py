"""Paper Table 5: the MAC+ column's share of total array area/power, per
multiplier x m x N — the 'CV costs ~1%' scalability claim, from the
calibrated cost model, with the paper's perforated-power entries compared
directly."""

from __future__ import annotations

import time

from repro_torch.core import cost_model as cm

CONFIGS = {
    "perforated": (1, 2, 3),
    "recursive": (2, 3, 4),
    "truncated": (5, 6, 7),
}
N_SIZES = (16, 32, 48, 64)


def run() -> list[dict]:
    rows = []
    up, ua = cm.power_units(), cm.area_units()
    for mode, ms in CONFIGS.items():
        for m in ms:
            t0 = time.perf_counter()
            power_frac = {n: round(cm.mac_plus_fraction(mode, m, n, up), 2)
                          for n in N_SIZES}
            area_frac = {n: round(cm.mac_plus_fraction(mode, m, n, ua), 2)
                         for n in N_SIZES}
            dt = (time.perf_counter() - t0) * 1e6
            row = {
                "name": f"table5/{mode}/m{m}",
                "us_per_call": round(dt, 1),
                "macplus_power_pct": power_frac,
                "macplus_area_pct": area_frac,
                "scales_inversely_with_n": power_frac[16] > power_frac[64],
            }
            if mode == "perforated":
                row["paper_power_pct"] = {
                    n: cm.PAPER_TABLE5_POWER_PERF[(m, n)] for n in N_SIZES}
            rows.append(row)
    return rows
