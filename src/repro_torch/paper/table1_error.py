"""Paper Table 1: error mean/std of the three approximate multipliers over
1M random 8-bit operand pairs, uniform U(0,255) and normal N(125, 24^2).

The samples are drawn on the host from ``np.random.default_rng(0)`` in
the reference's order; the moments are taken on ``device``."""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import multipliers as am

PAPER = {
    ("perforated", "uniform"): {1: (63.7, 82), 2: (191, 198), 3: (447, 425)},
    ("perforated", "normal"): {1: (62.4, 64.7), 2: (187, 146), 3: (435, 302)},
    ("recursive", "uniform"): {2: (2.24, 2.67), 3: (12.26, 12.51), 4: (56, 53.4), 5: (239, 219)},
    ("recursive", "normal"): {2: (2.25, 2.68), 3: (12.24, 12.47), 4: (56.2, 53.4), 5: (239, 219)},
    ("truncated", "uniform"): {4: (12, 9.9), 5: (32, 23), 6: (80, 52), 7: (192, 115)},
    ("truncated", "normal"): {4: (12.6, 9.9), 5: (32.2, 23), 6: (80.6, 52.8), 7: (192, 127)},
}

N_SAMPLES = 1_000_000


def _samples(dist: str, rng) -> np.ndarray:
    if dist == "uniform":
        return rng.integers(0, 256, N_SAMPLES)
    return np.clip(np.round(rng.normal(125, 24, N_SAMPLES)), 0, 255).astype(np.int64)


def samples():
    """(mode, dist, w, a) for each PAPER entry, int64 numpy codes drawn in
    the reference's order."""
    rng = np.random.default_rng(0)
    for mode, dist in PAPER:
        w = _samples(dist, rng)
        a = _samples(dist, rng)
        yield mode, dist, w, a


def run(device="cuda") -> list[dict]:
    dev = resolve_device(device)
    rows = []
    for mode, dist, w, a in samples():
        w = torch.from_numpy(w).to(dev)
        a = torch.from_numpy(a).to(dev)
        for m, (mu_p, sig_p) in PAPER[(mode, dist)].items():
            t0 = time.perf_counter()
            mu, sig = am.empirical_error_moments(mode, m, w, a)
            dt = (time.perf_counter() - t0) * 1e6
            rows.append({
                "name": f"table1/{mode}/{dist}/m{m}",
                "us_per_call": round(dt, 1),
                "mu": round(mu, 2), "sigma": round(sig, 2),
                "mu_paper": mu_p, "sigma_paper": sig_p,
                "mu_rel_err": round(abs(mu - mu_p) / max(mu_p, 1e-9), 4),
                "sigma_rel_err": round(abs(sig - sig_p) / max(sig_p, 1e-9), 4),
            })
    return rows
