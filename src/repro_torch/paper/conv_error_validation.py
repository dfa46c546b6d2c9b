"""Validation of the paper's convolution-level error equations.

Eq. 12  (no CV):   E = k*mu_AM,  Var = k*sigma_AM^2
Eq. 20  (CV, perforated/recursive):  Var = Var(x) * sum_j (W_j - E[W])^2
Eqs. 22/28 (CV):   E = 0

Empirical vs analytic, for k=256-term dot products, uniform activations,
fixed random weights — the exact setting of Sec. 3.  The codes are drawn
on the host from ``np.random.default_rng(0)`` in the reference's order;
the products, the control variate and the moments are taken on
``device``.  The exact product is a float64 matmul: 255*255*256 < 2^53,
so it is the integer result (CUDA has no integer matmul).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import control_variate as cv
from repro_torch.core import multipliers as am

K = 256
N_TRIALS = 20_000
POINTS = [("perforated", 1), ("perforated", 2), ("perforated", 3),
          ("recursive", 2), ("recursive", 3), ("recursive", 4),
          ("truncated", 5), ("truncated", 6), ("truncated", 7)]


def run(device="cuda") -> list[dict]:
    dev = resolve_device(device)
    rows = []
    rng = np.random.default_rng(0)
    for mode, m in POINTS:
        w = torch.from_numpy(rng.integers(0, 256, (K, 1))).to(dev)
        a = torch.from_numpy(rng.integers(0, 256, (N_TRIALS, K))).to(dev)
        exact = a.to(torch.float64) @ w.to(torch.float64)
        t0 = time.perf_counter()
        acc = am.approx_matmul(a, w, mode, m).to(torch.float64)
        const = cv.cv_constants(w, mode, m)
        v = cv.cv_term(a, const, mode, m)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) * 1e6

        err_no = exact[:, 0] - acc[:, 0]
        err_cv = exact[:, 0] - acc[:, 0] - v[:, 0]
        mean_cv = float(err_cv.mean())
        std_cv = float(err_cv.std(correction=0))
        row = {
            "name": f"conv_error/{mode}/m{m}",
            "us_per_call": round(dt, 1),
            "mean_no_cv": round(float(err_no.mean()), 1),
            "mean_cv": round(mean_cv, 3),
            "std_no_cv": round(float(err_no.std(correction=0)), 1),
            "std_cv": round(std_cv, 2),
            "rms_improvement": round(
                float(np.sqrt(float((err_no**2).mean())
                              / max(float((err_cv**2).mean()), 1e-12))), 1),
            "mean_nullified": bool(
                abs(mean_cv) < 5 * std_cv / np.sqrt(N_TRIALS) + 1e-9),
        }
        if mode in ("perforated", "recursive"):
            predict = (cv.predicted_var_with_cv_perforated
                       if mode == "perforated"
                       else cv.predicted_var_with_cv_recursive)
            pred = predict(w[:, 0], m)
            row["eq20_var_rel_err"] = round(
                abs(float(err_cv.var(correction=0)) - pred) / pred, 4)
        rows.append(row)
    return rows
