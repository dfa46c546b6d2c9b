"""Paper Fig. 10 in miniature (port of ``examples/pareto_sweep.py``): sweep
the paper-grid numerics specs x {CV, no-CV} on one trained CNN and print
the accuracy-loss vs modeled-power Pareto points.

Trains (or loads the cached) resnet44 on the procedural dataset first,
through ``repro_torch.paper.tables2_4_accuracy`` (weights cached under its
``ART_DIR``).

    PYTHONPATH=src python -m repro_torch.examples.pareto_sweep
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.cnn_suite import get_cnn
from repro_torch.core import cost_model as cm
from repro_torch.examples import example_device
from repro_torch.numerics import apply_numerics, paper_grid_specs
from repro_torch.paper.tables2_4_accuracy import (N_CALIB, accuracy,
                                                  calibrate, dataset,
                                                  train_cnn)


def pareto_sweep(cfg, params, xtr: torch.Tensor, xte: torch.Tensor,
                 yte: torch.Tensor, device, out=print) -> dict:
    """Float accuracy of ``params`` on (``xte``, ``yte``), calibration on
    ``xtr[:N_CALIB]``, then every ``paper_grid_specs`` point with the CV
    and without it on ``device``: (label, normalised modelled power at
    N=64, accuracy loss in points with the CV, without it) a row, and the
    Pareto front of (power, loss with the CV).  Prints the example's
    lines through ``out``."""
    xtr, xte, yte = (t.to(device) for t in (xtr, xte, yte))
    acc_f = accuracy(params, cfg, xte, yte)
    ranges = calibrate(params, cfg, xtr[:N_CALIB])
    out(f"float accuracy: {acc_f:.3f}\n")
    out(f"{'config':22s} {'norm power':>10s} {'dAcc (CV)':>10s} "
        f"{'dAcc (no CV)':>13s}")

    rows, points = [], []
    for spec_cv, spec_no in zip(paper_grid_specs(use_cv=True),
                                paper_grid_specs(use_cv=False)):
        mode, m = spec_cv.default.mode, spec_cv.default.m
        accs = {}
        for cv, spec in ((True, spec_cv), (False, spec_no)):
            packed = apply_numerics(params, spec.resolve(params),
                                    act_ranges=ranges)
            accs[cv] = accuracy(packed, cfg, xte, yte)
        power = 1 - cm.power_saving(mode, m, 64) / 100
        d_cv, d_no = 100 * (acc_f - accs[True]), 100 * (acc_f - accs[False])
        label = f"{mode}/m{m}"
        points.append((power, d_cv, label))
        rows.append((label, power, d_cv, d_no))
        out(f"{label:22s} {power:10.3f} {d_cv:9.2f}% {d_no:12.2f}%")

    front = []
    for p in sorted(points):
        if not front or p[1] < front[-1][1]:
            front.append(p)
    out("\nPareto front (power, accuracy-loss):")
    for p, d, lbl in front:
        out(f"  {lbl:20s} power={p:.3f}  dAcc={d:.2f}%")
    return {"acc_float": acc_f, "rows": rows, "front": front}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    xtr, ytr, xte, yte = dataset(10, dev)
    cfg = get_cnn("resnet44", 10)
    params, _ = train_cnn("resnet44", cfg, xtr, ytr, device=dev)
    pareto_sweep(cfg, params, xtr, xte, yte, dev)


if __name__ == "__main__":
    main()
