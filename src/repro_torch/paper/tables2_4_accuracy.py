"""Paper Tables 2-4: CNN inference accuracy under each approximate multiplier
x approximation level, with vs without the control variate V.

CIFAR is unavailable offline; the paper's TREND is validated on the same
model families over the procedural 32x32x3 dataset at matching class
counts (10 and 100).  Networks are trained on ``device`` (autograd through
the float ``cnn_apply``: SGD with momentum 0.9, the reference's learning
rate schedule, batch and batch indices), cached under
``artifacts/cnn_torch/``, calibrated on held-out batches, then packed for
every (multiplier, m) x {CV, no CV} and evaluated.

Columns mirror the paper: accuracy loss vs the float model, "Ours" (with V)
vs "w/o V".  The grid is ``paper_grid_specs``.  On ``backend="pallas"``
(the default) every conv and head of every grid point runs the
approx-matmul kernel on the card; the reference ran its default ``"jnp"``
backend, which the CPU tests pass to match it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.cnn_suite import CNN_SUITE, get_cnn
from repro_torch.data.vision import VisionConfig, make_vision_dataset
from repro_torch.nn.cnn import cnn_apply, init_cnn
from repro_torch.numerics import apply_numerics, paper_grid_specs
from repro_torch.quant.observers import CalibrationRecorder

ART_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
    "artifacts", "cnn_torch"))
N_TRAIN, N_TEST, N_CALIB = 4000, 1000, 256
TRAIN_STEPS, BATCH = 300, 64


def _map(fn, tree):
    """``fn`` over every tensor of a float parameter tree (dicts, lists)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return [_map(fn, v) for v in tree]


def _leaves(tree) -> list[torch.Tensor]:
    out = []
    _map(out.append, tree)
    return out


def _shapes(tree, path: str = "") -> dict[str, tuple]:
    """Each leaf's shape by its path (trees carried by ``bridge`` hold
    their keys in another order than ``init_cnn``'s)."""
    if isinstance(tree, torch.Tensor):
        return {path: tuple(tree.shape)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{path}/{k}"))
    return out


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms (the depthwise conv's backward)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def initial_params(cfg, dev):
    """``init_cnn`` from a generator on ``dev`` seeded with 0."""
    return init_cnn(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)


def weights_path(name: str, cfg) -> str:
    return os.path.join(ART_DIR, f"{name}_c{cfg.num_classes}.pt")


def _load_weights(path: str, cfg, like, dev):
    """(params, losses) from a weights file that matches ``cfg`` and the
    leaf shapes of ``like``; None if there is none or it no longer
    matches (the caller retrains, as the reference does)."""
    try:
        blob = torch.load(path, map_location=dev, weights_only=True)
    except FileNotFoundError:
        return None
    if blob["cfg"] != dataclasses.asdict(cfg) or \
            _shapes(blob["params"]) != _shapes(like):
        return None
    return blob["params"], blob["losses"]


def train_cnn(name: str, cfg, xtr, ytr, params=None, device="cuda"):
    """SGD+momentum training of the float model (cached): TRAIN_STEPS
    steps of :func:`sgd_steps`.

    ``params`` is the initial tree (default: :func:`initial_params`).
    Every leaf is trained, BN scale and bias included.  Returns the
    trained tree (detached) and each step's loss; a weights file of the
    same net, class count and config is loaded in place of training."""
    dev = resolve_device(device)
    if params is None:
        params = initial_params(cfg, dev)
    path = weights_path(name, cfg)
    cached = _load_weights(path, cfg, params, dev)
    if cached is not None:
        return cached

    params, losses = sgd_steps(params, cfg, xtr, ytr, TRAIN_STEPS, dev)
    save_weights(path, cfg, params, losses)
    return params, losses


def sgd_steps(params, cfg, xtr, ytr, steps: int, dev):
    """The first ``steps`` steps of the reference's recipe from ``params``
    on ``dev``: SGD with momentum 0.9 and no dampening (the first step's
    buffer is the gradient, as the reference's zero-initialised ``mom``),
    lr 0.05 * min(1, (i+1)/50) * 0.5**(i // 200), batches of BATCH from
    ``np.random.default_rng(0).integers(0, n, BATCH)``.  Returns the
    trained tree (detached) and each step's loss."""
    p = _map(lambda t: t.detach().to(dev).clone().requires_grad_(True),
             params)
    opt = torch.optim.SGD(_leaves(p), lr=0.0, momentum=0.9)
    x_all = torch.as_tensor(xtr).to(dev)
    # the one-hot product picks each row's log-probability without a
    # gather, whose CUDA backward accumulates with atomics
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(ytr).to(dev).long(), cfg.num_classes).float()
    n = x_all.shape[0]
    rng = np.random.default_rng(0)
    losses = []
    with _deterministic_cudnn():
        for i in range(steps):
            idx = torch.from_numpy(rng.integers(0, n, BATCH)).to(dev)
            lr = 0.05 * min(1.0, (i + 1) / 50) * (0.5 ** (i // 200))
            for group in opt.param_groups:
                group["lr"] = lr
            logp = torch.log_softmax(cnn_apply(p, x_all[idx], cfg), -1)
            loss = -(logp * onehot[idx]).sum(-1).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    return _map(torch.Tensor.detach, p), torch.stack(losses).tolist()


def save_weights(path: str, cfg, params, losses: list[float]) -> None:
    """The weights file: the config, the tree (on the host) and the loss
    of each training step."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"cfg": dataclasses.asdict(cfg),
                "params": _map(lambda t: t.cpu(), params),
                "losses": losses}, path)


@torch.no_grad()
def accuracy(params, cfg, x, y, batch=250) -> float:
    correct = 0
    for i in range(0, x.shape[0], batch):
        lg = cnn_apply(params, x[i:i + batch], cfg)
        correct += (lg.argmax(-1) == y[i:i + batch]).sum()
    return int(correct) / x.shape[0]


@torch.no_grad()
def calibrate(params, cfg, x_calib) -> dict:
    with CalibrationRecorder() as rec:
        cnn_apply(params, x_calib, cfg)
    return rec.ranges()


def dataset(num_classes: int, dev):
    """(x_train, y_train, x_test, y_test) of the procedural dataset on
    ``dev``: N_TRAIN and N_TEST images."""
    vcfg = VisionConfig(num_classes=num_classes)
    out = []
    for split, n in (("train", N_TRAIN), ("test", N_TEST)):
        x, y = make_vision_dataset(vcfg, split, n)
        out += [torch.from_numpy(x).to(dev),
                torch.from_numpy(y).long().to(dev)]
    return tuple(out)


def key_of(net: str, num_classes: int, spec) -> str:
    p = spec.default
    return f"tables2_4/{net}/c{num_classes}/{p.mode}/m{p.m}"


def _cache_path():
    return os.path.join(ART_DIR, "results_cache.json")


def _load_cache() -> dict:
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (FileNotFoundError, ValueError):
        return {}


def _save_cache(cache: dict) -> None:
    os.makedirs(ART_DIR, exist_ok=True)
    with open(_cache_path(), "w") as f:
        json.dump(cache, f)


def run(nets: list[str] | None = None, class_counts=(10, 100),
        device="cuda", backend="pallas") -> list[dict]:
    rows = []
    cache = _load_cache()
    nets = nets or list(CNN_SUITE)
    if os.environ.get("BENCH_CACHED_ONLY"):
        rows = sorted(cache.values(), key=lambda r: r["name"])
        done = {r["name"].split("/")[1] + "/" + r["name"].split("/")[2] for r in rows}
        rows.append({"name": "tables2_4/coverage",
                     "nets_completed": sorted(done),
                     "note": "cached rows only (background training fills the rest)"})
        return rows
    dev = resolve_device(device)
    # the Tables 2-4 grid, one uniform spec per (multiplier, m) x {CV, no-CV}
    # (no skip rules: every conv/linear packs, matching the paper setup)
    grid = list(zip(paper_grid_specs(use_cv=True, backend=backend),
                    paper_grid_specs(use_cv=False, backend=backend)))
    for num_classes in class_counts:
        xtr, ytr, xte, yte = dataset(num_classes, dev)
        for net in nets:
            cfg = get_cnn(net, num_classes)
            todo = [pair for pair in grid
                    if key_of(net, num_classes, pair[0]) not in cache]
            if not todo:
                rows.extend(cache[key_of(net, num_classes, cv_spec)]
                            for cv_spec, _ in grid)
                continue
            t0 = time.perf_counter()
            params, _ = train_cnn(net, cfg, xtr, ytr, device=dev)
            train_us = (time.perf_counter() - t0) * 1e6
            acc_float = accuracy(params, cfg, xte, yte)
            ranges = calibrate(params, cfg, xtr[:N_CALIB])

            for spec_cv, spec_no in grid:
                key = key_of(net, num_classes, spec_cv)
                if key in cache:
                    rows.append(cache[key])
                    continue
                accs = {}
                for use_cv, spec in ((True, spec_cv), (False, spec_no)):
                    packed = apply_numerics(params, spec.resolve(params),
                                            act_ranges=ranges)
                    accs[use_cv] = accuracy(packed, cfg, xte, yte)
                row = {
                    "name": key,
                    "us_per_call": round(train_us, 0),
                    "acc_float": round(acc_float, 4),
                    "acc_cv": round(accs[True], 4),
                    "acc_no_cv": round(accs[False], 4),
                    "loss_cv_pct": round(100 * (acc_float - accs[True]), 2),
                    "loss_no_cv_pct": round(100 * (acc_float - accs[False]), 2),
                }
                cache[key] = row
                _save_cache(cache)
                rows.append(row)
    return rows
