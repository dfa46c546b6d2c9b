"""Training step (port of the step half of ``repro.launch.train``): loss,
gradients and AdamW, with mixed precision, gradient accumulation and int8
error-feedback gradient compression.

    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)
    from repro_torch.data.synthetic import SyntheticLMConfig, lm_batch

    cfg = get_config("olmo-1b-reduced")
    tcfg = TrainConfig(base_lr=1e-3, total_steps=50)
    state = init_train_state(cfg, tcfg, seed=0, device="cpu")
    step = make_train_step(cfg, tcfg, device="cpu")
    dcfg = SyntheticLMConfig(vocab=cfg.vocab, seq_len=128, batch=8)
    for i in range(50):
        state, metrics = step(state, lm_batch(dcfg, i))

The step runs the model's training path (``api.train_loss``: plain
attention and WKV, ``cfg.remat``), never the inference kernels, which have
no backward.  The reference's CLI (checkpoint/restart, the sharded loader,
the straggler monitor) and its sharding arguments wait for the
checkpoint, runtime and distributed slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import build_model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_decompress, compressor_init)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.schedules import warmup_cosine

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    base_lr: float = 3e-4
    warmup_steps: int = 20
    total_steps: int = 1000
    grad_compress: bool = False  # int8 error-feedback gradients
    microbatches: int = 1  # gradient accumulation


def cast_params(params: Any, dtype_name: str) -> Any:
    """Mixed precision: float32 master weights -> compute-dtype copies at
    use.  The cast is differentiable, so gradients reach the masters."""
    dt = _DTYPES[dtype_name]
    return tree_map(lambda _, p: p.to(dt) if p.dtype == torch.float32
                    else p, params)


def _to_device(batch: dict, dev: torch.device) -> dict:
    """A batch of numpy or torch arrays on ``dev``; integer ids as int64
    (the embedding's index type)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=dev)
        out[k] = t.long() if not t.is_floating_point() else t
    return out


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, device=None):
    """Returns ``step(state, batch) -> (state, {"loss", "lr"})``; ``state``
    = {"params", "opt"[, "ef"]} as :func:`init_train_state` makes it, the
    batch {"tokens", "labels"[, "mask"]} (B, T).  The step builds a new
    state and leaves the old one as it was."""
    api = build_model(cfg, device)
    lr_fn = warmup_cosine(tcfg.base_lr, tcfg.warmup_steps, tcfg.total_steps)

    def loss_and_grads(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _, p: next(it), params)
        with torch.enable_grad():
            loss = api.train_loss(cast_params(live, cfg.compute_dtype),
                                  batch)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), tree_map(lambda _, p: next(it), params)

    def step(state, batch):
        params = state["params"]
        batch = _to_device(batch, api.device)
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches
            loss = torch.zeros((), dtype=torch.float32, device=api.device)
            grads = tree_map(lambda _, p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                lm, gm = loss_and_grads(params, part)
                loss = loss + lm
                grads = tree_map(lambda _, a, g: a + g.to(torch.float32),
                                 grads, gm)
            loss = loss / mb
            grads = tree_map(lambda _, g: g / mb, grads)
        else:
            loss, grads = loss_and_grads(params, batch)
        new_state = {}
        if tcfg.grad_compress:
            grads, new_state["ef"] = compress_decompress(grads, state["ef"])
        lr = lr_fn(state["opt"]["step"])
        new_state["params"], new_state["opt"] = adamw_update(
            params, grads, state["opt"], tcfg.optimizer, lr)
        return new_state, {"loss": loss, "lr": lr}

    return step


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig, seed: int = 0,
                     device=None, params: Any = None) -> dict:
    """{"params": the seeded float32 init (or ``params``), "opt": AdamW's
    zero moments[, "ef": zero residuals under ``grad_compress``]} on
    ``device`` (default ``cuda``; raises without it)."""
    api = build_model(cfg, device)
    if params is None:
        params = api.init(seed)
    state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
    if tcfg.grad_compress:
        state["ef"] = compressor_init(params)
    return state
