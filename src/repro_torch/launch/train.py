"""Training (port of ``repro.launch.train``): the step builder
(loss, gradients and AdamW, with mixed precision, gradient accumulation and
int8 error-feedback gradient compression) and a CLI that trains a reduced
model on the synthetic stream through the fault-tolerance stack
(checkpoint/restart, the sharded loader, the straggler monitor).

    python -m repro_torch.launch.train --arch olmo-1b-reduced \
        --steps 50 --batch 8 --seq 128 [--device cpu]

or in code:

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
no backward.

Sharded (``make_train_step(..., mesh=)``, a ``launch.mesh.Mesh``): the
params, AdamW's m and v and the ``ef`` residuals stay sharded at rest per
``train_state_shardings`` (the reference's rules; ``TrainConfig.fsdp``
adds the "data" axis to the weight dims, ``dp_only`` the ZeRO-3 layout),
each rank holding only its pieces (``parallel.sharding.tree_shard``).
The step takes the global batch and keeps this rank's rows of it
(``batch_shardings``).  It gathers every weight whole before its use, at
the step's start (FSDP style, not tensor-parallel DTensors through the
model): each piece is cast to the compute dtype first, so bf16 goes on the
wire (convert-before-gather, ``cast_params``), one all-gather a sharded
dim.  The exception is expert parallelism (``moe_impl="ep_psum"``): a
rank keeps its experts' piece of an expert stack, and the MoE layer
all-reduces its output over the expert axis.  The model then runs on the
rank's rows: with ``cfg.sequence_parallel`` its residual stream is
T-sharded between blocks, and the loss counts each token on one rank
(``models.lm.sharded_ce_loss``).  A whole weight's gradient is all-reduced
(summed) over the mesh and the rank keeps its piece; an expert piece's is
summed over the other axes.  The gradient norm is summed over the mesh,
each piece counted once, and AdamW updates the pieces.  At world size 1
the step is bit for bit the unsharded one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import tempfile
import time
from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.models import build_model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_decompress, compressor_init)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.parallel import P, comm, gather, param_shardings, shard
from repro_torch.parallel.sharding import batch_rows, owns

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    base_lr: float = 3e-4
    warmup_steps: int = 20
    total_steps: int = 1000
    grad_compress: bool = False  # int8 error-feedback gradients
    fsdp: bool = False
    microbatches: int = 1  # gradient accumulation


def cast_params(params: Any, dtype_name: str, shardings: Any = None,
                mesh=None, keep_local=None) -> Any:
    """Mixed precision: float32 master weights -> compute-dtype copies at
    use.  The cast is differentiable, so gradients reach the masters.

    With ``shardings`` (the params' spec tree) and ``mesh``, ``params``
    are this rank's pieces: each piece is cast FIRST and then gathered
    whole (convert-before-gather: the all-gathers move the compute dtype,
    not float32), detached; ``keep_local(path, spec)`` names the pieces a
    rank keeps as they are (expert parallelism's expert stacks)."""
    dt = _DTYPES[dtype_name]

    def cast(p):
        return p.to(dt) if p.dtype == torch.float32 else p

    if shardings is None:
        return tree_map(lambda _, p: cast(p), params)

    def leaf(path, p, spec):
        c = cast(p.detach())
        if keep_local is not None and keep_local(path, spec):
            return c
        return gather(c, spec, mesh)

    return tree_map(leaf, params, shardings)


def _to_device(batch: dict, dev: torch.device) -> dict:
    """A batch of numpy or torch arrays on ``dev``; integer ids as int64
    (the embedding's index type)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=dev)
        out[k] = t.long() if not t.is_floating_point() else t
    return out


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, device=None,
                    mesh=None, param_sh: Any = None, dp_only: bool = False):
    """Returns ``step(state, batch) -> (state, {"loss", "lr"})``; ``state``
    = {"params", "opt"[, "ef"]} as :func:`init_train_state` makes it, the
    batch {"tokens", "labels"[, "mask"]} (B, T).  The step builds a new
    state and leaves the old one as it was.

    ``mesh`` makes it the sharded step of the module docstring: ``state``
    then holds this rank's pieces under ``param_sh`` (default:
    :func:`train_state_shardings`' with ``dp_only``), the batch is the
    global one, and the loss is the whole mesh's."""
    if mesh is not None:
        return _sharded_step(cfg, tcfg, device, mesh, param_sh, dp_only)
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


def _ep_local(cfg: ArchConfig):
    """The predicate of the expert-stack pieces a rank keeps under expert
    parallelism: an expert stack whose expert dim is sharded over the
    expert axis alone."""
    if cfg.mlp != "moe" or cfg.moe_impl != "ep_psum":
        return None
    ep = cfg.moe_config().ep_axis

    def keep(path, spec):
        return (re.search(r"experts/(gate|up|down)/w$", path) is not None
                and len(spec) == 4 and spec[1] == ep
                and all(e is None for i, e in enumerate(spec) if i != 1))

    return keep


def _sharded_step(cfg: ArchConfig, tcfg: TrainConfig, device, mesh,
                  param_sh: Any, dp_only: bool):
    api = build_model(cfg, device)
    lr_fn = warmup_cosine(tcfg.base_lr, tcfg.warmup_steps, tcfg.total_steps)
    if param_sh is None:
        param_sh = train_state_shardings(cfg, tcfg, mesh,
                                         dp_only=dp_only)["params"]
    keep = _ep_local(cfg)
    world = mesh.group(mesh.axis_names)
    ep = cfg.moe_config().ep_axis if keep is not None else None
    others = tuple(a for a in mesh.axis_names if a != ep)

    def reduce_grad(path, g, spec):
        if keep is not None and keep(path, spec):
            return comm.all_reduce(g, mesh.group(others)) if others else g
        return shard(comm.all_reduce(g, world), spec, mesh)

    def loss_and_grads(params, batch, mesh_b):
        live = cast_params(params, cfg.compute_dtype, param_sh, mesh, keep)
        ws = [w.requires_grad_(True) for w in tree_leaves(live)]
        it = iter(ws)
        live = tree_map(lambda _, p: next(it), live)
        with torch.enable_grad():
            loss = api.train_loss(live, batch, mesh=mesh_b)
            # a leaf the loss does not read (the embedding table of an
            # arch that takes embeddings) has a zero gradient
            grads = torch.autograd.grad(loss, ws, allow_unused=True)
        it = iter(torch.zeros_like(w) if g is None else g
                  for g, w in zip(grads, ws))
        return loss.detach(), tree_map(
            lambda path, p, spec: reduce_grad(path, next(it), spec).to(
                p.dtype), params, param_sh)

    def gnorm(grads):
        sq = tree_leaves(tree_map(
            lambda _, g, spec: torch.sum(torch.square(g.to(torch.float32)))
            if owns(spec, mesh) else torch.zeros((), dtype=torch.float32,
                                                 device=g.device),
            grads, param_sh))
        total = comm.all_reduce(torch.sum(torch.stack(sq)), world)
        return torch.sqrt(total)

    def rows(batch):
        """This rank's rows of the global batch, and the mesh that says
        which axes they are split over."""
        batch, axes = batch_rows(_to_device(batch, api.device), mesh,
                                 dp_only)
        return batch, mesh.with_batch_axes(axes)

    def step(state, batch):
        params = state["params"]
        batch, mesh_b = rows(batch)
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches
            loss = torch.zeros((), dtype=torch.float32, device=api.device)
            grads = tree_map(lambda _, p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                lm, gm = loss_and_grads(params, part, mesh_b)
                loss = loss + lm
                grads = tree_map(lambda _, a, g: a + g.to(torch.float32),
                                 grads, gm)
            loss = loss / mb
            grads = tree_map(lambda _, g: g / mb, grads)
        else:
            loss, grads = loss_and_grads(params, batch, mesh_b)
        new_state = {}
        if tcfg.grad_compress:
            grads, new_state["ef"] = compress_decompress(
                grads, state["ef"], reduce_max=lambda a: comm.all_reduce(
                    a, world, torch.distributed.ReduceOp.MAX))
        lr = lr_fn(state["opt"]["step"])
        new_state["params"], new_state["opt"] = adamw_update(
            params, grads, state["opt"], tcfg.optimizer, lr,
            gnorm=gnorm(grads))
        return new_state, {"loss": loss, "lr": lr}

    # (loss, this rank's gradient pieces) of a global batch, the step's
    # own gradients before compression and AdamW
    step.grads = lambda params, batch: loss_and_grads(params, *rows(batch))
    return step


def train_state_shardings(cfg: ArchConfig, tcfg: TrainConfig, mesh,
                          dp_only: bool = False) -> dict:
    """Spec tree matching :func:`init_train_state`'s structure (built on
    the ``meta`` device: shapes only)."""
    abstract = init_train_state(cfg, tcfg, seed=0, device="meta")
    p_sh = param_shardings(abstract["params"], mesh, cfg, fsdp=tcfg.fsdp,
                           dp_only=dp_only)
    out = {"params": p_sh, "opt": {"m": p_sh, "v": p_sh, "step": P()}}
    if tcfg.grad_compress:
        out["ef"] = p_sh
    return out


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


# ---------------------------------------------------------------------------
# The CLI (reduced archs; the card's full-size step is ``make_train_step``)
# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b-reduced")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import ShardedLoader, SyntheticLMConfig
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.runtime import (RetryPolicy, StragglerMonitor,
                                     run_resilient)

    cfg = get_config(args.arch)
    tcfg = TrainConfig(base_lr=args.lr, total_steps=args.steps,
                       grad_compress=args.grad_compress)
    dcfg = SyntheticLMConfig(vocab=cfg.vocab, seq_len=args.seq,
                             batch=args.batch)

    step_fn = make_train_step(cfg, tcfg, device=args.device)
    monitor = StragglerMonitor()
    manager = CheckpointManager(args.ckpt_dir)
    loader = ShardedLoader(lambda s, sh, ns: lm_batch(dcfg, s, sh, ns))
    losses: list[float] = []

    def wrapped(state, batch, step):
        state, metrics = step_fn(state, batch)
        # reading the loss waits for the step, so the monitor times the
        # step and not its launch
        losses.append(float(metrics["loss"]))
        if step % 10 == 0:
            print(f"step {step:5d}  loss {losses[-1]:.4f}")
        return state

    t0 = time.time()
    run_resilient(
        init_state=lambda: init_train_state(cfg, tcfg, seed=0,
                                            device=args.device),
        step_fn=wrapped,
        loader=loader,
        manager=manager,
        total_steps=args.steps,
        policy=RetryPolicy(checkpoint_every=args.ckpt_every),
        monitor=monitor,
    )
    loader.close()
    print(f"done: {args.steps} steps in {time.time()-t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"stragglers={len(monitor.flagged)}")


if __name__ == "__main__":
    main()
