"""AdamW with decoupled weight decay and global-norm gradient clipping
(port of ``repro.optim.adamw``).

Parameters, gradients and moments are nested dicts (lists where the model
keeps them, e.g. ``dense_blocks``) of tensors.  A leaf's path is its keys
and list indices joined by "/" (``blocks/attn/q/w``), the string the
reference builds from its pytree paths, so the decay mask decides the same
way.  The moment dtype is configurable (float32 by default)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" halves m/v memory


def tree_map(fn: Callable, tree: Any, *rest: Any, path: str = "") -> Any:
    """``fn(path, leaf, *other leaves)`` over matching nested dicts and
    lists of tensors (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest),
                            path=f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest),
                         path=f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(lambda _, leaf: out.append(leaf), tree)
    return out


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    mdt = _DTYPES[cfg.moment_dtype]
    zeros = lambda _, p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": 0}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    sq = [torch.sum(torch.square(leaf.to(torch.float32)))
          for leaf in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _decay_mask(path: str, leaf: torch.Tensor) -> bool:
    """No weight decay on norms, scales, biases named ``bias`` and 1-D
    leaves (the reference's rule, path string for path string)."""
    if leaf.ndim <= 1:
        return False
    return not any(s in path for s in ("norm", "scale", "bias", "ln_"))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                 lr, gnorm: torch.Tensor | None = None) -> tuple[Any, dict]:
    """One step: clip the gradients to ``cfg.clip_norm`` by their global
    norm, update the moments, apply the bias-corrected step plus decoupled
    decay at rate ``lr``.  Returns (new params, new state); the inputs are
    not modified.  ``gnorm`` overrides the norm of ``grads`` (a sharded
    step passes the norm over the whole mesh and updates its pieces)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = int(state["step"]) + 1
    c1 = 1.0 - _f32(cfg.b1) ** _f32(step)
    c2 = 1.0 - _f32(cfg.b2) ** _f32(step)
    mdt = _DTYPES[cfg.moment_dtype]
    f32 = torch.float32
    lr = torch.as_tensor(lr, dtype=f32)

    def upd(path, p, g, m, v):
        dev = p.device
        g = g.to(f32) * scale
        m32 = cfg.b1 * m.to(f32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(f32) + (1 - cfg.b2) * g * g
        update = (m32 / c1.to(dev)) / (torch.sqrt(v32 / c2.to(dev))
                                       + cfg.eps)
        if _decay_mask(path, p):
            update = update + cfg.weight_decay * p.to(f32)
        new_p = p.to(f32) - lr.to(dev) * update
        return new_p.to(p.dtype), m32.to(mdt), v32.to(mdt)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda _, t: t[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}
