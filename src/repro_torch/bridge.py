"""Carry float parameters from a reference (JAX) checkpoint tree into the
port's layout.

The input is the flat ``{"/"-joined path: ndarray}`` mapping that
``repro.checkpoint.manager._flatten`` produces; the scan-stacked
``blocks/*`` leaves keep their leading layer axis, which is also the port's
layout.  Only numpy crosses the boundary, so this module imports nothing
of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def from_jax_params(flat: dict[str, np.ndarray], cfg: ArchConfig,
                    device="cpu") -> dict:
    """Flat reference parameters -> the port's nested parameter dict."""
    out: dict = {}
    for key, arr in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _to_tensor(arr, device)
    if cfg.norm == "nonparametric_ln":  # parameter-free norms: no leaves
        blocks = out.get("blocks", {})
        for key in ("attn_norm", "mlp_norm"):
            blocks.setdefault(key, {})
        out.setdefault("final_norm", {})
    bad = [k for k, a in flat.items()
           if k.startswith("blocks/") and np.shape(a)[0] != cfg.n_layers]
    if bad:
        raise ValueError(f"block leaves without a leading {cfg.n_layers}-layer "
                         f"axis: {bad[:3]}")
    return out
