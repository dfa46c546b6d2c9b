"""Carry float parameters from a reference (JAX) checkpoint tree into the
port's layout.

The input is the flat ``{"/"-joined path: ndarray}`` mapping that
``repro.checkpoint.manager._flatten`` produces.  A segment that indexes a
list in the reference's tree (a CNN's ``stages/0/1/conv/w``) is an integer,
and those nodes become lists again; the LLMs' scan-stacked ``blocks/*``
leaves keep their leading layer axis, which is also the port's layout.
Only numpy crosses the boundary, so this module imports nothing of JAX.
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


def _listify(node):
    """Nodes whose keys are exactly 0..n-1 -> lists, depth first."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def _nest(flat: dict[str, np.ndarray], device="cpu") -> dict:
    """Flat reference parameters -> the port's nested tree: dicts, and
    lists where the reference's tree held lists."""
    out: dict = {}
    for key, arr in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _to_tensor(arr, device)
    return _listify(out)


def from_jax_params(flat: dict[str, np.ndarray], cfg: ArchConfig,
                    device="cpu") -> dict:
    """Flat reference parameters of an LLM -> the port's nested dict:
    ``blocks`` stacked over the layers after the leading dense ones (an
    MoE arch's expert stacks (L, E, k, n) as they are; a hybrid's SSM
    leaves, ``blocks/ssm/{conv_w, conv_b, a_log, d_skip}`` and its four
    projections, likewise), ``dense_blocks`` a list of one dict a dense
    layer."""
    out = _nest(flat, device)
    if cfg.norm == "nonparametric_ln":  # parameter-free norms: no leaves
        blocks = out.get("blocks", {})
        for key in ("attn_norm", "mlp_norm"):
            blocks.setdefault(key, {})
        out.setdefault("final_norm", {})
    n = cfg.n_layers - cfg.first_dense_layers
    bad = [k for k, a in flat.items()
           if k.startswith("blocks/") and np.shape(a)[0] != n]
    if bad:
        raise ValueError(f"block leaves without a leading {n}-layer axis: "
                         f"{bad[:3]}")
    return out


def from_jax_cnn_params(flat: dict[str, np.ndarray], device="cpu") -> dict:
    """Flat reference parameters of a CNN (``repro.nn.cnn.init_cnn``) -> the
    port's tree: ``stages``/``blocks`` as lists, conv leaves in the same
    (k*k*cin, cout) layout, the depthwise ``dw/kernel`` as it is."""
    return _nest(flat, device)
