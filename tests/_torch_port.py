"""Shared set-up for the port's CPU tests (tests/test_torch_*.py): one JAX
init per arch (olmo-1b-reduced by default, rwkv6-1.6b-reduced), carried
into the port through the bridge, packed in both packages under the same
spec."""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import get_config as jax_get_config
from repro.core.policy import ApproxPolicy as JaxPolicy
from repro.launch.serve import ServeConfig as JaxServeConfig
from repro.launch.serve import build_serving_params as jax_build_serving_params
from repro.models import build_model as jax_build_model
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.policy import ApproxPolicy
from repro_torch.launch.serve import ServeConfig, build_serving_params
from repro_torch.models import build_model

ARCH = "olmo-1b-reduced"
RWKV_ARCH = "rwkv6-1.6b-reduced"


@functools.lru_cache(maxsize=None)
def jax_side(arch: str = ARCH):
    cfg = jax_get_config(arch)
    api = jax_build_model(cfg)
    return cfg, api, api.init(jax.random.PRNGKey(0))


def torch_side(arch: str = ARCH):
    cfg = get_config(arch)
    _, _, jparams = jax_side(arch)
    flat = dict(_flatten(jparams)[0])
    return cfg, build_model(cfg, "cpu"), from_jax_params(flat, cfg)


def packed_pair(policy: tuple | None, arch: str = ARCH):
    """(jax params, port params) for ``policy`` = (mode, m, use_cv, backend)
    wrapped in serve-default, or None for float."""
    jcfg, _, jparams = jax_side(arch)
    tcfg, _, tparams = torch_side(arch)
    if policy is None:
        return jparams, tparams
    mode, m, use_cv, backend = policy
    jp = jax_build_serving_params(jparams, jcfg, JaxServeConfig(
        policy=JaxPolicy(mode, m, use_cv=use_cv, backend=backend)))
    tp = build_serving_params(tparams, tcfg, ServeConfig(
        policy=ApproxPolicy(mode, m, use_cv=use_cv, backend=backend)),
        device="cpu")
    return jp, tp


def to_np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
