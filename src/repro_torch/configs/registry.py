"""Registry: arch id -> ArchConfig (the archs ported so far)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.rwkv6_1p6b import CONFIG as _rwkv6

ARCH_REGISTRY: dict[str, ArchConfig] = {c.name: c for c in (_olmo, _rwkv6)}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return ARCH_REGISTRY[name[: -len("-reduced")]].reduced()
    return ARCH_REGISTRY[name]

