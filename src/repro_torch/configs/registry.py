"""Registry: arch id -> ArchConfig (the archs ported so far)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.olmo_1b import CONFIG as _olmo

ARCH_REGISTRY: dict[str, ArchConfig] = {c.name: c for c in (_olmo,)}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return ARCH_REGISTRY[name[: -len("-reduced")]].reduced()
    return ARCH_REGISTRY[name]

