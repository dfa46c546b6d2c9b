"""Registry: arch id -> ArchConfig (the archs ported so far)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.deepseek_67b import CONFIG as _ds67
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _dsv2
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moon
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.rwkv6_1p6b import CONFIG as _rwkv6

ARCH_REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in (_qwen3, _ds67, _olmo, _granite, _qwen2vl, _hubert,
                        _rwkv6, _dsv2, _moon)}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return ARCH_REGISTRY[name[: -len("-reduced")]].reduced()
    return ARCH_REGISTRY[name]


def list_archs() -> list[str]:
    """Every registered arch id, each also servable with ``-reduced``."""
    return sorted(ARCH_REGISTRY)
