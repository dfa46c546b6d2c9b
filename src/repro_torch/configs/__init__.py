from repro_torch.configs.base import ArchConfig, EngineConfig
from repro_torch.configs.registry import ARCH_REGISTRY, get_config

__all__ = ["ArchConfig", "EngineConfig", "ARCH_REGISTRY", "get_config"]
