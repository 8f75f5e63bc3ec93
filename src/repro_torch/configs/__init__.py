"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the configurations whose tables the port serves are registered.
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen15_05b

__all__ = ["ArchConfig", "REGISTRY", "get_config"]

REGISTRY = {c.name: c for c in (_qwen15_05b,)}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
