"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the configurations whose models or tables the port serves are
registered: the dense family (qwen1.5-0.5b, tinyllama-1.1b, qwen2.5-3b).
"""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen15_05b
from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen25_3b
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama

__all__ = ["ArchConfig", "REGISTRY", "get_config"]

REGISTRY = {c.name: c for c in (_qwen25_3b, _qwen15_05b, _tinyllama)}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
