"""Architecture registry of the port: ``--arch <id>`` resolves here.

Every configuration of the JAX package is registered, in its order: the
dense family (qwen2.5-3b, qwen1.5-0.5b, command-r-35b, tinyllama-1.1b),
moe (qwen3-moe-30b-a3b, grok-1-314b), ssm (mamba2-130m), encdec
(whisper-medium), vlm (internvl2-26b) and hybrid (jamba-v0.1-52b);
and the dry run's shapes (`SHAPES`, `get_shape`) and its 40 (arch x
shape) `cells`.
"""

from repro_torch.configs.base import SHAPES, ArchConfig, RunShape
from repro_torch.configs.command_r_35b import CONFIG as _command_r
from repro_torch.configs.grok_1_314b import CONFIG as _grok1
from repro_torch.configs.internvl2_26b import CONFIG as _internvl2
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen15_05b
from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen25_3b
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3_moe
from repro_torch.configs.tinyllama_1_1b import CONFIG as _tinyllama
from repro_torch.configs.whisper_medium import CONFIG as _whisper

__all__ = ["ArchConfig", "RunShape", "SHAPES", "REGISTRY", "SHAPE_REGISTRY",
           "get_config", "get_shape", "cells"]

REGISTRY = {c.name: c for c in (
    _qwen3_moe, _grok1, _qwen25_3b, _qwen15_05b, _command_r,
    _tinyllama, _mamba2, _whisper, _internvl2, _jamba,
)}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


SHAPE_REGISTRY = {s.name: s for s in SHAPES}


def get_shape(name: str) -> RunShape:
    if name not in SHAPE_REGISTRY:
        raise KeyError(f"unknown shape {name!r}; have "
                       f"{sorted(SHAPE_REGISTRY)}")
    return SHAPE_REGISTRY[name]


def cells():
    """All 40 (arch x shape) dry-run cells, with skip reasons where N/A."""
    out = []
    for cfg in REGISTRY.values():
        for shp in SHAPES:
            skip = None
            if shp.name == "long_500k" and not cfg.supports_long:
                skip = ("full quadratic attention at 512k context "
                        "(DESIGN.md §5)")
            out.append((cfg, shp, skip))
    return out
