"""Grok-1 314B MoE [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=32_768,
    vocab=131_072,
    n_experts=8, experts_per_token=2,
)
