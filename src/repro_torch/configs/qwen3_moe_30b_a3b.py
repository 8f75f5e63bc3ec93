"""Qwen3-30B-A3B MoE [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=768,                       # per-expert intermediate size
    vocab=151_936,
    n_experts=128, experts_per_token=8,
    rope_theta=1_000_000.0,
    mips_mode="boundedme",          # 151k-row unembedding: prime MIPS target
)
