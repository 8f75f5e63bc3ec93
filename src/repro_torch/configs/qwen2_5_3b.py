"""Qwen2.5-3B dense, GQA + QKV bias [hf:Qwen/Qwen2.5-3B; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_head=128,
    d_ff=11_008,
    vocab=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
