"""Jamba v0.1 52B hybrid: Mamba+attention 1:7 interleave, MoE 16e top-2 [arXiv:2403.19887; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14_336,
    vocab=65_536,
    n_experts=16, experts_per_token=2,
    attn_period=8,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    supports_long=True,             # mamba-dominated: runs long_500k
)
