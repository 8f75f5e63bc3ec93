"""Mamba2-130M SSD, attention-free [arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=1, n_kv_heads=1,
    d_ff=0,
    vocab=50_280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True,
    supports_long=True,             # O(1)-state decode: runs long_500k
)
