"""Whisper-medium enc-dec backbone; conv frontend stubbed [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096,
    vocab=51_865,
    norm="ln", qkv_bias=True,
    encoder_layers=24, encoder_seq=1500,
    tie_embeddings=True,
)
