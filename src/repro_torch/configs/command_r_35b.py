"""Command-R 35B dense, GQA, no bias [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22_528,
    vocab=256_000,                  # largest vocab: best case for BoundedME
    rope_theta=8_000_000.0,
    mips_mode="boundedme",
)
