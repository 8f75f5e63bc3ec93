"""InternVL2-26B backbone (InternLM2-20B); InternViT frontend stubbed [arXiv:2404.16821; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16_384,
    vocab=92_553,
    n_patches=256,                  # pixel-shuffled ViT tokens per image
)
