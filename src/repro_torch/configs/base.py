"""Architecture configuration (a copy of ``repro.configs.base``).

One frozen dataclass describes an architecture; the per-arch modules in
this package instantiate it with the exact published numbers.  The
serving loop reads the vocab table's ``d_model``, ``vocab``,
``padded_vocab``, ``tie_embeddings`` and ``dtype``; the models
(`repro_torch.models`) every width, depth and family field and the
``mips_*`` head settings.  ``smoke()`` derives the reduced config used by
CPU tests; `RunShape` and `SHAPES` are the dry run's input shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ArchConfig", "RunShape", "SHAPES", "pad_to"]


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class RunShape:
    """One input-shape cell of the dry run (assigned per arch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Tuple[RunShape, ...] = (
    RunShape("train_4k", 4096, 256, "train"),
    RunShape("prefill_32k", 32768, 32, "prefill"),
    RunShape("decode_32k", 32768, 128, "decode"),
    RunShape("long_500k", 524288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rms"            # rms | ln
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (jamba): one attention layer every `attn_period` layers
    attn_period: int = 0
    # enc-dec (whisper): encoder depth; frontend provides embeddings (stub)
    encoder_layers: int = 0
    encoder_seq: int = 1500      # whisper 30s @ 50Hz after conv stub
    # vlm: prepended patch embeddings from the stubbed vision frontend
    n_patches: int = 0
    # serving
    mips_mode: str = "exact"     # exact | boundedme
    mips_eps: float = 0.3
    mips_delta: float = 0.1
    mips_precision: str = "fp32"  # fp32 | int8 sampling (DESIGN.md §10)
    # numerics / memory
    dtype: str = "bfloat16"
    remat: bool = True
    scan_unroll: int = 1         # 0 = fully unroll layer scans (dry-run FLOPs)
    vocab_pad: int = 2048        # pad vocab to this multiple for sharding
    # which run-shape cells apply (long_500k only for sub-quadratic mixers)
    supports_long: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab, self.vocab_pad)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:  # mamba
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Rough parameter count (embedding + layers), as the JAX package
        counts it (the dry run's FSDP and bf16-moment thresholds)."""
        d, L = self.d_model, self.n_layers
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per = 0
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim \
            + self.n_heads * self.head_dim * d
        if self.family in ("dense", "vlm", "encdec"):
            per = attn + 3 * d * self.d_ff
        elif self.family == "moe":
            per = attn + self.n_experts * 3 * d * self.d_ff \
                + d * self.n_experts
        elif self.family == "ssm":
            di, H, S = self.d_inner, self.ssm_heads, self.ssm_state
            per = d * (2 * di + 2 * S + H) + di * d + di
        elif self.family == "hybrid":
            n_attn = L // self.attn_period
            n_mamba = L - n_attn
            di, S = self.d_inner, self.ssm_state
            mamba = d * (2 * di + 2 * S + self.ssm_heads) + di * d
            moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            dense_ffn = 3 * d * self.d_ff
            # MoE on every other layer, dense MLP on the rest
            per = (attn * n_attn + mamba * n_mamba) / L \
                + (moe + dense_ffn) / 2
        total = emb + int(per) * L
        if self.family == "encdec":
            total += self.encoder_layers * int(attn + 3 * d * self.d_ff)
            total += L * int(attn)  # cross-attention in the decoder
        return int(total)

    def active_params(self) -> int:
        """Active (per-token) params: MoE uses experts_per_token of
        n_experts."""
        if self.n_experts and self.experts_per_token:
            d, L = self.d_model, self.n_layers
            dead = (self.n_experts - self.experts_per_token) * 3 * d \
                * self.d_ff
            if self.family == "hybrid":
                return self.n_params() - int(L // 2 * dead)
            return self.n_params() - L * dead
        return self.n_params()

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=4 if self.attn_period else max(2, min(4, self.n_layers)),
            attn_period=min(self.attn_period, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=32,
            d_ff=256,
            vocab=512,
            vocab_pad=128,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32,
            ssm_chunk=16,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=24,
            n_patches=min(self.n_patches, 16),
            dtype="float32",
            remat=False,
        )
