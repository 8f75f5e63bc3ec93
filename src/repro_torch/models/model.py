"""The dense language model: init, forward and logits.

The PyTorch counterpart of ``repro.models.model`` for the dense family
(``init_params``, ``_dense_block``, ``forward``, ``logits_from_hidden``).
`DenseLM` holds the parameters under the JAX package's names: ``embed``,
``final_w``, ``unembed`` (untied archs) and per layer ``wq wk wv wo``
(``bq bk bv`` with QKV bias), ``w_gate w_up w_down`` and ``ln1_w ln2_w``
— one `DenseBlock` per layer where the JAX package stacks them for a
scan, so ``repro_torch.convert.params_from_jax`` carries its weights over
slice by slice.  The layer scan is a Python loop; remat does not apply.

The KV cache is a list with one ``{"k", "v"} (B, cache_len, KV, D)``
dict per layer, allocated at prefill and written in place by each decode
step.  Weights are drawn from an explicit ``torch.Generator`` on the
target device, with the JAX package's shapes and scales (f32 normal /
sqrt(fan_in) cast to the model type, the embedding N(0, 0.02), f32 norm
weights of one) but not its values; on the meta device, shapes only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

__all__ = ["DenseBlock", "DenseLM", "Caches", "masked_logits"]

#: per layer ``{"k", "v"}``
Caches = List[Dict[str, torch.Tensor]]

#: init_params' embedding scale
EMBED_STD = 0.02

#: rows of the table widened to f32 at a time by `masked_logits`
_LOGIT_ROWS = 1 << 15


def _normal(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """f32 N(0, 1) from ``gen``; shapes only on the meta device (no
    generator)."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def _dense(gen, shape, fan_in: int, dtype: torch.dtype, device
           ) -> torch.Tensor:
    return (_normal(gen, shape, device) / math.sqrt(max(1, fan_in))).to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DenseBlock(nn.Module):
    """One pre-norm block: attention and SwiGLU MLP, each residual."""

    def __init__(self, cfg: ArchConfig, gen: Optional[torch.Generator],
                 dtype: torch.dtype, device):
        super().__init__()
        d, H, KV, D, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff)
        shapes = {"wq": ((d, H * D), d), "wk": ((d, KV * D), d),
                  "wv": ((d, KV * D), d), "wo": ((H * D, d), H * D),
                  "w_gate": ((d, f), d), "w_up": ((d, f), d),
                  "w_down": ((f, d), f)}
        for name, (shape, fan_in) in shapes.items():
            setattr(self, name, _param(_dense(gen, shape, fan_in, dtype,
                                              device)))
        if cfg.qkv_bias:
            for name, width in (("bq", H * D), ("bk", KV * D),
                                ("bv", KV * D)):
                setattr(self, name, _param(torch.zeros(width, dtype=dtype,
                                                       device=device)))
        for name in ("ln1_w", "ln2_w"):
            setattr(self, name, _param(torch.ones(d, dtype=torch.float32,
                                                  device=device)))

    def forward(self, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]],
                cache_len: Optional[int], pos: Optional[int]
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        p = dict(self.named_parameters())
        h, new_kv = L.attention(L.norm(x, p, cfg, "ln1"), p, cfg,
                                positions=positions, cache=cache,
                                cache_len=cache_len, pos=pos)
        x = x + h
        x = x + L.mlp(L.norm(x, p, cfg, "ln2"), p, cfg)
        return x, new_kv


class DenseLM(nn.Module):
    """A dense-family language model of ``cfg``'s widths and depth."""

    def __init__(self, cfg: ArchConfig, seed: int = 0, device="cpu"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} waits for its port (ROADMAP.md "
                f"queue 1 item 7); the port runs the dense family")
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        dev = torch.device(device)
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        d, Vp = cfg.d_model, cfg.padded_vocab
        self.embed = _param((_normal(gen, (Vp, d), dev) * EMBED_STD)
                            .to(dtype))
        self.final_w = _param(torch.ones(d, dtype=torch.float32, device=dev))
        if not cfg.tie_embeddings:
            self.unembed = _param((_normal(gen, (Vp, d), dev) * EMBED_STD)
                                  .to(dtype))
        self.layers = nn.ModuleList(DenseBlock(cfg, gen, dtype, dev)
                                    for _ in range(cfg.n_layers))

    @property
    def head_table(self) -> torch.Tensor:
        """The ``(padded_vocab, d_model)`` table of the logits: the tied
        embedding, or the unembedding."""
        return self.embed if self.cfg.tie_embeddings else self.unembed

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *,
                caches: Optional[Caches] = None,
                cache_len: Optional[int] = None, pos: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Caches]]:
        """Final hidden states ``(B, S, d)`` and the caches.

        * train:   ``caches=None, cache_len=None, pos=None``;
        * prefill: ``cache_len=S_max`` -> new caches;
        * decode:  ``caches`` and the position ``pos`` of the step's first
          token -> the same caches, written in place.
        """
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed[tokens].to(self.embed.dtype)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        if pos is not None:
            positions = positions + int(pos)
        new_caches = [] if (cache_len is not None or caches is not None) \
            else None
        for i, block in enumerate(self.layers):
            x, kv = block(x, cfg, positions,
                          None if caches is None else caches[i],
                          cache_len, pos)
            if new_caches is not None:
                new_caches.append(kv)
        return L.rms_norm(x, self.final_w), new_caches


@torch.no_grad()
def masked_logits(cfg: ArchConfig, table: torch.Tensor,
                  hidden: torch.Tensor) -> torch.Tensor:
    """``(..., d) -> (..., padded_vocab)`` f32 logits of a head ``table``
    (`DenseLM.head_table`), rows past ``cfg.vocab`` at -1e30: the exact
    head (``logits_from_hidden``).  The products are f32 of the operands
    widened exactly — the JAX package's bf16 x bf16 product with
    ``preferred_element_type=float32`` — taken over row blocks of the
    table, so no f32 copy of a bf16 table is kept."""
    h = hidden.to(torch.float32)
    logits = torch.cat([h @ table[i:i + _LOGIT_ROWS].to(torch.float32).T
                        for i in range(0, table.shape[0], _LOGIT_ROWS)],
                       dim=-1)
    if cfg.padded_vocab != cfg.vocab:
        mask = torch.arange(cfg.padded_vocab, device=logits.device) \
            < cfg.vocab
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return logits
