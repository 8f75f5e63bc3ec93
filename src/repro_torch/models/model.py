"""The language models of every family: init, forward and logits.

The PyTorch counterpart of ``repro.models.model`` (``init_params``,
``forward``, ``logits_from_hidden``) for the dense, vlm, moe, ssm,
hybrid and encdec families.  `build_model` picks the class of a config's
family; each holds the parameters under the JAX package's names:
``embed``, ``final_w`` (``final_b`` for ``ln`` archs), ``unembed``
(untied archs), and one module per layer (or per hybrid period) where
the JAX package stacks them for a scan, so
``repro_torch.convert.params_from_jax`` carries its weights over slice
by slice:

* `DenseLM` (dense, vlm, moe): ``layers.{i}`` a `DenseBlock` —
  attention and a SwiGLU MLP, or the MoE FFN (``router``, ``w_gate
  w_up w_down (E, ...)``) for moe; vlm replaces the first ``n_patches``
  token embeddings of a prefill with ``patch_embeds``;
* `MambaLM` (ssm): ``layers.{i}`` a `MambaBlock`;
* `HybridLM` (hybrid): ``periods.{i}`` a `HybridPeriod` —
  ``mamba.{j}``, ``attn``, ``moe.{j}``, ``mlp.{j}``, ``norms.{j}`` as the
  JAX package's period stacks;
* `EncDecLM` (encdec): ``enc_layers.{i}`` (`EncoderBlock`), ``enc_pos``
  and ``layers.{i}`` (`DecoderBlock`, with the ``c``-prefixed cross
  attention).

The layer scan is a Python loop.  The train mode (no caches, no
``cache_len``, no ``pos``) is differentiable, and with ``cfg.remat``
each layer (each hybrid period, each encoder layer) runs under
``torch.utils.checkpoint`` when gradients are on, its activations
recomputed in the backward pass as ``jax.checkpoint`` does; prefill and
decode run under ``torch.no_grad()``, so serving builds no autograd
graph.  Parameters are built with ``requires_grad=False``; the trainer
(`repro_torch.models.steps.train_step`) turns gradients on.  Caches are
a list with one dict per layer (per period for hybrid), allocated at
prefill: ``{"k", "v"} (B, cache_len, KV, D)`` written in place by each
decode step; ssm ``{"h": (B, H, Sdim, P)}`` f32; hybrid ``{"h":
(n_mamba, B, H, Sdim, P), "k", "v"}``; encdec adds the cross keys and
values ``{"ck", "cv"} (B, encoder_seq, H, D)``, computed once from the
encoder at prefill.  Weights are drawn one tensor at a time from an
explicit ``torch.Generator`` on the target device, with the JAX
package's shapes, types and scales (f32 normal / sqrt(fan_in) cast to
the model type, embeddings N(0, 0.02), f32 router, f32 norm weights of
one, mamba ``A_log`` 0, ``D`` 1, ``dt_bias`` 0 in f32) but not its
values; on the meta device, shapes only.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.boundedme_torch import resolve_device
from repro_torch.distributed.sharding import (dtensor_context, fan_out,
                                              is_dtensor, rebinder, shard,
                                              shard_map_compat, widen)
from repro_torch.models import layers as L

__all__ = ["DenseBlock", "MambaBlock", "HybridPeriod", "EncoderBlock",
           "DecoderBlock", "LM", "DenseLM", "MambaLM", "HybridLM",
           "EncDecLM", "build_model", "Caches",
           "masked_logits", "logits_from_hidden"]

#: per layer (per period for hybrid) ``{"k", "v", ...}``
Caches = List[Dict[str, torch.Tensor]]
Tensors = Dict[str, torch.Tensor]

#: init_params' embedding scale
EMBED_STD = 0.02

#: rows of the table widened to f32 at a time by `masked_logits`
_LOGIT_ROWS = 1 << 15


class _Draw:
    """Draws a model's weights from one generator on one device, in the
    model's type (no generator on the meta device: shapes only)."""

    def __init__(self, cfg: ArchConfig, seed: int, device):
        self.dev = torch.device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.gen = (None if self.dev.type == "meta"
                    else torch.Generator(device=self.dev).manual_seed(seed))

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.dev,
                           dtype=torch.float32)

    def embedding(self, shape) -> torch.Tensor:
        """N(0, 0.02) in the model's type (scaled in place: one f32
        temporary)."""
        return self._normal(shape).mul_(EMBED_STD).to(self.dtype)

    def dense(self, shape, fan_in: int, dtype=None) -> torch.Tensor:
        """N(0, 1) / sqrt(fan_in) in ``dtype`` (default the model's)."""
        t = self._normal(shape).div_(math.sqrt(max(1, fan_in)))
        return t.to(self.dtype if dtype is None else dtype)

    def full(self, shape, value: float, dtype=torch.float32) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.dev)


def _attn_params(dr: _Draw, cfg: ArchConfig, prefix: str = "",
                 kv_heads: Optional[int] = None) -> Tensors:
    H, D, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    KV = cfg.n_kv_heads if kv_heads is None else kv_heads
    p = {f"{prefix}wq": dr.dense((d, H * D), d),
         f"{prefix}wk": dr.dense((d, KV * D), d),
         f"{prefix}wv": dr.dense((d, KV * D), d),
         f"{prefix}wo": dr.dense((H * D, d), H * D)}
    if cfg.qkv_bias and not prefix:
        for name, width in (("bq", H * D), ("bk", KV * D), ("bv", KV * D)):
            p[name] = dr.full((width,), 0.0, dr.dtype)
    return p


def _mlp_params(dr: _Draw, cfg: ArchConfig) -> Tensors:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.norm == "ln":
        return {"w_up": dr.dense((d, f), d),
                "b_up": dr.full((f,), 0.0, dr.dtype),
                "w_down": dr.dense((f, d), f),
                "b_down": dr.full((d,), 0.0, dr.dtype)}
    return {"w_gate": dr.dense((d, f), d), "w_up": dr.dense((d, f), d),
            "w_down": dr.dense((f, d), f)}


def _moe_params(dr: _Draw, cfg: ArchConfig) -> Tensors:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": dr.dense((d, E), d, torch.float32),
            "w_gate": dr.dense((E, d, f), d),
            "w_up": dr.dense((E, d, f), d),
            "w_down": dr.dense((E, f, d), f)}


def _mamba_params(dr: _Draw, cfg: ArchConfig) -> Tensors:
    d, di, H, Sd = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    return {"wz": dr.dense((d, di), d), "wx": dr.dense((d, di), d),
            "wB": dr.dense((d, Sd), d), "wC": dr.dense((d, Sd), d),
            "wdt": dr.dense((d, H), d),
            "dt_bias": dr.full((H,), 0.0), "A_log": dr.full((H,), 0.0),
            "D": dr.full((H,), 1.0),
            "out_proj": dr.dense((di, d), di),
            "norm_w": dr.full((di,), 1.0)}


def _norm_params(dr: _Draw, cfg: ArchConfig, names=("ln1", "ln2")
                 ) -> Tensors:
    p = {}
    for name in names:
        p[f"{name}_w"] = dr.full((cfg.d_model,), 1.0)
        if cfg.norm == "ln":
            p[f"{name}_b"] = dr.full((cfg.d_model,), 0.0)
    return p


class Params(nn.Module):
    """Tensors held as this module's own parameters, under their names."""

    def __init__(self, *groups: Tensors):
        super().__init__()
        for group in groups:
            for name, t in group.items():
                setattr(self, name, nn.Parameter(t, requires_grad=False))

    @property
    def p(self) -> Tensors:
        """The module's own parameters by name (the layers' mapping)."""
        return dict(self.named_parameters(recurse=False))


class DenseBlock(Params):
    """One pre-norm block: attention, then the MLP (dense, vlm) or the
    MoE FFN (moe family), each residual (``_dense_block``)."""

    def __init__(self, cfg: ArchConfig, dr: _Draw):
        moe = cfg.family == "moe"
        ffn = _moe_params(dr, cfg) if moe else _mlp_params(dr, cfg)
        super().__init__(_attn_params(dr, cfg), ffn, _norm_params(dr, cfg))
        self.moe = moe

    def forward(self, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, cache: Optional[Tensors],
                cache_len: Optional[int], pos: Optional[int]
                ) -> Tuple[torch.Tensor, Optional[Tensors]]:
        p = self.p
        h, new_kv = L.attention(L.norm(x, p, cfg, "ln1"), p, cfg,
                                positions=positions, cache=cache,
                                cache_len=cache_len, pos=pos)
        x = x + h
        h2 = L.norm(x, p, cfg, "ln2")
        x = x + (L.moe_layer(h2, p, cfg) if self.moe else L.mlp(h2, p, cfg))
        return x, new_kv


class MambaBlock(Params):
    """One pre-norm Mamba2 block (the ssm family's layer)."""

    def __init__(self, cfg: ArchConfig, dr: _Draw):
        super().__init__(_mamba_params(dr, cfg),
                         _norm_params(dr, cfg, ("ln1",)))

    def forward(self, x: torch.Tensor, cfg: ArchConfig,
                cache: Optional[Tensors], mode: str
                ) -> Tuple[torch.Tensor, Optional[Tensors]]:
        p = self.p
        h, new_cache = L.mamba2_layer(L.norm(x, p, cfg, "ln1"), p, cfg,
                                      cache=cache, mode=mode)
        return x + h, new_cache


class HybridPeriod(nn.Module):
    """One period of the hybrid family (``_hybrid_forward``): layer ``i``
    mixes with Mamba2 (``mamba.{m}``, m counting the Mamba layers) or,
    at ``i = period - 1``, attention (``attn``); then the MoE FFN
    ``moe.{(i // 2) % n_moe}`` on odd ``i`` and the MLP ``mlp.{(i // 2) %
    n_mlp}`` on even ones; ``norms.{i}`` holds layer i's two norms."""

    def __init__(self, cfg: ArchConfig, dr: _Draw):
        super().__init__()
        period = cfg.attn_period                  # Mamba at i < period - 1
        n_moe = period // 2
        self.mamba = nn.ModuleList(Params(_mamba_params(dr, cfg))
                                   for _ in range(period - 1))
        self.attn = Params(_attn_params(dr, cfg))
        self.moe = nn.ModuleList(Params(_moe_params(dr, cfg))
                                 for _ in range(n_moe))
        self.mlp = nn.ModuleList(Params(_mlp_params(dr, cfg))
                                 for _ in range(period - n_moe))
        self.norms = nn.ModuleList(Params(_norm_params(dr, cfg))
                                   for _ in range(period))

    def forward(self, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, cache: Optional[Tensors],
                cache_len: Optional[int], pos: Optional[int], mode: str
                ) -> Tuple[torch.Tensor, Optional[Tensors]]:
        period = cfg.attn_period
        hs, kv_new = [], None
        for i in range(period):
            nm = self.norms[i].p
            h_in = L.norm(x, nm, cfg, "ln1")
            if i == period - 1:
                kv = (None if cache is None or "k" not in cache
                      else {"k": cache["k"], "v": cache["v"]})
                h, kv_new = L.attention(h_in, self.attn.p, cfg,
                                        positions=positions, cache=kv,
                                        cache_len=cache_len, pos=pos)
            else:
                hc = (None if cache is None or "h" not in cache
                      else {"h": cache["h"][i]})
                h, hc_new = L.mamba2_layer(h_in, self.mamba[i].p, cfg,
                                           cache=hc, mode=mode)
                if hc_new is not None:
                    hs.append(hc_new["h"])
            x = x + h
            h2 = L.norm(x, nm, cfg, "ln2")
            if i % 2 == 1:
                x = x + L.moe_layer(h2, self.moe[(i // 2) % len(self.moe)].p,
                                    cfg)
            else:
                x = x + L.mlp(h2, self.mlp[(i // 2) % len(self.mlp)].p, cfg)
        out = {}
        if hs:
            out["h"] = torch.stack(hs)
        if kv_new is not None:
            out.update(kv_new)
        return x, (out or None)


class EncoderBlock(Params):
    """One encoder block (encdec): non-causal self-attention with RoPE
    and as many K/V heads as heads, then the MLP."""

    def __init__(self, cfg: ArchConfig, dr: _Draw):
        super().__init__(_attn_params(dr, cfg, kv_heads=cfg.n_heads),
                         _mlp_params(dr, cfg), _norm_params(dr, cfg))

    def forward(self, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor) -> torch.Tensor:
        p = self.p
        h, _ = L.attention(L.norm(x, p, cfg, "ln1"), p, cfg,
                           positions=positions, causal=False)
        x = x + h
        return x + L.mlp(L.norm(x, p, cfg, "ln2"), p, cfg)


class DecoderBlock(Params):
    """One decoder block (encdec): causal self-attention, cross-attention
    to the encoder's keys and values (``cw*``, no bias), the MLP."""

    def __init__(self, cfg: ArchConfig, dr: _Draw):
        super().__init__(_attn_params(dr, cfg),
                         _attn_params(dr, cfg, "c", kv_heads=cfg.n_heads),
                         _mlp_params(dr, cfg),
                         _norm_params(dr, cfg, ("ln1", "ln2", "ln3")))

    def cross_kv(self, enc_out: torch.Tensor, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The block's cross keys and values ``(B, S_e, H, D)``; the
        encoder's output gets their gradients' sum whole (`fan_out`)."""
        B, S_e, _ = enc_out.shape
        shape = (B, S_e, cfg.n_heads, cfg.head_dim)
        ek, ev = fan_out(enc_out, 2)
        return ((ek @ self.cwk).reshape(shape),
                (ev @ self.cwv).reshape(shape))

    def forward(self, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, cache: Optional[Tensors],
                cache_len: Optional[int], pos: Optional[int],
                cross: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[Tensors]]:
        p = self.p
        kv = None if cache is None else {"k": cache["k"], "v": cache["v"]}
        h, new_kv = L.attention(L.norm(x, p, cfg, "ln1"), p, cfg,
                                positions=positions, cache=kv,
                                cache_len=cache_len, pos=pos)
        x = x + h
        h, _ = L.attention(L.norm(x, p, cfg, "ln2"), p, cfg,
                           positions=None, kv_override=cross, prefix="c")
        x = x + h
        return x + L.mlp(L.norm(x, p, cfg, "ln3"), p, cfg), new_kv


def _mode(cache_len: Optional[int], pos: Optional[int]) -> str:
    return ("train" if cache_len is None and pos is None
            else "prefill" if cache_len is not None else "decode")


def _run(block: nn.Module, remat: bool, *args):
    """``block(*args)``; with ``remat`` under activation checkpointing
    (the block's activations recomputed in the backward pass, under the
    forward's logical mesh: on the card the recompute runs in the
    autograd engine's thread)."""
    if remat:
        again = rebinder()
        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              again()))
    return block(*args)


class LM(nn.Module):
    """A language model of ``cfg``'s widths and depth: the embedding, the
    final norm and the head table; subclasses add their family's
    layers (`build_model` picks the subclass)."""

    FAMILIES: Tuple[str, ...] = ()

    def __init__(self, cfg: ArchConfig, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"{type(self).__name__} builds the "
                             f"{'/'.join(self.FAMILIES)} families, not "
                             f"{cfg.family!r}: use build_model")
        self.cfg = cfg
        dr = _Draw(cfg, seed, _model_device(device))
        d, Vp = cfg.d_model, cfg.padded_vocab
        self.embed = nn.Parameter(dr.embedding((Vp, d)),
                                  requires_grad=False)
        for name, t in _norm_params(dr, cfg, ("final",)).items():
            setattr(self, name, nn.Parameter(t, requires_grad=False))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(dr.embedding((Vp, d)),
                                        requires_grad=False)
        self._build(cfg, dr)

    def _build(self, cfg: ArchConfig, dr: _Draw) -> None:
        raise NotImplementedError

    def _backbone(self, x, positions, caches, cache_len, pos, enc_frames):
        raise NotImplementedError

    @property
    def head_table(self) -> torch.Tensor:
        """The ``(padded_vocab, d_model)`` table of the logits: the tied
        embedding, or the unembedding."""
        return self.embed if self.cfg.tie_embeddings else self.unembed

    def _remat(self) -> bool:
        """Whether the layers run under activation checkpointing: with
        ``cfg.remat`` when gradients are on (the train mode only)."""
        return self.cfg.remat and torch.is_grad_enabled()

    def forward(self, tokens: torch.Tensor, *,
                caches: Optional[Caches] = None,
                cache_len: Optional[int] = None, pos: Optional[int] = None,
                patch_embeds: Optional[torch.Tensor] = None,
                enc_frames: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Caches]]:
        """Final hidden states ``(B, S, d)`` and the caches.

        * train:   ``caches=None, cache_len=None, pos=None``,
          differentiable;
        * prefill: ``cache_len=S_max`` -> new caches;
        * decode:  ``caches`` and the position ``pos`` of the step's first
          token -> the caches (attention caches written in place).

        Prefill and decode run under ``torch.no_grad()``.

        vlm: ``patch_embeds (B, n, d)`` replace the first ``n`` token
        embeddings at train and prefill (``n <= S``).  encdec:
        ``enc_frames (B, encoder_seq, d)`` feed the encoder at train and
        prefill; decode reads the cross keys and values of the caches.
        """
        train = caches is None and cache_len is None and pos is None
        with contextlib.nullcontext() if train else torch.no_grad(), \
                dtensor_context(self.embed):
            return self._forward(tokens, caches, cache_len, pos,
                                 patch_embeds, enc_frames)

    def _forward(self, tokens, caches, cache_len, pos, patch_embeds,
                 enc_frames):
        cfg = self.cfg
        B, S = tokens.shape
        if is_dtensor(self.embed):
            x = _vocab_lookup(self.embed, tokens)
        else:
            x = self.embed[tokens].to(self.embed.dtype)
        if cfg.family == "vlm" and patch_embeds is not None and pos is None:
            n = patch_embeds.shape[1]
            if n > S:
                raise ValueError(f"{n} patch embeddings do not fit a "
                                 f"sequence of {S} tokens")
            x = torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)
        x = shard(x, "batch", "seq", None)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        if pos is not None:
            positions = positions + int(pos)
        x, new_caches = self._backbone(x, positions, caches, cache_len, pos,
                                       enc_frames)
        fin = dict(self.named_parameters(recurse=False))
        return L.norm(x, fin, cfg, "final"), new_caches


def _vocab_lookup(table, tokens):
    """``table[tokens]`` of a DTensor table whose rows may be split over
    mesh axes (the vocab on 'model'), without gathering it: each rank
    looks up the tokens of its own rows (zeros for the others), a partial
    sum over those axes that the caller's annotation reduces (one
    nonzero part, so exact in any type; in f32 as every 16-bit partial
    sum, `redistribute`).  The table is gathered over any other axis
    (FSDP's 'data')."""
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    mesh = table.device_mesh
    vdims = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    ids = distribute_tensor(
        torch.arange(table.shape[0], device=tokens.device), mesh,
        [Shard(0) if i in vdims else Replicate() for i in range(mesh.ndim)],
        src_data_rank=None)
    tok_pl = [Replicate() if i in vdims else p
              for i, p in enumerate(tokens.placements)]

    def local(tab, tok, vid):
        idx = tok - vid[0]
        own = (idx >= 0) & (idx < tab.shape[0])
        x = tab[torch.clamp(idx, 0, tab.shape[0] - 1)]
        return torch.where(own[..., None], x, torch.zeros_like(x))

    return shard_map_compat(
        local, mesh=mesh,
        in_specs=([Shard(0) if i in vdims else Replicate()
                   for i in range(mesh.ndim)], tok_pl, ids.placements),
        out_specs=[Partial() if i in vdims else p
                   for i, p in enumerate(tok_pl)])(table, tokens, ids)


class DenseLM(LM):
    """The dense, vlm and moe families: a stack of `DenseBlock`."""

    FAMILIES = ("dense", "vlm", "moe")

    def _build(self, cfg, dr):
        self.layers = nn.ModuleList(DenseBlock(cfg, dr)
                                    for _ in range(cfg.n_layers))

    def _backbone(self, x, positions, caches, cache_len, pos, enc_frames):
        new_caches = [] if (cache_len is not None or caches is not None) \
            else None
        remat = self._remat()
        for i, block in enumerate(self.layers):
            x, kv = _run(block, remat, x, self.cfg, positions,
                         None if caches is None else caches[i], cache_len,
                         pos)
            if new_caches is not None:
                new_caches.append(kv)
        return x, new_caches


class MambaLM(LM):
    """The ssm family: a stack of `MambaBlock`; decode without caches
    starts from zero state."""

    FAMILIES = ("ssm",)

    def _build(self, cfg, dr):
        self.layers = nn.ModuleList(MambaBlock(cfg, dr)
                                    for _ in range(cfg.n_layers))

    def _backbone(self, x, positions, caches, cache_len, pos, enc_frames):
        mode = _mode(cache_len, pos)
        new_caches = None if mode == "train" else []
        remat = self._remat()
        for i, block in enumerate(self.layers):
            x, c = _run(block, remat, x, self.cfg,
                        None if caches is None else caches[i], mode)
            if new_caches is not None:
                new_caches.append(c)
        return x, new_caches


class HybridLM(LM):
    """The hybrid family: ``n_layers // attn_period`` `HybridPeriod`s."""

    FAMILIES = ("hybrid",)

    def _build(self, cfg, dr):
        self.periods = nn.ModuleList(
            HybridPeriod(cfg, dr)
            for _ in range(cfg.n_layers // cfg.attn_period))

    def _backbone(self, x, positions, caches, cache_len, pos, enc_frames):
        mode = _mode(cache_len, pos)
        new_caches = []
        remat = self._remat()
        for i, period in enumerate(self.periods):
            x, c = _run(period, remat, x, self.cfg, positions,
                        None if caches is None else caches[i], cache_len,
                        pos, mode)
            new_caches.append(c)
        return x, (None if mode == "train" else new_caches)


class EncDecLM(LM):
    """The encdec family: the encoder over ``enc_frames + enc_pos``, then
    the decoder, whose cross keys and values are computed once per
    prefill and kept in the caches."""

    FAMILIES = ("encdec",)

    def _build(self, cfg, dr):
        self.enc_layers = nn.ModuleList(EncoderBlock(cfg, dr)
                                        for _ in range(cfg.encoder_layers))
        self.enc_pos = nn.Parameter(
            dr.embedding((cfg.encoder_seq, cfg.d_model)),
            requires_grad=False)
        self.layers = nn.ModuleList(DecoderBlock(cfg, dr)
                                    for _ in range(cfg.n_layers))

    def encode(self, enc_frames: torch.Tensor, dtype: torch.dtype
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each decoder layer's cross keys and values of ``enc_frames``."""
        e = shard(L.bias_add(enc_frames.to(dtype), self.enc_pos), "batch",
                  "seq", None)
        B, S_e, _ = e.shape
        epos = torch.arange(S_e, device=e.device)[None].expand(B, S_e)
        remat = self._remat()
        for block in self.enc_layers:
            e = _run(block, remat, e, self.cfg, epos)
        return [block.cross_kv(e, self.cfg) for block in self.layers]

    def _backbone(self, x, positions, caches, cache_len, pos, enc_frames):
        if caches is None or "ck" not in caches[0]:
            if enc_frames is None:
                raise ValueError("the encdec family needs enc_frames at "
                                 "train and prefill")
            cross = self.encode(enc_frames, x.dtype)
        else:
            cross = [(c["ck"], c["cv"]) for c in caches]
        new_caches = []
        remat = self._remat()
        for i, block in enumerate(self.layers):
            x, kv = _run(block, remat, x, self.cfg, positions,
                         None if caches is None else caches[i], cache_len,
                         pos, cross[i])
            if kv is not None:
                new_caches.append({**kv, "ck": cross[i][0],
                                   "cv": cross[i][1]})
        return x, (new_caches or None)


_FAMILY_CLASSES = {family: cls for cls in (DenseLM, MambaLM, HybridLM,
                                           EncDecLM)
                   for family in cls.FAMILIES}


def _model_device(device) -> torch.device:
    """The device a model is built on: ``"meta"`` (shapes only, no device
    touched) or an entry point's device (`resolve_device`: the card
    unless the caller asks for the CPU; raises without CUDA)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def build_model(cfg: ArchConfig, seed: int = 0, device="cuda") -> LM:
    """The model of ``cfg``'s family, its weights drawn from ``seed`` on
    ``device``: the card by default, the CPU when asked, shapes only on
    ``"meta"``."""
    if cfg.family not in _FAMILY_CLASSES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILY_CLASSES[cfg.family](cfg, seed=seed, device=device)


@torch.no_grad()
def masked_logits(cfg: ArchConfig, table: torch.Tensor,
                  hidden: torch.Tensor) -> torch.Tensor:
    """``(..., d) -> (..., padded_vocab)`` f32 logits of a head ``table``
    (`LM.head_table`), rows past ``cfg.vocab`` at -1e30: the exact
    head (``logits_from_hidden``).  The products are f32 of the operands
    widened exactly — the JAX package's bf16 x bf16 product with
    ``preferred_element_type=float32`` — taken over row blocks of the
    table, so no f32 copy of a bf16 table is kept."""
    h = hidden.to(torch.float32)
    if is_dtensor(table):         # each rank holds its rows already
        logits = shard(h @ table.to(torch.float32).T,
                       *("batch", "seq")[:h.dim() - 1], "vocab")
    else:
        logits = torch.cat([h @ table[i:i + _LOGIT_ROWS].to(torch.float32).T
                            for i in range(0, table.shape[0], _LOGIT_ROWS)],
                           dim=-1)
    if cfg.padded_vocab != cfg.vocab:
        mask = torch.arange(cfg.padded_vocab, device=logits.device) \
            < cfg.vocab
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return logits


def logits_from_hidden(model: LM, cfg: ArchConfig, hidden: torch.Tensor
                       ) -> torch.Tensor:
    """``(B, S, d) -> (B, S, padded_vocab)`` f32 logits of the model's head
    table, rows past ``cfg.vocab`` at -1e30: the training head, and
    differentiable.  The product is f32 of the operands widened exactly
    (the JAX package's einsum with ``preferred_element_type=float32``),
    the table's gradient reduced across ranks in f32 before its one
    rounding (`widen`); `masked_logits` is the serving head."""
    table = model.head_table
    logits = shard(hidden.to(torch.float32) @ widen(table).T,
                   "batch", "seq", "vocab")
    if cfg.padded_vocab != cfg.vocab:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits
