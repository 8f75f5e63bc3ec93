"""Dense model building blocks: RMS norm, RoPE, GQA attention, SwiGLU MLP.

The PyTorch counterpart of the dense parts of ``repro.models.layers``:
plain tensor code, with parameters as a mapping of name -> tensor under
the JAX package's names (``wq``, ``bq``, ``w_gate``, ``ln1_w``, ...) and
the JAX package's layouts (``wq (d, H * D)``, activations ``(B, S, H,
D)``), so both packages run on the same weights.  The JAX package has no
Pallas kernel here; its einsums become ``torch.einsum`` / ``matmul``.

Types follow the JAX package's: a product of two bf16 operands is bf16
unless the JAX code asks for ``preferred_element_type=float32`` (the
attention scores and the PV product), which here is an f32 product of
the operands widened exactly; norms and softmax run in f32.
``layer_norm``, GELU, MoE and Mamba wait for their families (ROADMAP.md
queue 1 item 7).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig

__all__ = ["rms_norm", "norm", "rope", "attention", "mlp"]

Params = Mapping[str, torch.Tensor]

#: the masked-score fill of the JAX package (not -inf: a fully masked row
#: stays finite)
_MASKED = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """f32 RMS norm times the f32 weight, cast back to ``x``'s type."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def norm(x: torch.Tensor, p: Params, cfg: ArchConfig, name: str
         ) -> torch.Tensor:
    """The config's norm under parameter ``{name}_w``; RMS only here."""
    if cfg.norm != "rms":
        raise NotImplementedError(f"norm {cfg.norm!r} waits for its family "
                                  f"(ROADMAP.md queue 1 item 7)")
    return rms_norm(x, p[f"{name}_w"])


@functools.lru_cache(maxsize=16)
def _freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """``exp(-log(theta) * arange(half) / half)`` in f32, as the JAX
    package writes it (not ``theta ** (-2i / d)``, which rounds
    otherwise); computed on the host so every device gets the same, and
    copied to a device once (a copy from the host waits for the card)."""
    ar = torch.arange(half, dtype=torch.float32)
    f = torch.exp(-math.log(theta) * ar / torch.tensor(float(half)))
    return f.to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Half-split rotary embedding.  ``x (..., S, H, D)``, ``positions
    (..., S)`` integer; the rotation runs in f32 and is cast back."""
    half = x.shape[-1] // 2
    ang = positions[..., None].to(torch.float32) * _freqs(half, theta,
                                                          x.device)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _qkv(x: torch.Tensor, p: Params, cfg: ArchConfig, prefix: str = ""
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p[f"{prefix}wq"]
    k = x @ p[f"{prefix}wk"]
    v = x @ p[f"{prefix}wv"]
    if cfg.qkv_bias:
        q, k, v = (q + p[f"{prefix}bq"], k + p[f"{prefix}bk"],
                   v + p[f"{prefix}bv"])
    return (q.reshape(B, S, H, D), k.reshape(B, S, KV, D),
            v.reshape(B, S, KV, D))


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """``(B, c, KV, G, D) x (B, s, KV, D) -> (B, c, KV, G, s)`` in f32."""
    return torch.einsum("bckgd,bskd->bckgs", qg.float(), k.float()) * scale


def _pv(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax weights cast to ``v``'s type, then an f32 PV product."""
    return torch.einsum("bckgs,bskd->bckgd", w.to(v.dtype).float(),
                        v.float())


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, q_offset: int = 0, chunk: int = 512
                  ) -> torch.Tensor:
    """Chunked softmax attention: full rows per q-chunk.

    ``q (B, Sq, H, D)``, ``k``/``v (B, Sk, KV, D)`` with ``H = G * KV``.
    Three branches, as in the JAX package: one chunk (``Sq <= chunk`` or
    a ragged ``Sq``), static causal chunks (causal self-attention with
    no offset: chunk i attends to keys ``[0, (i + 1) * chunk)`` and only
    its diagonal block is masked), and chunks with full rows.  The
    causal mask ``kpos <= qpos + q_offset`` also masks a cache's empty
    tail in decode.
    """
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    Sk = k.shape[1]

    def one_chunk(qc: torch.Tensor, start: int) -> torch.Tensor:
        c = qc.shape[1]
        s = _scores(qc.reshape(B, c, KV, G, D), k, scale)
        if causal:
            qpos = start + torch.arange(c, device=q.device)[:, None]
            kpos = torch.arange(Sk, device=q.device)[None, :]
            mask = (kpos <= qpos + q_offset)[None, :, None, None, :]
            s = torch.where(mask, s, torch.full_like(s, _MASKED))
        w = torch.softmax(s, dim=-1)
        return _pv(w, v).reshape(B, c, H, D).to(q.dtype)

    if Sq <= chunk or Sq % chunk:
        return one_chunk(q, 0)
    n_chunks = Sq // chunk
    if causal and q_offset == 0 and Sq == Sk:
        diag = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                     device=q.device))
        outs = []
        for i in range(n_chunks):
            qg = q[:, i * chunk:(i + 1) * chunk].reshape(B, chunk, KV, G, D)
            ctx = (i + 1) * chunk
            s = _scores(qg, k[:, :ctx], scale)
            s[..., i * chunk:] = torch.where(
                diag[None, :, None, None, :], s[..., i * chunk:],
                torch.full_like(s[..., i * chunk:], _MASKED))
            w = torch.softmax(s, dim=-1)
            outs.append(_pv(w, v[:, :ctx]).reshape(B, chunk, H, D)
                        .to(q.dtype))
        return torch.cat(outs, dim=1)
    qs = q.reshape(B, n_chunks, chunk, H, D)
    return torch.stack([one_chunk(qs[:, i], i * chunk)
                        for i in range(n_chunks)], dim=1
                       ).reshape(B, Sq, H, D)


def attention(x: torch.Tensor, p: Params, cfg: ArchConfig, *,
              positions: torch.Tensor, causal: bool = True,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_len: Optional[int] = None, pos: Optional[int] = None,
              prefix: str = "", rope_on: bool = True, chunk: int = 512
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention for train, prefill and decode.

    * train:   ``cache=None, cache_len=None`` -> ``(y, None)``;
    * prefill: ``cache_len=S_max`` -> ``(y, cache)``, the cache
      ``{"k", "v"} (B, S_max, KV, D)`` allocated here with the prompt's
      keys and values at ``[0, S)``;
    * decode:  ``cache`` and ``pos`` -> ``(y, cache)``, the step's keys
      and values written into the cache in place at ``[pos, pos + S)``
      (the JAX package returns an updated copy).
    """
    B, S, _ = x.shape
    H, D = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(x, p, cfg, prefix)
    if rope_on:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    new_cache = None
    if cache is None and cache_len is None:               # train
        o = _sdpa_chunked(q, k, v, causal=causal, chunk=chunk)
    elif cache_len is not None:                           # prefill
        kf = k.new_zeros((B, cache_len) + k.shape[2:])
        vf = v.new_zeros((B, cache_len) + v.shape[2:])
        kf[:, :S], vf[:, :S] = k, v
        new_cache = {"k": kf, "v": vf}
        o = _sdpa_chunked(q, k, v, causal=causal, chunk=chunk)
    else:                                                 # decode
        pos = int(pos)
        cache["k"][:, pos:pos + S] = k
        cache["v"][:, pos:pos + S] = v
        new_cache = cache
        o = _sdpa_chunked(q, cache["k"], cache["v"], causal=True,
                          q_offset=pos, chunk=chunk)
    y = o.reshape(B, S, H * D) @ p[f"{prefix}wo"]
    return y.to(x.dtype), new_cache


def mlp(x: torch.Tensor, p: Params, cfg: ArchConfig, prefix: str = ""
        ) -> torch.Tensor:
    """SwiGLU: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``, with silu
    written out as XLA expands ``jax.nn.silu`` on the CPU: ``g * 1 / (1 +
    exp(-g))``.  In bf16 each of those ops rounds, where a fused silu or
    sigmoid rounds once and differs in about a third of the elements."""
    if cfg.norm != "rms":
        raise NotImplementedError("the GELU MLP of 'ln' archs waits for its "
                                  "family (ROADMAP.md queue 1 item 7)")
    g = x @ p[f"{prefix}w_gate"]
    u = x @ p[f"{prefix}w_up"]
    h = g * (1 / (1 + torch.exp(-g))) * u
    return (h @ p[f"{prefix}w_down"]).to(x.dtype)
