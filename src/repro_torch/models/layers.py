"""Model building blocks: norms, RoPE, GQA and cross attention, MLP, MoE,
Mamba2 SSD.

The PyTorch counterpart of ``repro.models.layers``: plain tensor code,
with parameters as a mapping of name -> tensor under the JAX package's
names (``wq``, ``bq``, ``w_gate``, ``ln1_w``, ``router``, ``A_log``, ...)
and the JAX package's layouts (``wq (d, H * D)``, experts ``(E, d, f)``,
activations ``(B, S, H, D)``), so both packages run on the same weights.
The JAX package has no Pallas kernel here; its einsums become
``torch.einsum`` / ``matmul``.

Types follow the JAX package's: a product of two bf16 operands is bf16
unless the JAX code asks for ``preferred_element_type=float32`` (the
attention scores and the PV product), which here is an f32 product of
the operands widened exactly; a product of bf16 and f32 operands (the
MoE router) is f32 of the bf16 operand widened exactly, as JAX promotes;
norms, softmax and the SSD scan run in f32.  The MoE layer is the JAX
package's mesh-free dispatch (``_moe_gspmd``); its expert-parallel form
(``_moe_ep_shardmap``) waits for model sharding.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig

__all__ = ["rms_norm", "layer_norm", "norm", "rope", "attention", "mlp",
           "moe_layer", "mamba2_layer"]

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


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """f32 layer norm (biased variance, eps 1e-6 as in the JAX package,
    not torch's 1e-5) with the f32 weight and bias, cast back."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


def norm(x: torch.Tensor, p: Params, cfg: ArchConfig, name: str
         ) -> torch.Tensor:
    """The config's norm under parameters ``{name}_w`` (and ``{name}_b``
    for ``ln``)."""
    if cfg.norm == "ln":
        return layer_norm(x, p[f"{name}_w"], p[f"{name}_b"])
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
              positions: Optional[torch.Tensor], causal: bool = True,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_len: Optional[int] = None, pos: Optional[int] = None,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              prefix: str = "", rope_on: bool = True, chunk: int = 512
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention for train, prefill and decode.

    * train:   ``cache=None, cache_len=None`` -> ``(y, None)``;
    * prefill: ``cache_len=S_max`` -> ``(y, cache)``, the cache
      ``{"k", "v"} (B, S_max, KV, D)`` allocated here with the prompt's
      keys and values at ``[0, S)``;
    * decode:  ``cache`` and ``pos`` -> ``(y, cache)``, the step's keys
      and values written into the cache in place at ``[pos, pos + S)``
      (the JAX package returns an updated copy);
    * cross-attention: ``kv_override=(k, v)`` ``(B, S_e, H, D)`` from the
      encoder -> ``(y, None)``: queries ``x @ {prefix}wq`` with no bias
      and no RoPE, non-causal over every key.
    """
    B, S, _ = x.shape
    H, D = cfg.n_heads, cfg.head_dim
    if kv_override is not None:
        q = (x @ p[f"{prefix}wq"]).reshape(B, S, H, D)
        o = _sdpa_chunked(q, *kv_override, causal=False, chunk=chunk)
        return (o.reshape(B, S, H * D) @ p[f"{prefix}wo"]).to(x.dtype), None
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


def _silu(g: torch.Tensor) -> torch.Tensor:
    """silu written out as XLA expands ``jax.nn.silu`` on the CPU: ``g * 1
    / (1 + exp(-g))``.  In bf16 each of those ops rounds, where a fused
    silu or sigmoid rounds once and differs in about a third of the
    elements."""
    return g * (1 / (1 + torch.exp(-g)))


def _gelu(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is the erf form), written out as the JAX package computes it: ``h *
    (0.5 * (1 + tanh(c * (h + 0.044715 * h^3))))`` with the constants in
    ``h``'s type and each op rounding to it, as for `_silu`."""
    c, k = (torch.tensor(v, dtype=h.dtype, device=h.device)
            for v in (math.sqrt(2 / math.pi), 0.044715))
    return h * (0.5 * (1.0 + torch.tanh(c * (h + k * (h * (h * h))))))


def mlp(x: torch.Tensor, p: Params, cfg: ArchConfig, prefix: str = ""
        ) -> torch.Tensor:
    """SwiGLU (rms archs): ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``;
    GELU (ln archs, whisper-style): ``gelu(x @ w_up + b_up) @ w_down +
    b_down``."""
    if cfg.norm == "ln":
        h = _gelu(x @ p[f"{prefix}w_up"] + p[f"{prefix}b_up"])
        return (h @ p[f"{prefix}w_down"] + p[f"{prefix}b_down"]).to(x.dtype)
    g = x @ p[f"{prefix}w_gate"]
    u = x @ p[f"{prefix}w_up"]
    h = _silu(g) * u
    return (h @ p[f"{prefix}w_down"]).to(x.dtype)


def moe_capacity(cfg: ArchConfig, S: int) -> int:
    """Expert slots per batch row: ``min(max(8, ceil(S * k * cf / E)), S
    * k)``, in the JAX package's float arithmetic."""
    E, k = cfg.n_experts, cfg.experts_per_token
    cap = max(8, int(-(-S * k * cfg.capacity_factor // E)))
    return min(cap, S * k)


def moe_layer(x: torch.Tensor, p: Params, cfg: ArchConfig) -> torch.Tensor:
    """Top-k routed MoE with per-batch-row capacity dispatch
    (``_moe_gspmd``).

    The router product is f32 (``x`` widened exactly), top-k takes the
    lower expert first on ties (a stable descending sort, as
    ``jax.lax.top_k``), gates are renormalized over the k.  Each row's
    ``S * k`` assignments are sorted stably by expert; an assignment's
    rank within its expert past ``cap`` is dropped (its slot is the
    discarded row ``E * cap``).  The expert FFN (SwiGLU) runs over all
    ``E * cap`` slots.  Each token's output sums its k gated
    contributions in the model's type in ascending expert id, the order
    the JAX package's scatter-add applies them, one add at a time (no
    atomics, so the card's sums are those of the CPU).
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    cap = moe_capacity(cfg, S)
    probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[..., :k], eidx[..., :k]                # (B, S, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    flat_e = eidx.reshape(B, S * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    rank = (torch.arange(S * k, device=x.device)
            - torch.searchsorted(sorted_e, sorted_e, side="left"))
    token = order // k
    dest = torch.where(rank < cap, sorted_e * cap + rank, E * cap)
    rows = torch.arange(B, device=x.device)[:, None]
    buf = x.new_zeros((B, E * cap + 1, d))
    buf[rows, dest] = x[rows, token]
    buf = buf[:, :E * cap].reshape(B, E, cap, d)

    g = torch.einsum("becd,edf->becf", buf, p["w_gate"])
    u = torch.einsum("becd,edf->becf", buf, p["w_up"])
    out = torch.einsum("becf,efd->becd", _silu(g) * u,
                       p["w_down"]).to(x.dtype)

    # each assignment's slot, in (token, j) order, then each token's k
    # slots in ascending expert id
    slot = torch.empty_like(dest).scatter_(1, order, dest).reshape(B, S, k)
    by_expert = torch.argsort(eidx, dim=-1, stable=True)
    slot = torch.gather(slot, 2, by_expert)
    w = torch.gather(gates, 2, by_expert).to(out.dtype)
    flat = torch.cat([out.reshape(B, E * cap, d),
                      out.new_zeros((B, 1, d))], dim=1)
    vals = flat[rows[:, :, None], slot] * w[..., None]       # (B, S, k, d)
    y = vals[:, :, 0]
    for j in range(1, k):
        y = y + vals[:, :, j]
    return y


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns
    ``x`` itself above 20, within an ulp of this)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssd_chunk_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (Dao & Gu 2024), one scalar decay per head.

    ``xh (B, S, H, P)``, ``dt (B, S, H)``, ``A (H,)`` negative, ``Bm`` /
    ``Cm (B, S, Sdim)`` -> ``(y (B, S, H, P)`` in ``xh``'s type, the
    final f32 state ``(B, H, Sdim, P))``.  A ragged tail is zero-padded
    (``dt = 0`` and ``x = 0`` leave the state untouched); within a chunk
    the decay mask is ``-inf`` before ``exp``.
    """
    Bsz, S0, H, P = xh.shape
    Sdim = Bm.shape[-1]
    pad = -S0 % chunk
    if pad:
        xh, dt, Bm, Cm = (torch.nn.functional.pad(
            t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (xh, dt, Bm, Cm))
    nc = (S0 + pad) // chunk
    la = (dt * A).to(torch.float32)                           # <= 0
    xs = (xh * dt[..., None]).to(torch.float32)

    def chunks(t):
        return t.reshape((Bsz, nc, chunk) + t.shape[2:])

    la_c, xs_c = chunks(la), chunks(xs)
    B_c, C_c = chunks(Bm.to(torch.float32)), chunks(Cm.to(torch.float32))
    tmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=xh.device))[None, :, :, None]
    h = torch.zeros((Bsz, H, Sdim, P), dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        la_i, xs_i, B_i, C_i = la_c[:, c], xs_c[:, c], B_c[:, c], C_c[:, c]
        cum = torch.cumsum(la_i, dim=1)                       # (B, c, H)
        gsb = torch.einsum("bts,bcs->btc", C_i, B_i)
        decay = cum[:, :, None, :] - cum[:, None, :, :]       # (B, t, s, H)
        decay = torch.where(tmask, decay, torch.full_like(decay, -torch.inf))
        w = gsb[..., None] * torch.exp(decay)
        y_intra = torch.einsum("btsh,bshp->bthp", w, xs_i)
        y_inter = torch.einsum("bts,bhsp,bth->bthp", C_i, h, torch.exp(cum))
        tail = torch.exp(cum[:, -1:, :] - cum)
        dh = torch.einsum("bcs,bchp,bch->bhsp", B_i, xs_i, tail)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + dh
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :S0]
    return y.to(xh.dtype), h


def mamba2_layer(x: torch.Tensor, p: Params, cfg: ArchConfig, *,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 mode: str = "train"
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Mamba2 SSD mixer.

    * ``mode='train'``: the chunked scan, no state returned;
    * ``'prefill'``: the chunked scan, and its final state ``{"h": (B, H,
      Sdim, P)}`` f32;
    * ``'decode'``: the per-token recurrence from ``cache["h"]`` (zeros
      without one) -> the new state.
    """
    B, S, _ = x.shape
    di, H, P, Sd = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    f32 = torch.float32
    z = x @ p["wz"]
    xh = (x @ p["wx"]).reshape(B, S, H, P)
    Bm, Cm = x @ p["wB"], x @ p["wC"]
    dt = _softplus((x @ p["wdt"]).to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(f32))
    new_cache = None
    if mode in ("train", "prefill"):
        y, h_fin = _ssd_chunk_scan(xh, dt, A, Bm, Cm, min(cfg.ssm_chunk, S))
        if mode == "prefill":
            new_cache = {"h": h_fin}
    else:
        h = (cache["h"] if cache is not None and "h" in cache
             else torch.zeros((B, H, Sd, P), dtype=f32, device=x.device))
        ys = []
        for t in range(S):
            x_t, dt_t = xh[:, t].to(f32), dt[:, t]
            B_t, C_t = Bm[:, t].to(f32), Cm[:, t].to(f32)
            decay = torch.exp(dt_t * A)                        # (B, H)
            dx = torch.einsum("bn,bhp,bh->bhnp", B_t, x_t, dt_t)
            h = h * decay[..., None, None] + dx
            ys.append(torch.einsum("bn,bhnp->bhp", C_t, h))
        y = torch.stack(ys, dim=1).to(x.dtype)
        new_cache = {"h": h}
    y = y + xh * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, S, di)
    y = rms_norm(y * _silu(z.to(f32)).to(y.dtype), p["norm_w"])
    return (y @ p["out_proj"]).to(x.dtype), new_cache
