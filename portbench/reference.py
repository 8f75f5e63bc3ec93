"""The plain reference: exact top-K over an item table (a float32 search
with TF32 off, its candidates rescored in float64) and the dense
decoder's forward pass in float32 with TF32 off, in blocks that fit the
card; and the same computed one precision lower for the controls.

Plain PyTorch only: it imports nothing of the program and reads only the
inputs the benchmark made (the table, the weights, the token ids, the
queries), never what the program derived from them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import torch


@contextlib.contextmanager
def float32_matmuls(tf32: bool = False):
    """Run float32 products in float32 (``tf32=False``) or in TF32 on the
    card; the previous settings come back afterwards."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest,
    ties to even): what the card's TF32 products read."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (float32) through float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


# ---------------------------------------------------------------- top-K

def _products(Q: torch.Tensor, rows: torch.Tensor, tf32: bool
              ) -> torch.Tensor:
    """``Q (n, d) f32 @ rows (r, d).T`` in float32, or in TF32 (on the
    card by its own products, on the CPU by rounding the operands)."""
    R = rows.to(torch.float32)
    if tf32 and Q.device.type != "cuda":
        return round_tf32(Q) @ round_tf32(R).T
    with float32_matmuls(tf32):
        return Q @ R.T


#: candidates beyond K that the float32 search hands to the float64 rescore
EXTRA = 16


def exact_topk(Q: torch.Tensor, V: torch.Tensor, K: int, *,
               block_rows: int = 32768, tf32: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids (n, K) int64, q . v (n, K))`` of the K largest inner products
    of each query ``Q (n, d)`` (float32) with the rows of ``V (rows, d)``,
    descending.  The search runs in float32 (``tf32``: in TF32), rows
    widened a block at a time; its ``K + EXTRA`` best candidates are then
    rescored in float64 (`scores_of`) and the K best kept, so the
    reference's own rounding lies far below any limit.  With ``tf32``
    the scores stay the search's own (the control's answer)."""
    best_s = best_i = None
    for r0 in range(0, V.shape[0], block_rows):
        s = _products(Q, V[r0:r0 + block_rows], tf32)
        k = min(K + EXTRA, s.shape[1])
        vs, vi = torch.topk(s, k, dim=1)
        vi = vi + r0
        if best_s is not None:
            vs = torch.cat([best_s, vs], dim=1)
            vi = torch.cat([best_i, vi], dim=1)
            vs, pos = torch.topk(vs, min(K + EXTRA, vs.shape[1]), dim=1)
            vi = torch.gather(vi, 1, pos)
        best_s, best_i = vs, vi
    if tf32:
        return best_i[:, :K], best_s[:, :K]
    exact = scores_of(Q, V, best_i)
    vs, pos = torch.topk(exact, K, dim=1)
    return torch.gather(best_i, 1, pos), vs


def scores_of(Q: torch.Tensor, V: torch.Tensor, ids: torch.Tensor
              ) -> torch.Tensor:
    """``q . v_id`` (n, k) in float64 for ``ids (n, k)`` rows of ``V``."""
    rows = V[ids.reshape(-1)].to(torch.float64).view(*ids.shape, -1)
    return torch.einsum("nkd,nd->nk", rows, Q.to(torch.float64))


# ------------------------------------------------------- dense decoder

def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """``x @ w`` in float32; with ``fp8`` both operands first go through
    e4m3, ``x`` per row and ``w`` per output column."""
    wf = w.to(torch.float32)
    if fp8:
        x, wf = round_fp8(x, -1), round_fp8(wf, 0)
    return x @ wf


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """Half-split rotation of ``x (B, S, H, D)`` by ``(S, D/2)`` tables."""
    half = x.shape[-1] // 2
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            chunk: int) -> torch.Tensor:
    """Causal GQA softmax attention in float32: ``q (B, S, H, D)``,
    ``k, v (B, S, KV, D)`` -> ``(B, S, H, D)``, a chunk of queries at a
    time."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for s0 in range(0, S, chunk):
        s1 = min(S, s0 + chunk)
        qg = q[:, s0:s1].reshape(B, s1 - s0, KV, G, D)
        sc = torch.einsum("bckgd,bskd->bckgs", qg, k[:, :s1]) / math.sqrt(D)
        qpos = torch.arange(s0, s1, device=q.device)[:, None]
        mask = (kpos[None, :s1] <= qpos)[None, :, None, None, :]
        sc = sc.masked_fill(~mask, float("-inf"))
        w = torch.softmax(sc, dim=-1)
        out[:, s0:s1] = torch.einsum("bckgs,bskd->bckgd", w,
                                     v[:, :s1]).reshape(B, s1 - s0, H, D)
    return out


def dense_hidden(w: Dict[str, torch.Tensor], widths: dict,
                 tokens: torch.Tensor, *, fp8: bool = False,
                 chunk: int = 256) -> torch.Tensor:
    """Final-normed hidden states ``(B, S, d)`` (float32) of a pre-norm
    dense decoder over ``tokens (B, S)`` from position 0: RMSNorm
    (``widths["norm_eps"]``), half-split RoPE at ``widths["rope_theta"]``,
    causal GQA attention and a SwiGLU MLP, each residual."""
    H, KV, D = widths["n_heads"], widths["n_kv_heads"], widths["head_dim"]
    eps = widths["norm_eps"]
    B, S = tokens.shape
    with float32_matmuls(False):
        x = w["embed"][tokens].to(torch.float32)
        half = D // 2
        inv = torch.exp(-math.log(widths["rope_theta"])
                        * torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
        ang = torch.arange(S, dtype=torch.float32,
                           device=x.device)[:, None] * inv
        cos, sin = torch.cos(ang), torch.sin(ang)
        for i in range(widths["n_layers"]):
            p = {n: w[f"layers.{i}.{n}"] for n in
                 ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "ln1_w", "ln2_w")}
            h = _rms(x, p["ln1_w"], eps)
            q = _rope(_mm(h, p["wq"], fp8).view(B, S, H, D), cos, sin)
            k = _rope(_mm(h, p["wk"], fp8).view(B, S, KV, D), cos, sin)
            v = _mm(h, p["wv"], fp8).view(B, S, KV, D)
            o = _attend(q, k, v, chunk).reshape(B, S, H * D)
            x = x + _mm(o, p["wo"], fp8)
            h = _rms(x, p["ln2_w"], eps)
            g = _mm(h, p["w_gate"], fp8)
            x = x + _mm(g * torch.sigmoid(g) * _mm(h, p["w_up"], fp8),
                        p["w_down"], fp8)
        return _rms(x, w["final_w"], eps)


def head_logits(h: torch.Tensor, table: torch.Tensor, vocab: int, *,
                fp8: bool = False, block_rows: int = 32768
                ) -> torch.Tensor:
    """``h (..., d) @ table[:vocab].T`` in float32 (``fp8``: both through
    e4m3, ``h`` per row and the table per row), a block of rows at a
    time."""
    x = round_fp8(h, -1) if fp8 else h
    parts = []
    with float32_matmuls(False):
        for r0 in range(0, vocab, block_rows):
            t = table[r0:min(vocab, r0 + block_rows)].to(torch.float32)
            if fp8:
                t = round_fp8(t, -1)
            parts.append(x @ t.T)
    return torch.cat(parts, dim=-1)
