"""Plain PyTorch versions of the port's CUDA kernels.

`gather_block_dot_ref` and `blocked_matvec_ref` compute what
``csrc/gather_dot.cu`` and ``csrc/blocked_matvec.cu`` compute: f32
products of f32 or bf16 operands, each tile's or row's sum taken over its
blocks or slabs in order.

`chain_sum_ref` computes what ``csrc/chain_sum.cu`` computes: a bf16
tensor summed over its leading dimensions in bf16, in the order of XLA's
CPU reduce (`repro_torch.kernels.chain_sum.passes`), a loop of tensor
adds (PyTorch adds two bf16 tensors in f32 and rounds once, as the
kernel does).

`fused_cascade_batched_ref` computes what the fused cascade kernel
(``csrc/fused_cascade.cu``) computes, with the same operands and outputs,
and shares no code with it; `fused_cascade_ref` is its single-query
form, a batch of one, as the kernel's single-query entry is.  It walks
the flat schedule round by round, vectorised over survivors and queries,
never step by step: within a
round the survivor list is fixed and each tile receives only its own
pulls, so the round's k-th pulls of all slots form one batched gather and
product, taken in k order — each tile still sums its column blocks in
schedule order.  Eliminations are a stable descending sort of the masked
tile-max means cut at ``n_keep`` (highest score first, lowest slot on
ties), which is the order the kernel's extraction writes survivors in.

Pull tiers, as in ``fused_cascade_batched_pallas`` of the JAX package:
fp32 (an fp32 dot; a bfloat16 table is widened to f32, exactly, as the
kernel's bf16 instantiation widens it), int8 and int4 (an exact integer dot — taken in
float64, which holds it exactly — then ``raw * (vscale * qscale)`` as two
rounded float32 ops; int4 first unpacks its half-split nibbles), and pq
(a per-query LUT of query-vs-codeword products, then one lookup per row
and subspace, summed over subspaces in order).  With ``cert`` the
adaptive early exit runs too: per-query ``active``/``t_stop``/
``rounds_used`` lanes, certification of the post-elimination survivors at
every round end, frozen accumulators once certified, and the running M2
accumulator for the 'bernstein' radii when ``track_var``.

The CPU tests use it as the port's implementation on CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.quantize import pq_lut, unpack_int4
from repro_torch.core.schedule import END_BIT, PULL_BIT, SLOT_MASK
from repro_torch.kernels import blocked_matvec, chain_sum, gather_dot
from repro_torch.kernels.fused_cascade import resolve_tier

__all__ = ["fused_cascade_batched_ref", "fused_cascade_ref",
           "gather_block_dot_ref", "blocked_matvec_ref", "chain_sum_ref"]

#: gathered elements per chunk: bounds the round-1 working set
_CHUNK_ELEMS = 1 << 26


def _segments(code: np.ndarray):
    """Split the step codes into rounds: yields (pull steps, ends_round)."""
    ends = np.nonzero(code & END_BIT)[0]
    bounds = list(zip(np.r_[0, ends + 1], np.r_[ends + 1, code.shape[0]]))
    for i, (lo, hi) in enumerate(bounds):
        if lo == hi and i == len(bounds) - 1:
            break
        steps = lo + np.nonzero(code[lo:hi] & PULL_BIT)[0]
        yield steps, i < len(ends)


def _occurrence_rank(slots: np.ndarray) -> np.ndarray:
    """For each step, how many earlier steps of the round pull its slot."""
    order = np.argsort(slots, kind="stable")
    s = slots[order]
    first = np.r_[True, s[1:] != s[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(s.size), 0))
    rank = np.empty_like(order)
    rank[order] = np.arange(s.size) - start
    return rank


class _Pull:
    """One tier's pull arithmetic over gathered (B, m) (tile, column) pairs."""

    def __init__(self, tier, V4, Qb, vscale, qscale, codebook):
        self.tier, self.V4, self.Qb = tier, V4, Qb
        self.vscale, self.qscale = vscale, qscale
        if tier == "pq":
            self.lut = pq_lut(Qb, codebook)     # (B, n_blocks, S, n_codes)
            self.sidx = torch.arange(V4.shape[3], device=V4.device)

    def elems(self, B: int) -> int:
        """Gathered 4-byte words per pulled (query, slot) pair."""
        R, Cs = self.V4.shape[2], self.V4.shape[3]
        # int tiers dot in float64; pq gathers through 64-bit indices
        per = {"fp32": Cs, "int8": 2 * Cs, "int4": 4 * Cs, "pq": 8 * Cs}
        return B * R * per[self.tier]

    def __call__(self, tiles, cc):
        bi = torch.arange(tiles.shape[0], device=tiles.device)[:, None]
        slab = self.V4[tiles, cc]                           # (B, m, R, Cs)
        if self.tier == "fp32":          # a bf16 table widens exactly
            return torch.einsum("bmrc,bmc->bmr", slab.float(),
                                self.Qb[bi, cc])
        if self.tier == "pq":
            b4, c4 = bi[..., None, None], cc[..., None, None]
            picked = self.lut[b4, c4, self.sidx, slab.long()]  # (B,m,R,S)
            part = picked[..., 0]
            for s in range(1, picked.shape[-1]):
                part = part + picked[..., s]
            return part
        if self.tier == "int4":
            slab = unpack_int4(slab)
        raw = torch.einsum("bmrc,bmc->bmr", slab.to(torch.float64),
                           self.Qb[bi, cc].to(torch.float64))
        s = self.vscale[tiles, cc] * self.qscale[bi, cc]    # (B, m)
        return raw.to(torch.float32) * s[..., None]


def _pull_round(acc, acc2, surv, cols, code, steps, pull, active, pulled):
    B = surv.shape[0]
    dev = acc.device
    bi = torch.arange(B, device=dev)[:, None]
    slots = (code[steps] & SLOT_MASK).astype(np.int64)
    rank = _occurrence_rank(slots)
    chunk = max(1, _CHUNK_ELEMS // pull.elems(B))
    for k in range(int(rank.max(initial=-1)) + 1):
        sel = rank == k            # slots are distinct within one rank
        st = torch.as_tensor(steps[sel], device=dev)
        sl = torch.as_tensor(slots[sel], device=dev)
        for lo in range(0, st.numel(), chunk):
            tiles = surv[:, sl[lo:lo + chunk]]                  # (B, m)
            cc = cols[:, st[lo:lo + chunk]].long()              # (B, m)
            part = pull(tiles, cc)                              # (B, m, R)
            sq = part * part if acc2 is not None else None
            for a, p in ((acc, part), (acc2, sq)):
                if a is None:
                    continue
                new = a[bi, tiles] + p
                if active is not None:   # certified queries stay frozen
                    new = torch.where(active[:, None, None], new,
                                      a[bi, tiles])
                a[bi, tiles] = new
            if pulled is not None:
                on = (slice(None) if active is None else active)
                pulled[tiles[on].reshape(-1), cc[on].reshape(-1)] = True


def _masked_means(acc, tiles, denom, R, n_valid):
    """(B, T, R) means of the tiles' rows, -inf past ``n_valid``."""
    B = tiles.shape[0]
    bi = torch.arange(B, device=acc.device)[:, None]
    rows = tiles[..., None] * R + torch.arange(R, device=acc.device)
    means = acc[bi, tiles] / denom
    return torch.where(rows < n_valid, means,
                       torch.full_like(means, -torch.inf))


def _certify(acc, acc2, tiles, denom, C, a_l, b_l, R, n_valid, k_cert):
    """Per query: do the top-``k_cert`` survivor rows by mean have lower
    bounds at or above every other survivor row's upper bound?

    Rows are enumerated slot-major, as the kernel does, and the top rows
    are taken in (mean descending, position ascending) order; with fewer
    than ``k_cert`` rows the predicate fires trivially.
    """
    B = tiles.shape[0]
    bi = torch.arange(B, device=acc.device)[:, None]
    rows = tiles[..., None] * R + torch.arange(R, device=acc.device)
    valid = rows < n_valid
    mu = acc[bi, tiles] / denom                             # (B, T, R)
    if acc2 is not None:
        denom_c = denom * torch.tensor(float(C), dtype=torch.float32,
                                       device=acc.device)
        v = acc2[bi, tiles] / denom_c - mu * mu
        rad = a_l * torch.sqrt(torch.clamp_min(v, 0.0)) + b_l
    else:
        rad = torch.full_like(mu, float(b_l))
    neg = torch.full_like(mu, -torch.inf)
    M = torch.where(valid, mu, neg).reshape(B, -1)
    U = torch.where(valid, mu + rad, neg).reshape(B, -1)
    L = torch.where(valid, mu - rad, neg).reshape(B, -1)
    kc = min(int(k_cert), M.shape[1])
    pos = torch.sort(M, dim=1, descending=True, stable=True)[1][:, :kc]
    minlb = torch.gather(L, 1, pos).amin(1)
    if kc < k_cert:                    # a padding row was taken: -inf
        minlb = torch.full_like(minlb, -torch.inf)
    U = U.scatter(1, pos, -torch.inf)
    return minlb >= U.amax(1)


def fused_cascade_batched_ref(V4: torch.Tensor, Qb: torch.Tensor,
                              slotcode: torch.Tensor,
                              rounds_meta: torch.Tensor, cols: torch.Tensor,
                              *, n_arms: int, K: int, t_final: int,
                              n_final: int, k_out: Optional[int] = None,
                              n_valid: Optional[int] = None,
                              vscale: Optional[torch.Tensor] = None,
                              qscale: Optional[torch.Tensor] = None,
                              codebook: Optional[torch.Tensor] = None,
                              packed_int4: bool = False,
                              cert: Optional[torch.Tensor] = None,
                              k_cert: int = 1, track_var: bool = False,
                              pulled: Optional[torch.Tensor] = None):
    """The fused cascade over a query batch, in plain PyTorch.

    Operands and results as in
    `repro_torch.kernels.fused_cascade.fused_cascade_batched_cuda`; runs
    on the operands' device.  ``pulled``, an optional ``(n_tiles,
    n_blocks)`` bool tensor, is set wherever any query pulls a cell: the
    union of cells the batch reads (``chip_smoke.py`` bounds the kernel's
    time with it).
    """
    tier, C = resolve_tier(V4.shape[3], vscale, qscale, codebook,
                           packed_int4)
    n_tiles, n_blocks, R, _ = V4.shape
    B = cols.shape[0]
    dev = V4.device
    k_out = K if k_out is None else int(k_out)
    n_valid = n_arms if n_valid is None else int(n_valid)
    if not 1 <= k_out <= n_final * R:
        raise ValueError(f"k_out={k_out} outside [1, n_final*R="
                         f"{n_final * R}]")
    if track_var and cert is None:
        raise ValueError("track_var needs cert (adaptive mode)")
    code = slotcode.cpu().numpy().astype(np.int64)
    meta = rounds_meta.cpu().numpy().astype(np.int64)
    adaptive = cert is not None
    if adaptive:
        cert_np = cert.cpu().numpy().astype(np.float32)
        n_rounds = meta.shape[0] - 1
        active = torch.ones(B, dtype=torch.bool, device=dev)
        t_stop = torch.full((B,), int(t_final), dtype=torch.int32,
                            device=dev)
        rounds_used = torch.full((B,), n_rounds, dtype=torch.int32,
                                 device=dev)
    else:
        active = None
    pull = _Pull(tier, V4, Qb if tier != "fp32" else Qb.float(), vscale,
                 qscale, codebook)
    acc = torch.zeros((B, n_tiles, R), dtype=torch.float32, device=dev)
    acc2 = torch.zeros_like(acc) if track_var else None
    surv = torch.arange(n_tiles, device=dev).repeat(B, 1)
    rnd = 0
    for steps, ends_round in _segments(code):
        if steps.size:
            _pull_round(acc, acc2, surv, cols, code, steps, pull, active,
                        pulled)
        if not ends_round:
            continue
        t_cum, T, keep = (int(x) for x in meta[rnd])
        denom = torch.tensor(float(t_cum * C), dtype=torch.float32,
                             device=dev)
        tiles = surv[:, :T]
        score = _masked_means(acc, tiles, denom, R, n_valid).amax(-1)
        order = torch.sort(score, dim=1, descending=True, stable=True)[1]
        surv[:, :keep] = torch.gather(tiles, 1, order[:, :keep])
        if adaptive:
            fire = active & _certify(
                acc, acc2, surv[:, :keep], denom, C,
                torch.tensor(cert_np[rnd, 0], device=dev),
                torch.tensor(cert_np[rnd, 1], device=dev), R, n_valid,
                k_cert)
            rounds_used = torch.where(fire, rnd + 1, rounds_used)
            t_stop = torch.where(fire, t_cum, t_stop)
            active = active & ~fire
        rnd += 1
    if adaptive:   # normalise by each query's actual pull count
        denom = (t_stop.clamp_min(1) * C).to(torch.float32)[:, None, None]
    else:
        denom = torch.tensor(float(max(1, t_final) * C), dtype=torch.float32,
                             device=dev)
    tiles = surv[:, :n_final]
    flat = _masked_means(acc, tiles, denom, R, n_valid).reshape(B, -1)
    vals, pos = torch.sort(flat, dim=1, descending=True, stable=True)
    pos = pos[:, :k_out]
    ids = torch.gather(tiles, 1, pos // R) * R + pos % R
    out = (ids.to(torch.int32), vals[:, :k_out].contiguous())
    return (*out, rounds_used) if adaptive else out


def fused_cascade_ref(V4: torch.Tensor, qb: torch.Tensor,
                      slotcode: torch.Tensor, rounds_meta: torch.Tensor,
                      cols: torch.Tensor, *, n_arms: int, K: int,
                      t_final: int, n_final: int,
                      k_out: Optional[int] = None,
                      n_valid: Optional[int] = None,
                      vscale: Optional[torch.Tensor] = None,
                      qscale: Optional[torch.Tensor] = None,
                      codebook: Optional[torch.Tensor] = None,
                      packed_int4: bool = False,
                      cert: Optional[torch.Tensor] = None,
                      k_cert: int = 1, track_var: bool = False,
                      pulled: Optional[torch.Tensor] = None):
    """The single-query fused cascade, in plain PyTorch: a batch of one.

    ``qb (n_blocks, C)``, ``cols (S,)``, ``qscale (n_blocks,)``; the
    rest as in `fused_cascade_batched_ref`.  Returns ``(ids (k_out,)
    int32, vals (k_out,) float32)`` and with ``cert`` also a scalar
    ``rounds_used`` int32 tensor.
    """
    if qb.dim() != 2 or cols.dim() != 1:
        raise ValueError(f"qb must be (n_blocks, C) and cols (S,), got "
                         f"{tuple(qb.shape)} and {tuple(cols.shape)}")
    out = fused_cascade_batched_ref(
        V4, qb[None], slotcode, rounds_meta, cols[None], n_arms=n_arms, K=K,
        t_final=t_final, n_final=n_final, k_out=k_out, n_valid=n_valid,
        vscale=vscale, qscale=None if qscale is None else qscale[None],
        codebook=codebook, packed_int4=packed_int4, cert=cert,
        k_cert=k_cert, track_var=track_var, pulled=pulled)
    return tuple(t[0] for t in out)


def gather_block_dot_ref(V4: torch.Tensor, idx: torch.Tensor,
                         cols: torch.Tensor, qsel: torch.Tensor
                         ) -> torch.Tensor:
    """``out[t] = sum_b V4[idx[t], cols[b]] @ qsel[b]``, ``(T, R)`` f32.

    ``V4 (n_tiles, n_blocks, R, C)`` and ``qsel (dt, C)`` float32 or
    bfloat16 (widened to f32: bf16 products are exact in f32), integer
    ``idx (T,)`` and ``cols (dt,)``; indices may repeat.  Each block's
    ``(R, C) @ (C,)`` dots are added in block order b = 0 ... dt - 1.

    The card kernel's rule for indices out of range: row t is NaN when
    ``idx[t]`` lies outside ``[0, n_tiles)`` or any ``cols`` entry
    outside ``[0, n_blocks)`` (then every row is).  The JAX package's
    interpret mode clamps such indices instead, and on the TPU its
    result is undefined.
    """
    gather_dot.check_operands(V4, idx, cols, qsel)
    idx, cols = idx.long(), cols.long()
    n_tiles, n_blocks = V4.shape[:2]
    bad_t = (idx < 0) | (idx >= n_tiles)
    bad_b = (cols < 0) | (cols >= n_blocks)
    idx, cols = idx.masked_fill(bad_t, 0), cols.masked_fill(bad_b, 0)
    out = torch.zeros((idx.shape[0], V4.shape[2]), dtype=torch.float32,
                      device=V4.device)
    for b in range(cols.shape[0]):
        out = out + torch.einsum("trc,c->tr", V4[idx, cols[b]].float(),
                                 qsel[b].float())
    return out.masked_fill((bad_t | bad_b.any())[:, None], float("nan"))


def blocked_matvec_ref(W: torch.Tensor, q: torch.Tensor, tile_n: int = 256,
                       tile_d: int = 512) -> torch.Tensor:
    """Exact ``W @ q``, ``(n,)`` f32, for ``W (n, d)`` and ``q (d,)``
    float32 or bfloat16: f32 products, each row's sum taken over the
    ``tile_d``-wide slabs in order.  Raises ``ValueError`` where the
    tiles, clamped to the shape, do not divide it."""
    blocked_matvec.check_operands(W, q)
    n, d = W.shape
    _, tile_d = blocked_matvec.tiles(n, d, tile_n, tile_d)
    out = torch.zeros((n,), dtype=torch.float32, device=W.device)
    for j in range(0, d, tile_d):
        out = out + W[:, j:j + tile_d].float() @ q[j:j + tile_d].float()
    return out


def chain_sum_ref(g: torch.Tensor) -> torch.Tensor:
    """``g (d_0, ..., d_{k-1}, W)`` bf16 summed over its leading
    dimensions in bf16, ``(W,)``: each pass of
    `chain_sum.passes` pads its grid with zeros, cuts it into windows
    and adds each window's elements in row-major order from a zero init,
    one rounding per add, all windows at once."""
    chain_sum.check_operand(g)
    W, k = g.shape[-1], g.dim() - 1
    x = g
    for ps in chain_sum.passes(g.shape[:-1]):
        pad = []
        for d in reversed(range(k)):
            pad += [ps.pad[d], ps.n[d] * ps.w[d] - ps.G[d] - ps.pad[d]]
        x = torch.nn.functional.pad(x, [0, 0] + pad)
        x = x.reshape(*[e for d in range(k) for e in (ps.n[d], ps.w[d])], W)
        x = x.permute(*range(0, 2 * k, 2), *range(1, 2 * k, 2), 2 * k)
        x = x.reshape(math.prod(ps.n), math.prod(ps.w), W)
        acc = torch.zeros((x.shape[0], W), dtype=g.dtype, device=g.device)
        for t in range(x.shape[1]):
            acc = acc + x[:, t]
        x = acc.reshape(*ps.n, W)
    return x.reshape(W)
