"""Quantizers for the sampling cascade: int8, int4, PQ (from
``repro.core.quantize``).

The BoundedME sampling rounds only need inner-product *estimates*, so the
pull arithmetic can run at reduced precision provided the per-pull error
is folded into the confidence radii (`make_schedule(quant_err=...)`).
This module holds the codecs of the port:

  * **int8** — the item matrix is quantized per (R, C) tile of its
    tile-major layout (one f32 scale per (arm-tile, coordinate-block)
    cell) and queries per coordinate block;
  * **int4** — the same per-cell symmetric scheme on a 15-level grid, two
    signed nibbles per byte (`pack_int4`/`unpack_int4`, half-split
    layout), so a pulled tile moves half the int8 bytes; queries stay
    int8 (W4A8);
  * **pq** — per-subspace product quantization: each coordinate block
    splits into ``subdims``-wide slices, a per-(block, subspace) k-means
    codebook (`pq_train`) maps every slice to one of ``n_codes`` uint8
    codes (`pq_encode`), and a pull is a query-side LUT build plus one
    lookup per row and slice (`pq_tile_dot`).

`measured_quant_err` calibrates a per-pull (block-mean scale) error bound
for any tier by replaying the tier's pull arithmetic against calibration
queries.

Every function gives the JAX package's result on the same input: int8
and int4 codes and scales bit for bit (from float32 and from bfloat16
input), on the CPU and on the card
(``torch.round`` and ``jnp.round`` both round half to even, and every
division is a true one), pq codes equal for the same codebook, trained codebooks to float
rounding (the distance products sum in another order).  Integer dots run
in float64, which holds them exactly (|sum| < 2^53) on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["INT8_LEVELS", "INT4_LEVELS", "quantize_tiles", "quantize_blocks",
           "pack_int4", "unpack_int4", "quantize_tiles_int4",
           "dequantize_tiles_int4", "pq_train", "pq_encode", "pq_decode",
           "pq_lut", "pq_tile_dot", "measured_quant_err"]

# symmetric signed quantization grids: levels per sign
INT8_LEVELS = 127
INT4_LEVELS = 7

#: elements of the distance tensor per chunk of `pq_encode` (x4 bytes)
_CHUNK_ELEMS = 1 << 26


def _scale_of(amax: torch.Tensor, levels: int = INT8_LEVELS) -> torch.Tensor:
    """Per-cell scale max|x| / levels; all-zero cells get scale 1 (codes 0).

    The division is taken in ``amax``'s own type when that is bfloat16,
    then widened, as the JAX package divides a bf16 ``amax`` by the
    Python int ``levels``: a bf16 input gets bf16-rounded scales, not the
    f32 quotient.  Any other type divides in float32.  The divisor is a
    tensor on ``amax``'s device: PyTorch divides a CUDA tensor by a
    Python number as a multiply by its reciprocal, which would put the
    card's scales an ulp off the CPU's.
    """
    if amax.dtype != torch.bfloat16:
        amax = amax.to(torch.float32)
    div = torch.full((), levels, dtype=amax.dtype, device=amax.device)
    return torch.where(amax > 0, amax / div,
                       torch.ones_like(amax)).to(torch.float32)


def _quantize_cells(V4: torch.Tensor, levels: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    vscale = _scale_of(V4.abs().amax(dim=(2, 3)), levels)
    Vq = torch.round(V4.to(torch.float32) / vscale[:, :, None, None])
    return Vq.clamp(-levels, levels).to(torch.int8), vscale


def quantize_tiles(V4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile symmetric int8 quantization of a tile-major item matrix.

    ``V4 (n_tiles, n_blocks, R, C)`` float -> ``(V8 (n_tiles, n_blocks,
    R, C) int8, vscale (n_tiles, n_blocks) float32)`` with ``V4 ~= V8 *
    vscale[:, :, None, None]``.
    """
    return _quantize_cells(V4, INT8_LEVELS)


def quantize_blocks(qb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of blocked queries.

    ``qb (n_blocks, C)`` or ``(B, n_blocks, C)`` -> ``(q8 int8, qscale
    float32)``, qscale shaped ``(n_blocks,)`` or ``(B, n_blocks)``.
    Shared by the int8 and int4 table tiers.  bf16 blocks (a model's
    hidden states) get bf16-rounded scales, as in `_scale_of`.
    """
    qscale = _scale_of(qb.abs().amax(dim=-1))
    q8 = torch.round(qb.to(torch.float32) / qscale[..., None])
    return q8.clamp(-INT8_LEVELS, INT8_LEVELS).to(torch.int8), qscale


def pack_int4(x8: torch.Tensor) -> torch.Tensor:
    """Pack int4-valued int8 codes two per byte along the last axis.

    Half-split layout: byte ``k`` holds column ``k`` in its low nibble
    and column ``k + C/2`` in its high nibble.  ``x8 (..., C)`` int8 with
    values in [-8, 7] and C even -> ``(..., C // 2)`` int8.
    """
    x8 = x8.to(torch.int8)
    h = x8.shape[-1] // 2
    lo, hi = x8[..., :h], x8[..., h:]
    return torch.bitwise_or(torch.bitwise_and(lo, 0x0F),
                            torch.bitwise_left_shift(hi, 4))


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Exact inverse of `pack_int4`: ``(..., C // 2)`` -> ``(..., C)`` int8.

    Sign extension is an arithmetic shift: ``(p << 4) >> 4`` for the low
    nibble, ``p >> 4`` for the high one.
    """
    p = packed.to(torch.int8)
    hi = torch.bitwise_right_shift(p, 4)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(p, 4), 4)
    return torch.cat([lo, hi], dim=-1)


def quantize_tiles_int4(V4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile symmetric int4 quantization, nibble-packed two per byte.

    ``V4 (n_tiles, n_blocks, R, C)`` with C even -> ``(P4 (n_tiles,
    n_blocks, R, C // 2) int8, vscale (n_tiles, n_blocks) float32)``.
    """
    Vq, vscale = _quantize_cells(V4, INT4_LEVELS)
    return pack_int4(Vq), vscale


def dequantize_tiles_int4(P4: torch.Tensor, vscale: torch.Tensor
                          ) -> torch.Tensor:
    """Reconstruct the f32 tile-major table from a packed int4 shadow."""
    return unpack_int4(P4).to(torch.float32) * vscale[:, :, None, None]


def pq_train(V4: torch.Tensor, *, n_codes: int = 16, subdims: int = 8,
             iters: int = 8) -> torch.Tensor:
    """Per-(coordinate-block, subspace) k-means codebooks.

    For every (block, slice) pair the rows of the whole table form the
    training set of one ``n_codes``-centroid Lloyd k-means: strided
    data-order initialisation (no RNG), ``iters`` fixed iterations, and
    an empty cluster keeps its centroid, so training is deterministic:
    the same table gives the same codebook.  ``V4 (n_tiles, n_blocks, R,
    C)`` with C a multiple of ``subdims`` -> ``codebook (n_blocks, S,
    n_codes, subdims)`` float32, ``S = C / subdims``.
    """
    T, Bn, R, C = V4.shape
    w = int(subdims)
    if C % w != 0:
        raise ValueError(f"block width {C} not divisible by subdims {w}")
    if not 1 <= int(n_codes) <= 256:
        raise ValueError(f"n_codes must be in [1, 256], got {n_codes}")
    S, n, k = C // w, T * R, int(n_codes)
    # (Bn, S, n, w): every row slice of the table, grouped by subspace
    X = (V4.to(torch.float32).permute(1, 0, 2, 3).reshape(Bn, n, S, w)
         .permute(0, 2, 1, 3).contiguous())
    stride = max(1, n // k)
    idx = (torch.arange(k, device=V4.device) * stride) % n
    cb = X[:, :, idx, :]                                # (Bn, S, k, w)
    x2 = (X * X).sum(-1)                                # (Bn, S, n)
    for _ in range(int(iters)):
        c2 = (cb * cb).sum(-1)                          # (Bn, S, k)
        d = (x2[..., None] - 2.0 * torch.einsum("bsnw,bskw->bsnk", X, cb)
             + c2[:, :, None, :])
        a = d.argmin(-1)                                # (Bn, S, n)
        onehot = torch.nn.functional.one_hot(a, k).to(torch.float32)
        counts = onehot.sum(2)                          # (Bn, S, k)
        sums = torch.einsum("bsnk,bsnw->bskw", onehot, X)
        del d, onehot
        cb = torch.where(counts[..., None] > 0,
                         sums / counts.clamp_min(1.0)[..., None], cb)
    return cb


def pq_encode(V4: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codeword of every (row, block, subspace) slice.

    Per-cell independent: the argmin of the squared distance, ties to
    the lowest code.  ``V4 (n_tiles,
    n_blocks, R, C)``, ``codebook (n_blocks, S, n_codes, w)`` -> ``codes
    (n_tiles, n_blocks, R, S) uint8``.  Works through the tiles in chunks
    to bound the distance tensor.
    """
    T, Bn, R, C = V4.shape
    _, S, k, w = codebook.shape
    codebook = codebook.to(torch.float32)
    c2 = (codebook * codebook).sum(-1)                  # (Bn, S, k)
    out = torch.empty((T, Bn, R, S), dtype=torch.uint8, device=V4.device)
    step = max(1, _CHUNK_ELEMS // (Bn * R * S * k))
    for lo in range(0, T, step):
        X = V4[lo:lo + step].to(torch.float32).reshape(-1, Bn, R, S, w)
        x2 = (X * X).sum(-1)                            # (t, Bn, R, S)
        d = (x2[..., None]
             - 2.0 * torch.einsum("tbrsw,bskw->tbrsk", X, codebook)
             + c2[None, :, None, :, :])
        out[lo:lo + step] = d.argmin(-1).to(torch.uint8)
    return out


def pq_decode(codes: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Reconstruct the f32 tile-major table from codes + codebook."""
    T, Bn, R, S = codes.shape
    w = codebook.shape[-1]
    b = torch.arange(Bn, device=codes.device)[None, :, None, None]
    s = torch.arange(S, device=codes.device)[None, None, None, :]
    picked = codebook[b, s, codes.long()]               # (T, Bn, R, S, w)
    return picked.reshape(T, Bn, R, S * w)


def pq_lut(qb: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Query-vs-codeword products ``lut[..., s, k] = sum_j q[s*w + j] *
    cb[s, k, j]``, summed over j in order (one rounded multiply, then one
    rounded add per term, as the CUDA kernel sums).

    ``qb (..., n_blocks, C)`` f32 and ``codebook (n_blocks, S, n_codes,
    w)`` -> ``(..., n_blocks, S, n_codes)`` f32.
    """
    Bn, S, _, w = codebook.shape
    q = qb.to(torch.float32).reshape(*qb.shape[:-1], S, 1, w)
    lut = q[..., 0] * codebook[..., 0]
    for j in range(1, w):
        lut = lut + q[..., j] * codebook[..., j]
    return lut


def pq_tile_dot(codes: torch.Tensor, qcol: torch.Tensor,
                cb: torch.Tensor) -> torch.Tensor:
    """The pq pull of one coordinate block: ``out[..., r] = sum_s
    lut[s, codes[..., r, s]]`` with the LUT of `pq_lut`, summed over s in
    order: the order of the CUDA kernel's pq pull and of the plain
    version's (the fallback a tensor on the CPU takes).

    ``codes (..., R, S)`` uint8, ``qcol (C,)`` f32, ``cb (S, n_codes,
    w)`` -> ``(..., R)`` f32.
    """
    lut = pq_lut(qcol[None], cb[None])[0]                # (S, n_codes)
    S = lut.shape[0]
    picked = lut[torch.arange(S, device=codes.device), codes.long()]
    out = picked[..., 0]
    for s in range(1, S):
        out = out + picked[..., s]
    return out


def measured_quant_err(V4: torch.Tensor, quantized: Tuple, *,
                       precision: str,
                       queries: Optional[torch.Tensor] = None,
                       n_queries: int = 32,
                       generator: Optional[torch.Generator] = None,
                       seed: int = 0, safety: float = 2.0) -> float:
    """Measured per-pull inner-product error bound for a quantized tier.

    Replays the tier's pull arithmetic — with query-side int8 on the
    int8/int4 tiers — against calibration queries and returns ``safety *
    max |q.v - q.v_hat| / C`` over every (query, tile, block) cell and
    row: a block-mean-scale bias bound for ``make_schedule(quant_err=
    ...)``.

    Args:
      V4: (n_tiles, n_blocks, R, C) f32 tile-major reference table.
      quantized: ``(V8, vscale)`` for 'int8', ``(P4, vscale)`` for 'int4',
        ``(codes, codebook)`` for 'pq'.
      precision: 'int8' | 'int4' | 'pq'.
      queries: optional (n_q, n_blocks, C) calibration query blocks.
        Without them ``n_queries`` standard-normal blocks are drawn on
        the CPU from ``generator`` (default: one seeded with ``seed``).
        The JAX package draws its default from ``jax.random``, so the two
        defaults differ; pass the same ``queries`` to compare them.
      safety: multiplicative inflation of the observed max (default 2.0).

    Returns:
      The inflated bound as a host float (>= 0), on the block-mean scale.
    """
    V4 = V4.to(torch.float32)
    T, Bn, R, C = V4.shape
    dev = V4.device
    if queries is None:
        if generator is None:
            generator = torch.Generator(device="cpu").manual_seed(int(seed))
        queries = torch.randn((int(n_queries), Bn, C), generator=generator,
                              dtype=torch.float32)
    Qb = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    true = torch.einsum("tbrc,qbc->qtbr", V4, Qb)
    if precision in ("int8", "int4"):
        Vq, vscale = quantized
        Vi = unpack_int4(Vq) if precision == "int4" else Vq
        q8, qscale = quantize_blocks(Qb)
        raw = torch.einsum("tbrc,qbc->qtbr", Vi.to(torch.float64),
                           q8.to(torch.float64))           # exact integers
        scl = vscale[None, :, :, None] * qscale[:, None, :, None]
        est = raw.to(torch.float32) * scl
    elif precision == "pq":
        codes, cb = quantized
        _, S, n_codes, w = cb.shape
        lut = torch.einsum("qbsw,bskw->qbsk",
                           Qb.reshape(Qb.shape[0], Bn, S, w), cb)
        codes = codes.long()
        b = torch.arange(Bn, device=dev)[None, :, None, None]
        s = torch.arange(S, device=dev)[None, None, None, :]
        # one query at a time: the broadcast LUT of all queries would hold
        # n_q * T * Bn * R * S * n_codes elements
        est = torch.stack([lut[q, b, s, codes].sum(-1)
                           for q in range(Qb.shape[0])])   # (q, T, Bn, R)
    else:
        raise ValueError(f"no measured error model for precision "
                         f"{precision!r} (expected 'int8', 'int4' or 'pq')")
    err = float((true - est).abs().max()) / float(C)
    return float(safety) * err
