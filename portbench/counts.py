"""The yardstick's arithmetic: the H100's published peaks, the bytes the
fused cascade (kernel 1) needs for one launch, and the FLOPs of one
decode step.

Nothing here reads a clock or a device: every number follows from a plan
or a configuration's shapes, so a kernel change leaves it as it is and a
plan change moves it with the plan.
"""

from __future__ import annotations

#: One NVIDIA H100 SXM (data sheet; dense rates, at its 700 W limit).
H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops_per_s": 989e12,
    "f32_flops_per_s": 67e12,
}


def _pulling_rounds(plan):
    """``(n_arms, t_new)`` of each round of the plan's schedule that
    pulls, and the final survivors' coverage to every block as one more
    such round."""
    rounds = [(r.n_arms, r.t_new) for r in plan.schedule.rounds if r.t_new]
    last = plan.schedule.rounds[-1] if plan.schedule.rounds else None
    t_final = last.t_cum if last else 0
    if t_final < plan.n_blocks:
        n_final = last.n_keep if last else plan.n_tiles
        rounds.append((n_final, plan.n_blocks - t_final))
    return rounds


def cascade_cells(plan, lanes: int) -> int:
    """Table cells (one arm tile by one coordinate block) that the plan's
    flat schedule pulls for a batch of ``lanes`` queries, each cell once.

    Round 1 pulls every tile's first ``t_1`` blocks of the permutation,
    which the batch shares: the same cells for every query, read once.
    Every later round, and the final survivors' coverage to every block,
    pulls for each query the ``t_new`` next blocks of its own survivors;
    the batch's union of survivor tiles is at most ``lanes`` times the
    survivor count and at most every tile, and that bound is what is
    counted (the survivors are not returned by the kernel).
    """
    cells = 0
    for i, (n_arms, t_new) in enumerate(_pulling_rounds(plan)):
        per_batch = n_arms if i == 0 else n_arms * lanes
        cells += min(plan.n_tiles, per_batch) * t_new
    return cells


def cascade_bytes(plan, lanes: int, *, table_itemsize: int) -> int:
    """Bytes one cascade launch over ``lanes`` queries needs: each pulled
    table cell once (`cascade_cells`, ``tile * block`` items), the f32
    queries once, and the plan's K (id int32, score f32) pairs out per
    query."""
    cell = plan.tile * plan.block * table_itemsize
    return (cascade_cells(plan, lanes) * cell
            + lanes * plan.n_blocks * plan.block * 4
            + lanes * plan.K * 8)


def cascade_flops(plan, lanes: int) -> int:
    """Multiply-adds (2 FLOPs each) one launch needs: every query's own
    pulls, ``tile * block`` products a pull, its final coverage with
    them."""
    pulls = sum(n_arms * t_new for n_arms, t_new in _pulling_rounds(plan))
    return 2 * lanes * pulls * plan.tile * plan.block


def dense_layer_matmul_params(d: int, n_heads: int, n_kv_heads: int,
                              head_dim: int, d_ff: int) -> int:
    """Weights a dense (attention + SwiGLU) layer multiplies per token."""
    attn = d * (n_heads + 2 * n_kv_heads) * head_dim + n_heads * head_dim * d
    return attn + 3 * d * d_ff


def decode_token_flops(*, d: int, n_heads: int, n_kv_heads: int,
                       head_dim: int, d_ff: int, n_layers: int, vocab: int,
                       context: int) -> int:
    """Model FLOPs of one token's decode step at ``context`` positions
    (the new token's included): 2 per matmul weight in each layer, the
    attention's scores and weighted values over the context (2 * heads *
    head_dim each), and the exact head's 2 * vocab * d."""
    per_layer = (2 * dense_layer_matmul_params(d, n_heads, n_kv_heads,
                                               head_dim, d_ff)
                 + 4 * n_heads * head_dim * context)
    return n_layers * per_layer + 2 * vocab * d


def roofline_pct(bytes_needed: float, flops: float, seconds: float,
                 flops_key: str = "bf16_flops_per_s") -> float:
    """Share (%) of the least time the H100 could take — the larger of
    bytes over bandwidth and FLOPs over the peak rate — in ``seconds``."""
    least = max(bytes_needed / H100_SXM["hbm_bytes_per_s"],
                flops / H100_SXM[flops_key])
    return 100.0 * least / seconds
