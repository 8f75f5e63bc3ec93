"""Launch geometry of the two streaming kernels (pure Python, no card).

``csrc/blocked_matvec.cu`` and ``csrc/gather_dot.cu`` share one design:
a persistent grid of at most ``SMs x CTAs_per_SM`` CTAs over work cut
into *chunks* of ``chunk`` units (rows of W, or gathered tiles t; the
last chunk may be shorter), about one ring stage each.  Chunk c is units
``[c * chunk, min((c + 1) * chunk, work))``; CTA i takes chunks i,
i + grid, i + 2 grid, ..., so every SM streams until the last round of
chunks, and a launch keeps no state in device memory.  In a CTA one
producer thread hands the chunks' stages to eight consumer warps through
an S-stage ring in shared memory, filled with 1-D bulk copies; the
consumers dot what arrives against the query, which the CTA holds in
shared memory.  Everything here decides that geometry on the host, from
shapes and pointers alone, so the CPU tests reach it; the kernels read
the numbers as they are given.

A stage holds whole units of work: ``rows`` rows of W (or, where a row
exceeds a stage, ``slabs`` of its ``tile_d`` slabs), or ``rows`` gathered
cells ``V4[idx[t], cols[b]]``; a chunk holds whole rows or whole tiles,
so a row's or a tile's sum never leaves its CTA.  Its consumers split a
stage into *pairs*, one dot each of a slab (kernel 4) or of one cell row
(kernel 3) with the query, over ``group`` lanes.

The bulk branch needs 16-byte-aligned copies: the table's pointer and
every unit's bytes multiples of 16, and the ring with the query within a
CTA's shared memory.  Other operands take the same kernel's plain-load
branch (``ldg``): the same grid, chunks, stages and order of sums, loads
straight from device memory.
"""

from __future__ import annotations

import dataclasses

__all__ = ["SMEM_MAX", "STAGE_BYTES", "RING_BYTES", "MAX_PAIRS",
           "LANE_VECTORS", "SLOT_INTS", "Stream", "grid_ctas", "group_lanes",
           "matvec_stream", "gather_stream"]

#: ints noted per ring slot beside a stage: its chunk (-1: no more work)
#: and its stage within the chunk
SLOT_INTS = 2

#: dynamic shared memory one CTA may take on the H100 (227 KB)
SMEM_MAX = 232_448
#: bytes a ring stage aims at: 256 consumer lanes x 8 vectors of 16 bytes
STAGE_BYTES = 32_768
#: bytes a CTA's ring aims to keep in flight
RING_BYTES = 65_536
#: dots one stage may hold (two buffers of their partial sums)
MAX_PAIRS = 1024
#: 16-byte vectors a lane of a bulk-branch dot aims at
LANE_VECTORS = 8


@dataclasses.dataclass(frozen=True)
class Stream:
    """One launch's geometry; the byte offsets lay out dynamic shared
    memory as [mbarriers | slot notes | ring | query | partials x 2 |
    carry]."""
    bulk: bool
    chunk: int           # rows of W, or tiles, per chunk of work
    rows: int            # rows of W, or gathered cells, per stage
    slabs: int           # tile_d slabs per stage (kernel 4; 1 for kernel 3)
    stages: int          # ring stages
    stage_bytes: int
    group: int           # lanes that share one dot
    pairs: int           # most dots in one stage
    info_off: int        # per slot: chunk, stage (+ kernel 3's cell blocks)
    ring_off: int
    q_off: int
    part_off: int
    carry_off: int
    smem: int            # dynamic shared memory of the launch

    @property
    def branch(self) -> str:
        return "bulk" if self.bulk else "ldg"

    def chunks(self, work: int) -> int:
        """Chunks of ``work`` units (rows or tiles)."""
        return -(-work // self.chunk)

    def ints(self, fields):
        """The named fields as ints, in the order a C entry takes them."""
        return tuple(int(getattr(self, f)) for f in fields)


def grid_ctas(chunks: int, sms: int, per_sm: int) -> int:
    """The persistent grid: one CTA per chunk of work, at most every
    resident slot of the card."""
    return max(1, min(chunks, sms * per_sm))


def group_lanes(n: int, per_lane: int = 1) -> int:
    """Lanes for a dot of ``n`` loads, about ``per_lane`` a lane: the least
    power of two with ``g * per_lane >= n``, at most a warp."""
    g = 1
    while g < 32 and g * per_lane < n:
        g *= 2
    return g


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def _layout(bulk: bool, chunk: int, rows: int, slabs: int,
            stage_bytes: int, group: int, pairs: int, q_bytes: int,
            carry: int, notes: int):
    """Ring stages and offsets, or None where a bulk ring of even 2
    stages and the query do not fit ``SMEM_MAX``.  The plain-load branch
    keeps a 2-slot ring of notes without data."""
    stages = max(2, -(-RING_BYTES // stage_bytes)) if bulk else 2
    if not bulk:
        stage_bytes = q_bytes = 0
    for stages in range(stages, 1, -1):
        info_off = 16 * stages
        ring_off = _align(info_off + 4 * (SLOT_INTS + notes) * stages, 128)
        q_off = ring_off + stages * stage_bytes
        part_off = q_off + _align(q_bytes, 16)
        carry_off = part_off + _align(2 * 4 * pairs, 16)
        smem = carry_off + _align(4 * carry, 16)
        if smem <= SMEM_MAX:
            return Stream(bulk, chunk, rows, slabs, stages, stage_bytes,
                          group, pairs, info_off, ring_off, q_off, part_off,
                          carry_off, smem)
    return None


def matvec_stream(d: int, tile_d: int, elt: int, w_ptr: int) -> Stream:
    """Geometry of `blocked_matvec` for ``W (n, d)`` of ``elt``-byte
    entries at ``w_ptr`` and ``tile_d`` slabs (``d % tile_d == 0``).

    A stage holds whole rows where a row fits ``STAGE_BYTES``, else
    ``slabs`` slabs of one row; one dot per (row, slab).  A chunk is the
    ``rows`` rows of one stage, or one row."""
    n_slabs = d // tile_d
    row_bytes, slab_bytes = d * elt, tile_d * elt
    if row_bytes <= STAGE_BYTES and n_slabs <= MAX_PAIRS:
        rows = max(1, min(STAGE_BYTES // row_bytes, MAX_PAIRS // n_slabs))
        slabs = n_slabs
    else:
        rows = 1
        slabs = max(1, min(STAGE_BYTES // slab_bytes, MAX_PAIRS, n_slabs))
    geo = None
    if w_ptr % 16 == 0 and slab_bytes % 16 == 0:
        geo = _layout(True, rows, rows, slabs, rows * slabs * slab_bytes,
                      group_lanes(slab_bytes // 16, LANE_VECTORS),
                      rows * slabs, row_bytes, 0, 0)
    return geo or _layout(False, rows, rows, slabs, 0, group_lanes(tile_d),
                          rows * slabs, 0, 0, 0)


def gather_stream(R: int, C: int, elt: int, dt: int, v_ptr: int) -> Stream:
    """Geometry of `gather_block_dot` for ``V4 (.., .., R, C)`` of
    ``elt``-byte entries at ``v_ptr`` and ``qsel (dt, C)``.

    A stage holds ``rows`` whole (R, C) cells; one dot per cell row.  A
    chunk is the whole tiles (dt cells each) one stage holds, or one
    tile."""
    cell_bytes, row_bytes = R * C * elt, C * elt
    rows = max(1, min(STAGE_BYTES // cell_bytes, MAX_PAIRS // R))
    chunk = max(1, rows // max(dt, 1))
    geo = None
    if v_ptr % 16 == 0 and row_bytes % 16 == 0:
        geo = _layout(True, chunk, rows, 1, rows * cell_bytes,
                      group_lanes(row_bytes // 16, LANE_VECTORS), rows * R,
                      dt * row_bytes, R, 2 * rows)
    return geo or _layout(False, chunk, rows, 1, 0, group_lanes(C),
                          rows * R, 0, R, 0)
