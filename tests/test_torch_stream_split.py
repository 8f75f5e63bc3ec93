"""The streaming kernels' host-side geometry, on the CPU.

`repro_torch.kernels.stream` decides, from shapes and pointers alone,
how `blocked_matvec` and `gather_block_dot` split their work over a
persistent grid and lay out their ring in shared memory; the kernels
read those numbers as given.  Checked here:

* the chunks the kernels' CTAs take (chunk c: units
  ``[c * chunk, min((c + 1) * chunk, work))``, as ``chunk_span`` in
  ``csrc/stream.cuh`` cuts them) cover every row or tile exactly once;
* stage bytes are multiples of 16 (bulk copies need it) and the layout
  fits the 227 KB a CTA may take, with its parts 16-byte aligned and
  apart;
* a stage holds whole rows, whole slabs of one row, or whole cells; a
  chunk holds whole rows or tiles, about one stage of them; and a walk
  over each chunk's stages as the kernels walk them meets every
  (row, slab) or (tile, block) once, in the order the sums are taken;
* the bulk / plain-load branch follows the alignment rule;
* each C entry takes the geometry fields its wrapper passes, in order;
* ``ops.blocked_matvec`` still raises ``ValueError`` on the CPU for the
  shapes ``blocked_matvec_pallas`` refuses.
"""

import re

import pytest
import torch

from repro_torch.kernels import (blocked_matvec, gather_dot, library, ops,
                                 stream)

_GEOS = {"matvec": stream.matvec_stream(1024, 512, 4, 0),
         "matvec_long_row": stream.matvec_stream(16384, 512, 4, 0),
         "gather_row": stream.gather_stream(8, 512, 2, 2, 0),
         "gather_coord": stream.gather_stream(8, 128, 2, 8, 0)}


def _spans(work, geo):
    """Each chunk's units, as ``chunk_span`` in ``csrc/stream.cuh`` cuts
    them."""
    return [(c * geo.chunk, min((c + 1) * geo.chunk, work))
            for c in range(geo.chunks(work))]


@pytest.mark.parametrize("work", [0, 1, 7, 13, 64, 300, 1000, 19200, 153600])
@pytest.mark.parametrize("geo", sorted(_GEOS))
def test_chunks_cover_each_unit_once(work, geo):
    spans = _spans(work, _GEOS[geo])
    units = [u for lo, hi in spans for u in range(lo, hi)]
    assert units == list(range(work))
    # every chunk holds units, all but the last exactly ``chunk`` of them
    assert all(0 < hi - lo <= _GEOS[geo].chunk for lo, hi in spans)
    assert all(hi - lo == _GEOS[geo].chunk for lo, hi in spans[:-1])


def _c_params(source, entry):
    """The parameter names of ``extern "C" int <entry>(...)`` in source."""
    text = (library.CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", text,
                  re.S)
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


@pytest.mark.parametrize("module,source,entry,before", [
    (blocked_matvec, "blocked_matvec.cu", "blocked_matvec", "tile_d"),
    (gather_dot, "gather_dot.cu", "gather_block_dot", "dt")])
def test_c_entry_takes_the_geometry_fields(module, source, entry, before):
    """The wrapper passes ``geo.ints(GEOMETRY)`` right after ``before``
    and then the stream: the C entry names exactly those fields there, so
    no field is passed that the kernel does not read."""
    names = _c_params(source, entry)
    at = names.index(before) + 1
    assert tuple(names[at:-1]) == module.GEOMETRY
    assert names[-1] == "stream"
    geo = stream.matvec_stream(1024, 512, 4, 0)
    assert geo.ints(module.GEOMETRY) == tuple(
        int(getattr(geo, f)) for f in module.GEOMETRY)
    cuh = (library.CSRC / "stream.cuh").read_text()
    assert re.search(r"constexpr int kSlotInts = (\d+);",
                     cuh).group(1) == str(stream.SLOT_INTS)


@pytest.mark.parametrize("chunks,sms,per_sm,want", [
    (19200, 132, 3, 396), (8, 132, 3, 8), (20, 132, 2, 20),
    (9600, 132, 3, 396), (1, 132, 1, 1)])
def test_grid_is_chunks_or_every_slot(chunks, sms, per_sm, want):
    assert stream.grid_ctas(chunks, sms, per_sm) == want


@pytest.mark.parametrize("n,per_lane,want", [
    (1, 1, 1), (2, 1, 2), (3, 1, 4), (16, 1, 16), (24, 1, 32), (32, 1, 32),
    (128, 1, 32), (128, 8, 16), (64, 8, 8), (32, 8, 4), (16, 8, 2),
    (8, 8, 1), (25, 8, 4), (1024, 8, 32)])
def test_group_lanes(n, per_lane, want):
    g = stream.group_lanes(n, per_lane)
    assert g == want and g & (g - 1) == 0
    assert g == 32 or g * per_lane >= n


def _check_layout(geo: stream.Stream, q_bytes: int, carry: int,
                  notes: int):
    assert geo.smem <= stream.SMEM_MAX
    assert 32 % geo.group == 0 and geo.stages >= 2 and geo.chunk >= 1
    assert geo.info_off >= 16 * geo.stages            # the mbarriers first
    assert geo.ring_off >= (geo.info_off
                            + 4 * (stream.SLOT_INTS + notes) * geo.stages)
    assert geo.q_off >= geo.ring_off + geo.stages * geo.stage_bytes
    assert geo.part_off >= geo.q_off + q_bytes
    assert geo.carry_off >= geo.part_off + 2 * 4 * geo.pairs
    assert geo.smem >= geo.carry_off + 4 * carry
    assert all(off % 16 == 0 for off in (geo.ring_off, geo.q_off,
                                         geo.part_off, geo.carry_off))
    if geo.bulk:
        assert geo.stage_bytes % 16 == 0 and geo.ring_off % 128 == 0
        # the ring aims at RING_BYTES in flight where it fits
        if geo.stage_bytes * -(-stream.RING_BYTES // geo.stage_bytes) \
                + q_bytes + 2 * stream.MAX_PAIRS * 4 <= stream.SMEM_MAX - 512:
            assert geo.stages * geo.stage_bytes >= stream.RING_BYTES
    else:
        assert geo.stage_bytes == 0


def _matvec_walk(r0, r1, d, tile_d, geo):
    """The (row, slab) order the stages of a chunk of rows [r0, r1) visit,
    and each stage's copy size, as blocked_matvec.cu walks them."""
    n_slabs = d // tile_d
    pieces = -(-n_slabs // geo.slabs)
    seen, copies = [], []
    for sl in range(-(-(r1 - r0) // geo.rows) * pieces):
        pc = sl % pieces
        row = r0 + (sl // pieces) * geo.rows
        rows = min(geo.rows, r1 - row)
        s0 = pc * geo.slabs
        sh = min(geo.slabs, n_slabs - s0)
        assert rows == 1 or sh == n_slabs      # whole rows, or one row
        assert rows * sh <= geo.pairs
        copies.append(rows * sh * tile_d)
        seen += [(row + p // sh, s0 + p % sh) for p in range(rows * sh)]
    return seen, copies


@pytest.mark.parametrize("d,tile_d", [(1024, 512), (640, 128), (96, 96),
                                      (30, 10), (16384, 512), (8192, 512),
                                      (4096, 4096), (65536, 65536),
                                      (4096, 8)])
@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("n_rows", [1, 13, 388])
def test_matvec_stream_geometry(d, tile_d, elt, n_rows):
    geo = stream.matvec_stream(d, tile_d, elt, w_ptr=1 << 20)
    _check_layout(geo, d * elt if geo.bulk else 0, 0, 0)
    n_slabs = d // tile_d
    for r0, r1 in _spans(n_rows, geo):
        seen, copies = _matvec_walk(r0, r1, d, tile_d, geo)
        # per row, its slabs in order, rows in order: each exactly once
        assert seen == [(r, b) for r in range(r0, r1)
                        for b in range(n_slabs)]
        if geo.slabs == n_slabs:
            assert len(copies) == 1            # a chunk is one stage
        if geo.bulk:
            assert all(c * elt % 16 == 0 and c * elt <= geo.stage_bytes
                       for c in copies)


@pytest.mark.parametrize("R,C,dt", [(8, 512, 2), (8, 128, 8), (4, 256, 3),
                                    (16, 100, 5), (16, 512, 2),
                                    (8, 4096, 1), (1, 8, 40), (8, 8192, 2)])
@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("T", [1, 7, 301])
def test_gather_stream_geometry(R, C, dt, elt, T):
    geo = stream.gather_stream(R, C, elt, dt, v_ptr=1 << 20)
    _check_layout(geo, dt * C * elt if geo.bulk else 0, R,
                  2 * geo.rows if geo.bulk else 0)
    assert geo.pairs == geo.rows * R and geo.slabs == 1
    if geo.bulk:
        assert geo.stage_bytes == geo.rows * R * C * elt
    # a chunk is whole tiles, one stage of cells where whole tiles fit one
    assert geo.chunk * dt <= geo.rows or geo.chunk == 1
    seen = []
    for t0, t1 in _spans(T, geo):
        n_items = (t1 - t0) * dt
        for i0 in range(0, n_items, geo.rows):
            cnt = min(geo.rows, n_items - i0)
            seen += [(t0 + i // dt, i % dt) for i in range(i0, i0 + cnt)]
    assert seen == [(t, b) for t in range(T) for b in range(dt)]


@pytest.mark.parametrize("ptr_off", [0, 2, 4, 8, 16])
@pytest.mark.parametrize("d,tile_d", [(1024, 512), (30, 10), (96, 96),
                                      (640, 128), (24, 12)])
@pytest.mark.parametrize("elt", [4, 2])
def test_matvec_branch_follows_alignment(ptr_off, d, tile_d, elt):
    geo = stream.matvec_stream(d, tile_d, elt, w_ptr=4096 + ptr_off)
    aligned = ptr_off % 16 == 0 and tile_d * elt % 16 == 0
    assert geo.branch == ("bulk" if aligned else "ldg")
    assert geo.group == (stream.group_lanes(tile_d * elt // 16,
                                            stream.LANE_VECTORS)
                         if aligned else stream.group_lanes(tile_d))


@pytest.mark.parametrize("ptr_off", [0, 2, 4, 8, 16])
@pytest.mark.parametrize("R,C", [(8, 512), (8, 128), (16, 100), (4, 6)])
@pytest.mark.parametrize("elt", [4, 2])
def test_gather_branch_follows_alignment(ptr_off, R, C, elt):
    geo = stream.gather_stream(R, C, elt, 3, v_ptr=4096 + ptr_off)
    aligned = ptr_off % 16 == 0 and C * elt % 16 == 0
    assert geo.branch == ("bulk" if aligned else "ldg")


def test_bulk_needs_room_for_ring_and_query():
    # one 256 KB slab cannot take two ring stages: plain loads
    assert not stream.matvec_stream(65536, 65536, 4, 0).bulk
    # q of 512 KB does not fit beside the ring
    assert not stream.matvec_stream(131072, 512, 4, 0).bulk
    assert stream.matvec_stream(16384, 512, 4, 0).bulk


def test_qwen_geometry():
    """The full qwen1.5-0.5b widths take the bulk branch with full stages
    of ``STAGE_BYTES`` and a ring of at least ``RING_BYTES`` per CTA, and
    about ``LANE_VECTORS`` vectors a lane."""
    for elt in (4, 2):
        for geo, n16 in ((stream.matvec_stream(1024, 512, elt, 0), 128),
                         (stream.gather_stream(8, 512, elt, 2, 0), 128),
                         (stream.gather_stream(8, 128, elt, 8, 0), 32)):
            assert geo.bulk and geo.stage_bytes == stream.STAGE_BYTES
            assert geo.stages * geo.stage_bytes >= stream.RING_BYTES
            assert geo.group * stream.LANE_VECTORS == n16 * elt // 4
    coord_bf16 = stream.gather_stream(8, 128, 2, 8, 0)
    assert coord_bf16.group == 2             # 16 rows a warp, one step


@pytest.mark.parametrize("n,d,tn,td", [(100, 512, 64, 512),
                                       (512, 600, 256, 512),
                                       (300, 1024, 256, 512),
                                       (256, 1000, 256, 512)])
def test_matvec_refused_shapes_still_raise_on_cpu(n, d, tn, td):
    W, q = torch.zeros(n, d), torch.zeros(d)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="not divisible"):
        ops.blocked_matvec(W, q, tile_n=tn, tile_d=td)
    assert ops.launch_counts() == before


def test_branch_counters_registered():
    counts = ops.launch_counts()
    for name in ("blocked_matvec", "gather_block_dot"):
        for branch in ("bulk", "ldg"):
            assert f"{name}[{branch}]" in counts
