"""Single-device dynamic table store (DESIGN.md §11).

The PyTorch counterpart of ``repro.store.dynamic_table`` (the port imports
nothing of the JAX package).  :class:`DynamicTableStore` serves a live,
mutating item table: row churn lands in O(rows touched) device work, and
the executors serving it read its buffers in place, so an upsert, delete
or append stream rebuilds nothing.

The contract (DESIGN.md §11), as in the JAX package:

  * **Capacity slack.**  The table is preallocated at ``capacity_rows`` =
    the requested capacity rounded *up* to a multiple of the arm-tile
    size.  The executor's plan is a function of ``capacity_rows``, never
    of the live count, so growth within capacity changes no plan.
  * **Dense-prefix liveness.**  Live rows occupy slots ``[0, n_live)``,
    so the cascade's prefix bound ``n_valid = n_live`` masks exactly the
    dead rows.  ``delete`` swap-fills the hole with the last live row and
    zeroes the vacated tail slot (a zero row would win an all-negative
    ranking, so a hole could not be left); external ids stay stable
    through the moves via the slot <-> id maps.
  * **Monotonic version** and **monotonic** ``value_abs_max``: every
    applied mutation bumps ``version`` (consumers key their caches on
    it), and ``value_abs_max`` only grows, so a schedule calibrated on it
    stays a valid bound until growth is observed.
  * **Dirty-tile shadow maintenance** (``precision='int8'``/``'int4'``/
    ``'pq'``): a mutation marks its arm-tile dirty and `flush_updates`
    re-encodes just those tiles against the tier's cells — pq against a
    *frozen* table-level codebook — so incremental maintenance is
    bytewise a fresh build of the updated table.  `refresh_codebook` is
    the one recalibrating pq mutation (retrain + full re-encode, like
    `grow`).

What differs from the JAX package is the device layout.  The store keeps
ONE device copy, in the kernel's tile-major layout ``(n_tiles, n_blocks,
R, C)`` f32 (`tiled_table`, what `repro_torch.core.boundedme_torch.
decode_tiled` reads), and writes each touched row into it in place at
``V4[slot // R, :, slot % R, :]``; the shadow's dirty tiles are
re-encoded from that buffer on the device and spliced in place.  A
mutation stream therefore never reallocates a buffer (``data_ptr()`` is
stable until `grow`).  `device_table` builds the row-major view on
demand, for tests and cold paths.  The host mirror and the slot/id maps
are numpy, as in the JAX package.

Mutations are *staged* host-side (`upsert` / `delete` / `append`) and
applied in submission order by `flush_updates` — the engines drain them
between dispatches, so in-flight queries never see a torn table.

**Paging** (DESIGN.md §16).  `page_out` frees every device buffer and
keeps the host side; `page_in` lays the host mirror out again and
re-encodes the shadow, bytewise the buffers it freed.  On a card the host
mirror is page-locked, so a page-in is one DMA of the table at the bus
rate plus the shadow's re-encode on the card, with no host copy of the
rows.  `page_state` / `from_page` remain the portable image (the JAX
package's keys and types).

Failure modes: rows must be (N,) float and finite (NaN/inf propagate into
every later score they touch); exceeding capacity raises at flush time
(`grow` reallocates); deleting an unknown id raises.  The store is not
thread-safe; drive it from the engine's loop.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.boundedme_torch import resolve_device
from repro_torch.core.quantize import (pq_encode, pq_train, quantize_tiles,
                                       quantize_tiles_int4)
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["DynamicTableStore", "StoreFlushError"]

#: arm-tiles per pq encode call.  Every encode — of the whole table or of
#: a flush's dirty tiles — runs on a buffer of exactly this many tiles,
#: so the distance products of a cell are computed by the same kernels at
#: the same shape whichever path encodes it, and the codes agree bytewise
_PQ_CHUNK_TILES = 64
#: arm-tiles per step when the whole table is uploaded or quantized, which
#: bounds the transient device memory of a build to one step's rows
_BUILD_CHUNK_TILES = 4096


class StoreFlushError(RuntimeError):
    """A store's `flush_updates` was failed before applying anything.

    Raised by the store's ``fault_hook`` (installed e.g. by
    `repro_torch.launch.faults.FaultInjector.attach`) at the *top* of
    `flush_updates`, before any staged mutation is taken: the staged
    queue is left intact, so the caller can keep serving the current
    table and retry the flush at its next poll (DESIGN.md §13 failure
    model).
    """


def _host_rows(device: torch.device, rows: int, N: int) -> np.ndarray:
    """A zeroed ``(rows, N)`` float32 host buffer, page-locked when the
    store lives on a card (uploads then run as DMA at the bus rate)."""
    if device.type == "cuda":
        return torch.zeros((rows, N), dtype=torch.float32,
                           pin_memory=True).numpy()
    return np.zeros((rows, N), np.float32)


def _pq_encode_tiles(V4: torch.Tensor, tiles: torch.Tensor,
                     codebook: torch.Tensor, out: torch.Tensor) -> None:
    """``out[tiles] = pq_encode(V4[tiles], codebook)``, in place, through
    a zero-padded buffer of `_PQ_CHUNK_TILES` tiles per call."""
    buf = torch.zeros((_PQ_CHUNK_TILES, *V4.shape[1:]), dtype=torch.float32,
                      device=V4.device)
    for lo in range(0, tiles.numel(), _PQ_CHUNK_TILES):
        idx = tiles[lo:lo + _PQ_CHUNK_TILES]
        k = idx.numel()
        buf[:k] = V4[idx]
        buf[k:] = 0.0
        out[idx] = pq_encode(buf, codebook)[:k]


class DynamicTableStore:
    """Versioned, capacity-slack mutable item table for the serving stack.

    Wraps an (n, N) item matrix in a preallocated ``capacity_rows``-row
    table (capacity rounded up to a ``tile`` multiple), held on
    ``device`` tile-major, whose live rows are a dense prefix ``[0,
    n_live)`` — the cascade's ``n_valid`` is always exactly ``n_live``.
    Deletes swap-fill from the tail (stable external ids via slot <-> id
    maps); every applied mutation bumps the monotonic ``version``.  On
    the quantized tiers the store also maintains the tile-major shadow
    the fused kernel consumes, with dirty-tile incremental maintenance:
    per-(tile, block) (codes, scale) cells for 'int8', nibble-packed
    cells for 'int4', and per-cell code assignments against a frozen
    table-level codebook for 'pq' — each bytewise a fresh build.

    Args:
      table: optional (n0, N) initial rows (any float dtype; an array, or
        a tensor on any device); row i gets external id ``ids[i]``
        (default ``i``).
      dim: N when ``table`` is None (an empty store).
      capacity: minimum row capacity; default ``ceil(n0 * capacity_slack)``.
        Rounded up to a ``tile`` multiple either way.
      capacity_slack: headroom factor used when ``capacity`` is omitted.
      tile / block: cascade geometry this store serves (the executor
        adopts the store's values).
      precision: 'fp32', 'int8', 'int4' or 'pq' — which quantized shadow
        (if any) to maintain.  'int4' needs an even ``block``; 'pq' needs
        ``block`` divisible by ``pq_subdims``.
      pq_subdims / pq_codes: pq codebook geometry (precision='pq' only).
      codebook: optional pre-trained pq codebook ((n_blocks, block /
        pq_subdims, pq_codes, pq_subdims) f32) to adopt instead of
        training on the initial rows — how a fresh store reproduces an
        existing store's shadow bytewise (see `snapshot`); ignored
        unless precision='pq'.
      ids: optional explicit external ids for the initial rows.
      device: where the table and its shadow live; the default
        ``"cuda"`` raises without a card, ``"cpu"`` keeps them on the CPU.

    Mutations stage host-side and apply on `flush_updates` in submission
    order.  ``value_abs_max`` tracks max|v| over every row ever applied
    (monotonic; deletes do not shrink it).
    """

    def __init__(self, table=None, *, dim: Optional[int] = None,
                 capacity: Optional[int] = None, capacity_slack: float = 1.5,
                 tile: int = 8, block: int = 512, precision: str = "fp32",
                 pq_subdims: int = 8, pq_codes: int = 16, codebook=None,
                 ids=None, device="cuda"):
        if precision not in ("fp32", "int8", "int4", "pq"):
            raise ValueError(f"unknown precision {precision!r} "
                             f"(expected 'fp32', 'int8', 'int4' or 'pq')")
        if table is None:
            if dim is None:
                raise ValueError("need `table` or `dim`")
            init = np.zeros((0, int(dim)), np.float32)
        elif isinstance(table, torch.Tensor):
            init = table.detach()
        else:
            init = np.asarray(table, np.float32)
        if init.ndim != 2:
            raise ValueError(f"table must be 2D, got {tuple(init.shape)}")
        n0, N = init.shape
        if capacity is None:
            capacity = max(n0, int(np.ceil(n0 * float(capacity_slack))))
        capacity = max(int(capacity), n0, 1)
        self.device = resolve_device(device)
        self.tile = int(tile)
        self.block = min(int(block), N)
        self.N = N
        self.capacity_rows = -(-capacity // self.tile) * self.tile
        self.n_tiles = self.capacity_rows // self.tile
        self.n_blocks = -(-N // self.block)
        self._col_pad = self.n_blocks * self.block - N
        self.precision = precision
        self.pq_subdims = int(pq_subdims)
        self.pq_codes = int(pq_codes)
        if precision == "int4" and self.block % 2 != 0:
            raise ValueError(f"precision='int4' needs an even block, "
                             f"got block={self.block}")
        if precision == "pq":
            if self.block % self.pq_subdims != 0:
                raise ValueError(
                    f"precision='pq' needs block divisible by pq_subdims, "
                    f"got block={self.block}, pq_subdims={self.pq_subdims}")
            if not 1 <= self.pq_codes <= 256:
                raise ValueError(f"pq_codes must be in [1, 256], "
                                 f"got {self.pq_codes}")

        self._host = _host_rows(self.device, self.capacity_rows, N)
        if isinstance(init, torch.Tensor):
            # one copy into the host mirror (from a card: one DMA), and the
            # range reduced where the rows live
            torch.from_numpy(self._host)[:n0] = init
            vmax = float(init.float().abs().max()) if n0 else 0.0
        else:
            self._host[:n0] = init
            vmax = float(np.abs(init).max()) if init.size else 0.0

        if ids is None:
            ids = np.arange(n0, dtype=np.int64)
        else:
            ids = np.asarray(ids, np.int64)
            if ids.shape != (n0,) or len(set(ids.tolist())) != n0:
                raise ValueError("ids must be unique and match table rows")
        self._slot_ids = np.full(self.capacity_rows, -1, np.int64)
        self._slot_ids[:n0] = ids
        self._id2slot: Dict[int, int] = {int(i): s
                                         for s, i in enumerate(ids)}
        self._next_id = int(ids.max()) + 1 if n0 else 0

        self.n_live = n0
        self.version = 0
        self._vmax = vmax
        self._staged: List[Tuple[str, int, Optional[np.ndarray]]] = []
        #: optional zero-arg callable invoked at the top of
        #: `flush_updates`; may raise `StoreFlushError` to fail the
        #: flush before anything is applied (fault injection surface)
        self.fault_hook = None
        #: private `repro_torch.obs.metrics` registry, the JAX package's
        #: families in its order; the serving engines adopt it so
        #: ``store_*`` metrics appear in their exports
        self.metrics = MetricsRegistry()
        self._c_upserts = self.metrics.counter(
            "store_upserts_total", "Applied row upserts.")
        self._c_deletes = self.metrics.counter(
            "store_deletes_total", "Applied row deletes.")
        self._c_rows_written = self.metrics.counter(
            "store_rows_written_total", "Donated device row writes.")
        self._c_flush_failures = self.metrics.counter(
            "store_flush_failures_total",
            "flush_updates calls failed by the fault hook.")
        self._c_tiles_requant = self.metrics.counter(
            "store_tiles_requantized_total",
            "Dirty arm-tiles re-encoded into the quantized shadow.")
        self._c_refreshes = self.metrics.counter(
            "store_codebook_refreshes_total",
            "Full pq codebook retrain + re-encode passes.")
        self.metrics.gauge(
            "store_live_rows", "Live rows (dense prefix length).",
        ).set_fn(lambda: self.n_live)
        self.metrics.gauge(
            "store_capacity_rows", "Preallocated row capacity.",
        ).set_fn(lambda: self.capacity_rows)
        self.metrics.gauge(
            "store_version", "Monotonic mutation version.",
        ).set_fn(lambda: self.version)
        self.metrics.gauge(
            "store_pending_updates", "Staged, not yet flushed mutations.",
        ).set_fn(lambda: len(self._staged))
        self.metrics.gauge(
            "store_value_abs_max",
            "Monotone max |v| over all applied rows.",
        ).set_fn(lambda: self._vmax)

        self._V8 = self._vscale = self._codebook = None
        self._upload()
        if precision == "pq":
            S = self.block // self.pq_subdims
            if codebook is not None:
                cb = (codebook if isinstance(codebook, torch.Tensor)
                      else torch.from_numpy(np.asarray(codebook, np.float32)))
                want = (self.n_blocks, S, self.pq_codes, self.pq_subdims)
                if tuple(cb.shape) != want:
                    raise ValueError(f"codebook shape {tuple(cb.shape)} != "
                                     f"{want}")
                self._codebook = cb.to(self.device, torch.float32).clone()
            else:
                self._codebook = pq_train(self._V4, n_codes=self.pq_codes,
                                          subdims=self.pq_subdims)
        self._encode_all()

    # ---- counter surface (registry-backed) -------------------------------

    @property
    def n_upserts(self) -> int:
        """Applied row upserts (registry-backed)."""
        return int(self._c_upserts.total())

    @property
    def n_deletes(self) -> int:
        """Applied row deletes (registry-backed)."""
        return int(self._c_deletes.total())

    @property
    def rows_written(self) -> int:
        """Device row writes (registry-backed)."""
        return int(self._c_rows_written.total())

    @property
    def n_flush_failures(self) -> int:
        """Flushes failed by the fault hook (registry-backed)."""
        return int(self._c_flush_failures.total())

    @property
    def tiles_requantized(self) -> int:
        """Dirty tiles re-encoded into the shadow (registry-backed)."""
        return int(self._c_tiles_requant.total())

    @property
    def codebook_refreshes(self) -> int:
        """Full pq codebook retrain passes (registry-backed)."""
        return int(self._c_refreshes.total())

    # ---- device buffers ---------------------------------------------------

    def _chunks(self):
        for lo in range(0, self.n_tiles, _BUILD_CHUNK_TILES):
            yield lo, min(lo + _BUILD_CHUNK_TILES, self.n_tiles)

    def _upload(self) -> None:
        """(Re)build the tile-major device table from the host mirror."""
        R = self.tile
        self._V4 = torch.empty((self.n_tiles, self.n_blocks, R, self.block),
                               dtype=torch.float32, device=self.device)
        for lo, hi in self._chunks():
            V = torch.from_numpy(self._host[lo * R:hi * R]).to(self.device)
            if self._col_pad:
                V = torch.nn.functional.pad(V, (0, self._col_pad))
            self._V4[lo:hi] = V.reshape(hi - lo, R, self.n_blocks,
                                        self.block).permute(0, 2, 1, 3)

    def _encode_all(self) -> None:
        """Encode the whole shadow from the device table (construction,
        `grow` and `refresh_codebook` only), a chunk of tiles at a time:
        cells are independent, so the bytes are those of one call."""
        if self.precision in ("int8", "int4"):
            quantize = (quantize_tiles if self.precision == "int8"
                        else quantize_tiles_int4)
            width = self.block if self.precision == "int8" else \
                self.block // 2
            self._V8 = torch.empty((self.n_tiles, self.n_blocks, self.tile,
                                    width), dtype=torch.int8,
                                   device=self.device)
            self._vscale = torch.empty((self.n_tiles, self.n_blocks),
                                       dtype=torch.float32,
                                       device=self.device)
            for lo, hi in self._chunks():
                self._V8[lo:hi], self._vscale[lo:hi] = quantize(
                    self._V4[lo:hi])
        elif self.precision == "pq":
            S = self.block // self.pq_subdims
            self._V8 = torch.empty((self.n_tiles, self.n_blocks, self.tile,
                                    S), dtype=torch.uint8, device=self.device)
            _pq_encode_tiles(self._V4, torch.arange(self.n_tiles,
                                                    device=self.device),
                             self._codebook, self._V8)

    def _write_rows(self, slots) -> None:
        """Copy the host rows of ``slots`` into the tiled table in place:
        one host-to-device copy and one scatter for the whole set."""
        s = np.fromiter(sorted(slots), np.int64, len(slots))
        rows = torch.from_numpy(self._host[s]).to(self.device)
        if self._col_pad:
            rows = torch.nn.functional.pad(rows, (0, self._col_pad))
        idx = torch.from_numpy(s).to(self.device)
        self._V4[idx // self.tile, :, idx % self.tile, :] = rows.view(
            len(s), self.n_blocks, self.block)

    def _reencode(self, tiles) -> None:
        """Re-encode the dirty ``tiles`` of the shadow from the device
        table and splice codes and scales in place (per-cell independent,
        so bytewise a re-encode of the whole table)."""
        t = torch.as_tensor(sorted(tiles), dtype=torch.int64,
                            device=self.device)
        if self.precision == "int8":
            self._V8[t], self._vscale[t] = quantize_tiles(self._V4[t])
        elif self.precision == "int4":
            self._V8[t], self._vscale[t] = quantize_tiles_int4(self._V4[t])
        else:   # pq: against the frozen codebook
            _pq_encode_tiles(self._V4, t, self._codebook, self._V8)

    # ---- read side -------------------------------------------------------

    @property
    def n_valid(self) -> int:
        """The cascade's validity bound: live rows are exactly [0, n_live)."""
        return self.n_live

    @property
    def free_rows(self) -> int:
        """Capacity slack remaining (the suffix free pool)."""
        return self.capacity_rows - self.n_live

    @property
    def pending_updates(self) -> int:
        """Mutations staged but not yet applied by `flush_updates`."""
        return len(self._staged)

    @property
    def value_abs_max(self) -> float:
        """Monotonic max|v| over every row ever applied (never shrinks)."""
        return self._vmax

    def tiled_table(self) -> torch.Tensor:
        """The (n_tiles, n_blocks, tile, block) f32 device table every
        dispatch reads (columns zero-padded to ``n_blocks * block``),
        updated in place by every flush."""
        return self._V4

    def device_table(self) -> torch.Tensor:
        """The (capacity_rows, N) table on the device, row-major (live
        prefix + zero slack).

        Built from the tiled table at each call — a full copy, for tests
        and cold paths; the serving path reads `tiled_table`.
        """
        V4 = self._V4
        return (V4.permute(0, 2, 1, 3).reshape(self.capacity_rows, -1)
                [:, :self.N].contiguous())

    def quantized(self):
        """The tier's shadow artifacts, or None on the fp32 path.

        The 2-tuple `decode_tiled` takes as ``quantized=``: ``(V8,
        vscale)`` for 'int8', ``(P4 packed, vscale)`` for 'int4',
        ``(codes, codebook)`` for 'pq' (DESIGN.md §10/§11).
        """
        if self.precision == "fp32":
            return None
        if self.precision == "pq":
            return self._V8, self._codebook
        return self._V8, self._vscale

    def codebook(self):
        """The frozen pq codebook (table-level state), or None off-pq.

        Inject it into a fresh store built from `snapshot()` rows
        (``codebook=``) to reproduce this store's code shadow bytewise
        without retraining.
        """
        return self._codebook

    def refresh_codebook(self) -> dict:
        """Retrain the pq codebook on the current table and re-encode.

        The one *recalibrating* pq mutation (DESIGN.md §11): ordinary row
        churn re-encodes dirty tiles against the frozen codebook, which
        slowly degrades code fidelity as the data drifts; this O(n N)
        refresh re-anchors it and bumps ``version`` so every consumer
        cache invalidates.  Engines serving measured-error pq plans must
        re-measure ``quant_err`` afterwards.

        Raises RuntimeError unless ``precision='pq'``.
        """
        if self.precision != "pq":
            raise RuntimeError(
                f"refresh_codebook() needs precision='pq', "
                f"got {self.precision!r}")
        self._require_resident("refresh_codebook")
        t0 = time.perf_counter()
        self._codebook = pq_train(self._V4, n_codes=self.pq_codes,
                                  subdims=self.pq_subdims)
        self._encode_all()
        self._synchronize()
        self._c_refreshes.inc()
        self.version += 1
        return {"version": self.version,
                "refreshes": self.codebook_refreshes,
                "seconds": time.perf_counter() - t0}

    def host_table(self) -> np.ndarray:
        """Host mirror of the device table (read-only view; always fresh)."""
        v = self._host.view()
        v.flags.writeable = False
        return v

    def external_ids(self, slots) -> np.ndarray:
        """Map cascade row indices (slots) to external ids (-1 = dead)."""
        slots = np.asarray(slots)
        return self._slot_ids[np.clip(slots, 0, self.capacity_rows - 1)]

    def live_ids(self) -> np.ndarray:
        """External ids of the live rows, in slot order."""
        return self._slot_ids[:self.n_live].copy()

    def live_mask(self) -> np.ndarray:
        """Boolean (capacity_rows,) mask of live slots (the dense prefix)."""
        return self._slot_ids >= 0

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, ids) copies of the live prefix, in slot order.

        A fresh store built as ``DynamicTableStore(rows, ids=ids,
        capacity=capacity_rows)`` reproduces this store's buffers
        bytewise.  On the pq tier also pass ``codebook=self.codebook()``:
        codes are assignments against table-level codebook state.
        """
        return self._host[:self.n_live].copy(), self.live_ids()

    def page_state(self) -> dict:
        """Complete host-side page-out image of this store.

        Everything `from_page` needs to rebuild a store whose device
        buffers, shadow, id maps, ``version``, ``value_abs_max`` and id
        allocator equal this one's: the `snapshot` rows/ids plus
        geometry, precision, the frozen pq codebook (numpy) and the
        monotonic scalars; staged mutations are carried verbatim.  The
        image has the JAX package's keys and types, so one package's
        image loads in the other.  Churn counters restart at zero after
        a round trip.
        """
        rows, ids = self.snapshot()
        cb = (None if self._codebook is None
              else self._codebook.detach().cpu().numpy().copy())
        return {"rows": rows, "ids": ids,
                "capacity_rows": self.capacity_rows,
                "tile": self.tile, "block": self.block,
                "precision": self.precision,
                "pq_subdims": self.pq_subdims, "pq_codes": self.pq_codes,
                "codebook": cb, "dim": self.N,
                "version": self.version, "value_abs_max": self._vmax,
                "next_id": self._next_id,
                "staged": list(self._staged)}

    @classmethod
    def from_page(cls, state: dict, device="cuda") -> "DynamicTableStore":
        """Rebuild a store on ``device`` from a `page_state` image.

        The returned store's tables, shadow, id maps, ``version``,
        ``value_abs_max``, id allocator and staged-mutation queue all
        match the paged-out store's.
        """
        st = cls(state["rows"], dim=state["dim"],
                 capacity=state["capacity_rows"], tile=state["tile"],
                 block=state["block"], precision=state["precision"],
                 pq_subdims=state["pq_subdims"],
                 pq_codes=state["pq_codes"],
                 codebook=state["codebook"], ids=state["ids"],
                 device=device)
        if st.capacity_rows != state["capacity_rows"]:
            raise ValueError(
                f"page-in capacity mismatch: rebuilt {st.capacity_rows} "
                f"rows != paged {state['capacity_rows']}")
        st.version = int(state["version"])
        st._vmax = max(st._vmax, float(state["value_abs_max"]))
        st._next_id = max(st._next_id, int(state["next_id"]))
        st._staged = list(state["staged"])
        return st

    @property
    def resident(self) -> bool:
        """True unless `page_out` freed the device buffers."""
        return self._V4 is not None

    def _require_resident(self, what: str) -> None:
        if self._V4 is None:
            raise RuntimeError(f"{what} needs the store's device buffers; "
                               f"the store is paged out (page_in first)")

    def page_out(self) -> None:
        """Free every device buffer; keep the host side.

        The tiled table and the int8 / int4 shadow are dropped, the pq
        codebook moves to the host; the host mirror, id maps,
        ``version``, ``value_abs_max``, id allocator, staged mutations,
        fault hook and counters all stay.  Staging (`upsert`, `delete`,
        `append`) goes on while paged out; anything that reads or writes
        the device raises until `page_in`.  No-op when paged out.
        """
        if self._V4 is None:
            return
        if self._codebook is not None:
            self._codebook = self._codebook.cpu()
        self._V4 = self._V8 = self._vscale = None

    def page_in(self) -> None:
        """Rebuild the device buffers `page_out` freed, bytewise.

        The tiled table is the host mirror laid out again (every write
        goes through the mirror first) and the shadow a pure function of
        the tiled table and the frozen codebook (every flush re-encodes
        its dirty tiles bytewise a full encode), so both equal the freed
        buffers.  Ends in ``torch.cuda.synchronize()`` on a card, so a
        caller's clock read after it includes the copy.  No-op when
        resident.
        """
        if self._V4 is not None:
            return
        self._upload()
        if self._codebook is not None:
            self._codebook = self._codebook.to(self.device)
        self._encode_all()
        self._synchronize()

    def resident_bytes(self) -> int:
        """Device bytes this table pins while resident, in the JAX
        package's unit (the tenancy registry's budget counts these): the
        ``(capacity_rows, N)`` f32 table plus (on quantized tiers) the
        shadow — codes, scales and the pq codebook; 0 while paged out.
        Where ``N`` is not a whole number of blocks the tiled table also
        holds zero-padded columns, which `device_bytes` counts."""
        if self._V4 is None:
            return 0
        total = self.capacity_rows * self.N * 4
        for arr in (self._V8, self._vscale, self._codebook):
            if arr is not None:
                total += arr.numel() * arr.element_size()
        return total

    def device_bytes(self) -> int:
        """Device bytes the store really holds while resident: the tiled
        f32 table with its padded columns, plus the shadow; 0 while paged
        out (what a page-out frees)."""
        if self._V4 is None:
            return 0
        return sum(arr.numel() * arr.element_size()
                   for arr in (self._V4, self._V8, self._vscale,
                               self._codebook) if arr is not None)

    # ---- write side (staged) --------------------------------------------

    def upsert(self, ext_id: int, row) -> None:
        """Stage an insert-or-overwrite of external id ``ext_id``.

        New ids append at slot ``n_live`` (capacity permitting); known ids
        overwrite in place.  Applied by `flush_updates`.
        """
        row = np.asarray(row, np.float32)
        if row.shape != (self.N,):
            raise ValueError(f"row shape {row.shape} != ({self.N},)")
        ext_id = int(ext_id)
        if ext_id < 0:
            raise ValueError(f"ids must be >= 0, got {ext_id}")
        self._next_id = max(self._next_id, ext_id + 1)
        self._staged.append(("upsert", ext_id, row.copy()))

    def append(self, row) -> int:
        """Stage an insert under a fresh auto-assigned id; returns the id."""
        ext_id = self._next_id
        self.upsert(ext_id, row)
        return ext_id

    def delete(self, ext_id: int) -> None:
        """Stage removal of external id ``ext_id`` (raises at flush if
        unknown).  The vacated slot is swap-filled from the tail so live
        rows remain the dense prefix the cascade's ``n_valid`` masks."""
        self._staged.append(("delete", int(ext_id), None))

    # ---- apply -----------------------------------------------------------

    def _apply_upsert(self, ext_id: int, row: np.ndarray,
                      touched: set) -> None:
        slot = self._id2slot.get(ext_id)
        if slot is None:
            if self.n_live >= self.capacity_rows:
                raise RuntimeError(
                    f"store full: {self.n_live}/{self.capacity_rows} rows "
                    f"live; call grow() or provision more capacity_slack")
            slot = self.n_live
            self._id2slot[ext_id] = slot
            self._slot_ids[slot] = ext_id
            self.n_live += 1
        self._host[slot] = row
        self._c_rows_written.inc()
        touched.add(slot)
        self._vmax = max(self._vmax, float(np.abs(row).max(initial=0.0)))
        self._c_upserts.inc()
        self.version += 1

    def _apply_delete(self, ext_id: int, touched: set) -> None:
        slot = self._id2slot.pop(ext_id, None)
        if slot is None:
            raise KeyError(f"delete of unknown id {ext_id}")
        last = self.n_live - 1
        if slot != last:
            # swap-fill the hole from the tail: one row moved, ids stable
            moved = self._slot_ids[last]
            self._host[slot] = self._host[last]
            self._c_rows_written.inc()
            self._slot_ids[slot] = moved
            self._id2slot[int(moved)] = slot
            touched.add(slot)
        self._host[last] = 0.0
        self._c_rows_written.inc()
        self._slot_ids[last] = -1
        touched.add(last)
        self.n_live -= 1
        self._c_deletes.inc()
        self.version += 1

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def flush_updates(self) -> dict:
        """Apply every staged mutation in submission order; returns stats.

        O(rows touched) work: each op updates the host mirror and the id
        maps; then the touched rows are written into the tiled device
        table in place (one copy and one scatter for the flush) and — on
        the quantized tiers — the touched (dirty) arm-tiles are re-encoded
        on the device and spliced into the shadow (int8/int4 re-quantization, or
        pq re-encode against the frozen codebook; each bytewise a full
        rebuild of the updated table).  Bumps ``version`` once per
        applied mutation.  Returns ``{"applied", "version",
        "requantized_tiles", "seconds"}``.

        On a failing mutation (unknown delete, capacity exhausted) the
        failing op is dropped, the ops staged after it stay staged, and
        the device table and shadow are still synchronized to everything
        already applied before the error re-raises — the store is never
        torn.

        If a ``fault_hook`` is installed it runs first and may raise
        `StoreFlushError` *before* anything is applied: the staged queue
        is untouched and the caller retries at its next flush.
        """
        t0 = time.perf_counter()
        self._require_resident("flush_updates")
        if self.fault_hook is not None:
            try:
                self.fault_hook()
            except Exception:
                # nothing taken yet: every staged op survives for retry
                self._c_flush_failures.inc()
                raise
        touched: set = set()
        applied = 0
        staged, self._staged = self._staged, []
        try:
            for op, ext_id, row in staged:
                if op == "upsert":
                    self._apply_upsert(ext_id, row, touched)
                else:
                    self._apply_delete(ext_id, touched)
                applied += 1
        except Exception:
            # drop the failing op, keep its successors staged (in front
            # of anything staged while we ran), then fall through to the
            # device sync below before re-raising
            self._staged = staged[applied + 1:] + self._staged
            raise
        finally:
            dirty = {s // self.tile for s in touched}
            if touched:
                self._write_rows(touched)
                if self.precision != "fp32":
                    self._reencode(dirty)
                    self._c_tiles_requant.inc(len(dirty))
            if applied:
                self._synchronize()
        return {"applied": applied, "version": self.version,
                "requantized_tiles": len(dirty)
                if self.precision != "fp32" else 0,
                "seconds": time.perf_counter() - t0}

    def grow(self, capacity: int) -> None:
        """Reallocate to a larger capacity (rounded to a tile multiple).

        The one mutation that changes the table's shape: consumers must
        rebuild their plans (the executor does when it observes
        ``capacity_rows`` changed).  O(n N): re-uploads the table and
        re-encodes the shadow from scratch — pq against the frozen
        codebook.
        """
        capacity = max(int(capacity), self.n_live)
        new_rows = -(-capacity // self.tile) * self.tile
        if new_rows <= self.capacity_rows:
            return
        self._require_resident("grow")
        host = _host_rows(self.device, new_rows, self.N)
        host[:self.capacity_rows] = self._host
        slot_ids = np.full(new_rows, -1, np.int64)
        slot_ids[:self.capacity_rows] = self._slot_ids
        self._host, self._slot_ids = host, slot_ids
        self.capacity_rows = new_rows
        self.n_tiles = new_rows // self.tile
        self._V4 = self._V8 = self._vscale = None   # free before realloc
        self._upload()
        self._encode_all()
        self._synchronize()
        self.version += 1

    # ---- observability ---------------------------------------------------

    def stats(self) -> dict:
        """Counters: live/capacity rows, version, churn totals."""
        return {"n_live": self.n_live, "capacity_rows": self.capacity_rows,
                "utilization": self.n_live / max(1, self.capacity_rows),
                "version": self.version, "upserts": self.n_upserts,
                "deletes": self.n_deletes, "rows_written": self.rows_written,
                "tiles_requantized": self.tiles_requantized,
                "codebook_refreshes": self.codebook_refreshes,
                "value_abs_max": self._vmax,
                "flush_failures": self.n_flush_failures,
                "pending": len(self._staged)}
