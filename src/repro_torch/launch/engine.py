"""Serving engine internals of the port: executor and micro-batch engine.

The PyTorch counterpart of ``repro.launch.engine`` for a static table on
one device:

  * :class:`CascadeExecutor` — owns the table (re-laid tile-major once,
    and on the int8, int4 and pq tiers quantized once), the calibrated
    (eps, delta) plan and the cached schedule operands; `dispatch` serves
    a padded lane buffer with ONE fused-cascade launch and returns host
    arrays plus the measured seconds.
  * :class:`MIPSServeEngine` — the micro-batching request loop over one
    executor: batch/deadline triggers, `QuantizedLRU`, sampled recall.

The engine draws each flush's block permutation from a ``torch.Generator``
seeded from ``(seed, batch sequence)``; ``perm_source`` replaces that
draw (tests inject the JAX package's permutations through it).  Dynamic
stores, meshes and the continuous-batching ``ServeRuntime`` are later
slices (ROADMAP.md) and are refused here.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.boundedme_torch import (decode_operands, decode_tiled,
                                              make_plan,
                                              measured_plan_quant_err,
                                              quantize_table, resolve_device,
                                              tile_table)
from repro_torch.core.mips import exact_topk, table_abs_max
from repro_torch.core.schedule import pulls_through_round
from repro_torch.obs.metrics import MetricsRegistry, summarize_latencies

__all__ = ["QuantizedLRU", "CascadeExecutor", "MIPSServeEngine"]


class QuantizedLRU:
    """LRU result cache keyed on quantized queries.

    Keys are the bytes of ``round(q / resolution)`` (int64): any two
    queries within ``resolution`` per coordinate share a cache line, which
    is exactly the granularity at which an (eps, delta)-approximate answer
    is reusable.  ``resolution=0`` disables quantization sharing (exact
    byte equality only).  Capacity 0 disables the cache entirely.
    """

    def __init__(self, capacity: int, resolution: float = 1e-3):
        self.capacity = int(capacity)
        self.resolution = float(resolution)
        self._od: "collections.OrderedDict[bytes, object]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def key(self, q: np.ndarray) -> bytes:
        """Quantize a (N,) query to its cache key."""
        if self.resolution > 0:
            return np.round(np.asarray(q, np.float32)
                            / self.resolution).astype(np.int64).tobytes()
        return np.asarray(q, np.float32).tobytes()   # exact bytes only

    def get(self, key: bytes):
        """Return the cached value or None; counts the hit/miss."""
        hit = self._od.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._od.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key: bytes, value) -> None:
        """Insert/update; evicts the least-recently-used past capacity."""
        if self.capacity <= 0:
            return
        self._od[key] = value
        self._od.move_to_end(key)
        while len(self._od) > self.capacity:
            self._od.popitem(last=False)

    def __len__(self) -> int:
        return len(self._od)


@dataclasses.dataclass
class _Pending:
    req_id: int
    q: np.ndarray
    t_submit: float
    cache_key: Optional[bytes]


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet ({item} of "
                              f"ROADMAP.md); the port serves a static "
                              f"table on one device")


class CascadeExecutor:
    """The executor layer: one calibrated (eps, delta) dispatch path.

    Owns the static item table — re-laid tile-major on ``device`` once —
    plus the `make_plan` calibration for exactly one eps point.  On the
    int8, int4 and pq tiers the table is quantized once here and every
    dispatch reads that copy; pq calibrates its measured ``quant_err`` on
    the table unless one is given.  `dispatch` runs one fused-cascade
    launch over a padded ``(lanes, N)`` query buffer and returns host
    arrays plus the measured seconds (ending in
    ``torch.cuda.synchronize()`` on the card); `recall_of` rescores a
    query exhaustively against the table.
    """

    def __init__(self, table, *, K: int = 1, eps: float = 0.1,
                 delta: float = 0.1, value_range: Optional[float] = None,
                 qmax_hint: float = 1.0, tile: int = 8, block: int = 512,
                 mesh=None, n_valid: Optional[int] = None,
                 precision: str = "fp32", adaptive: bool = False,
                 bound: str = "hoeffding", pull_mode: str = "row",
                 coord_block: int = 128, quant_err: Optional[float] = None,
                 pq_subdims: int = 8, pq_codes: int = 16,
                 metrics: Optional[MetricsRegistry] = None,
                 device="cuda"):
        if not isinstance(table, (torch.Tensor, np.ndarray)):
            _refuse(f"serving a {type(table).__name__}",
                    "queue 1 item 7 (dynamic stores)")
        if mesh is not None:
            _refuse("sharded serving", "queue 1 item 10")
        self.device = resolve_device(device)
        self._table = torch.as_tensor(table, dtype=torch.float32).to(
            self.device)
        n, N = self._table.shape
        if value_range is None:
            # a-priori product-range bound: callers who know their query
            # norms should pass an explicit value_range instead
            value_range = 2.0 * float(qmax_hint) * table_abs_max(self._table)
        self.n, self.N, self.K = n, N, K
        self.eps, self.delta = float(eps), float(delta)
        self.adaptive = bool(adaptive)
        block = min(int(block), N)
        if precision == "pq" and quant_err is None:
            # pq has no a-priori worst-case model: calibrate a measured
            # per-pull bound on the served table; a hybrid plan prices two
            # pull widths with different codebooks, so take the max
            widths = {"row": (block,), "coord": (coord_block,),
                      "hybrid": (block, coord_block)}[pull_mode]
            quant_err = max(measured_plan_quant_err(
                self._table, precision="pq", tile=tile, block=w,
                pq_subdims=pq_subdims, pq_codes=pq_codes,
                device=self.device) for w in widths)
        self.plan = make_plan(n, N, K=K, eps=eps, delta=delta,
                              value_range=value_range, tile=tile,
                              block=block, precision=precision, bound=bound,
                              pull_mode=pull_mode, coord_block=coord_block,
                              quant_err=quant_err, pq_subdims=pq_subdims,
                              pq_codes=pq_codes)
        self._V4 = tile_table(self._table, self.plan, self.device)
        self._quant = (quantize_table(self._V4, self.plan)
                       if self.plan.precision != "fp32" else None)
        self._nv = n if n_valid is None else int(n_valid)
        # the schedule operands every dispatch reads: built now, not in
        # the first request's dispatch
        decode_operands(self.plan, final_exact=True, adaptive=self.adaptive,
                        device=self.device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        lbl = {"precision": self.plan.precision,
               "pull_mode": self.plan.pull_mode, "eps": f"{self.eps:.6g}"}
        self._mlabels = lbl
        keys = tuple(lbl)
        self._c_dispatch = self.metrics.counter(
            "cascade_dispatches_total", "Fused-cascade kernel launches.",
            keys)
        self._h_dispatch = self.metrics.histogram(
            "cascade_dispatch_ms",
            "Measured blocking compute time per dispatch (ms).", keys)
        self._c_dispatch.seed(**lbl)

    @property
    def n_dispatches(self) -> int:
        """Dispatches served (registry-backed)."""
        return int(self._c_dispatch.get(**self._mlabels))

    @property
    def tiled_table(self) -> torch.Tensor:
        """The tile-major table every dispatch reads."""
        return self._V4

    @property
    def n_valid(self) -> int:
        """Rows at or past this index never win a ranking."""
        return self._nv

    @property
    def quantized(self):
        """The table artifacts every dispatch reads on a quantized tier
        (`quantize_table` layout), else None."""
        return self._quant

    def dispatch(self, Qbuf: np.ndarray, perm) -> Tuple[
            np.ndarray, np.ndarray, Optional[np.ndarray], float]:
        """Serve one padded (lanes, N) buffer in a single kernel launch.

        ``perm`` is the batch's shared block permutation.  Returns ``(ids,
        scores, rounds_used, seconds)``, the first three as host arrays
        (``rounds_used`` is None unless adaptive); ``seconds`` is the
        measured blocking time, which virtual-clock loops add to their
        clock.
        """
        on_card = self.device.type == "cuda"
        t0 = time.perf_counter()
        out = decode_tiled(self._V4, Qbuf, perm, plan=self.plan,
                           final_exact=True, n_valid=self._nv,
                           quantized=self._quant, adaptive=self.adaptive)
        if on_card:
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self._c_dispatch.inc(**self._mlabels)
        self._h_dispatch.observe(dt * 1e3, **self._mlabels)
        rounds = out[2].cpu().numpy() if self.adaptive else None
        return out[0].cpu().numpy(), out[1].cpu().numpy(), rounds, dt

    def recall_of(self, q: np.ndarray, got_slots: np.ndarray) -> float:
        """Exact-top-K overlap of a served answer (exhaustive rescore on
        the executor's device)."""
        exact, _ = exact_topk(self._table[:self._nv],
                              torch.from_numpy(q).to(self.device), self.K)
        return len(set(exact.tolist()) & set(got_slots.tolist())) / self.K


def seeded_perm(seed: int, batch_seq: int, n_blocks: int) -> torch.Tensor:
    """The block permutation of flush ``batch_seq`` under ``seed``."""
    state = np.random.SeedSequence([int(seed), int(batch_seq)])
    g = torch.Generator(device="cpu")
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return torch.randperm(n_blocks, generator=g)


class MIPSServeEngine:
    """Micro-batching MIPS request loop over a fixed item table.

    Requests (`submit`) are answered from the LRU when a quantized-equal
    query was served recently; otherwise they queue until either
    ``batch_size`` requests are waiting or the oldest has aged past
    ``deadline_ms`` (`poll` applies both triggers), then the whole
    micro-batch is served by ONE fused-cascade dispatch through a
    `CascadeExecutor`.  Results arrive via `result` as ``(ids (K,),
    scores (K,))`` numpy arrays.

    ``recall_sample_rate`` > 0 additionally rescoring a random fraction of
    requests exhaustively on the host and folds top-K recall into `stats`.
    ``perm_source(batch_seq) -> perm`` replaces the engine's own seeded
    permutation draw (`seeded_perm`).  The engine is not thread-safe;
    drive it from one loop.
    """

    def __init__(self, table, *, K: int = 1, eps: float = 0.1,
                 delta: float = 0.1, value_range: Optional[float] = None,
                 qmax_hint: float = 1.0, tile: int = 8, block: int = 512,
                 batch_size: int = 8, deadline_ms: float = 2.0,
                 cache_entries: int = 512, cache_resolution: float = 1e-3,
                 mesh=None, n_valid: Optional[int] = None,
                 recall_sample_rate: float = 0.0,
                 precision: str = "fp32", adaptive: bool = False,
                 bound: str = "hoeffding", pull_mode: str = "row",
                 coord_block: int = 128, quant_err: Optional[float] = None,
                 pq_subdims: int = 8, pq_codes: int = 16, seed: int = 0,
                 metrics: Optional[MetricsRegistry] = None,
                 perm_source: Optional[Callable[[int], object]] = None,
                 device="cuda"):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._exec = CascadeExecutor(
            table, K=K, eps=eps, delta=delta, value_range=value_range,
            qmax_hint=qmax_hint, tile=tile, block=block, mesh=mesh,
            n_valid=n_valid, precision=precision, adaptive=adaptive,
            bound=bound, pull_mode=pull_mode, coord_block=coord_block,
            quant_err=quant_err, pq_subdims=pq_subdims, pq_codes=pq_codes,
            metrics=self.metrics, device=device)
        self.K = K
        self._adaptive = bool(adaptive)
        self._bound = bound
        self.batch_size = int(batch_size)
        self.deadline_s = float(deadline_ms) * 1e-3
        self._seed = int(seed)
        n_blocks = self.plan.n_blocks
        self._perm_source = (perm_source if perm_source is not None else
                             (lambda s: seeded_perm(self._seed, s, n_blocks)))
        self.cache = QuantizedLRU(cache_entries, cache_resolution)
        self._pending: List[_Pending] = []
        self._results: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._next_id = 0
        self._recall_rate = float(recall_sample_rate)
        self._recall_rng = np.random.default_rng(seed)
        self._lat: List[float] = []
        self._recalls: List[float] = []
        self._rounds: List[int] = []   # adaptive: per-query exit rounds
        self._c_requests = self.metrics.counter(
            "serve_requests_total", "Requests submitted.")
        self._c_cache_hits = self.metrics.counter(
            "serve_cache_hits_total", "Requests answered from the LRU.")
        self._c_batches = self.metrics.counter(
            "serve_batches_total", "Micro-batch flushes by trigger.",
            ("trigger",))
        self._c_batches.seed(trigger="full")
        self._c_batches.seed(trigger="deadline")
        self._h_latency = self.metrics.histogram(
            "serve_latency_ms", "Per-request latency (ms), cache hits at 0.")
        self._h_occupancy = self.metrics.histogram(
            "serve_batch_occupancy", "Filled lanes per micro-batch flush.",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))
        self.metrics.gauge(
            "serve_pending", "Requests accepted but not yet served.",
        ).set_fn(lambda: len(self._pending))
        self.metrics.gauge(
            "serve_cache_entries", "Live LRU cache entries.",
        ).set_fn(lambda: len(self.cache))
        #: plain dispatch sequence for the permutation draw — deliberately
        #: NOT registry-backed so metric wiring can never perturb sampling
        self._batch_seq = 0
        self._occupancy: List[int] = []

    @property
    def n_requests(self) -> int:
        """Requests submitted (registry-backed)."""
        return int(self._c_requests.total())

    @property
    def n_cache_hits(self) -> int:
        """Cache-answered requests (registry-backed)."""
        return int(self._c_cache_hits.total())

    @property
    def n_batches(self) -> int:
        """Micro-batch flushes, all triggers (registry-backed)."""
        return int(self._c_batches.total())

    @property
    def n_full_flushes(self) -> int:
        """Flushes triggered by a full batch (registry-backed)."""
        return int(self._c_batches.get(trigger="full"))

    @property
    def n_deadline_flushes(self) -> int:
        """Flushes triggered by the batch deadline (registry-backed)."""
        return int(self._c_batches.get(trigger="deadline"))

    @property
    def n(self) -> int:
        """Rows of the served table."""
        return self._exec.n

    @property
    def N(self) -> int:
        """Query/item dimensionality."""
        return self._exec.N

    @property
    def plan(self):
        """The executor's calibrated BlockedPlan."""
        return self._exec.plan

    @property
    def executor(self) -> CascadeExecutor:
        """The executor serving this engine's flushes."""
        return self._exec

    @property
    def pending_count(self) -> int:
        """Requests accepted but not yet served (excludes cache hits)."""
        return len(self._pending)

    def submit(self, q, now: Optional[float] = None) -> int:
        """Accept one (N,) query; returns its request id.

        Cache hits complete immediately (latency 0); misses queue for the
        next micro-batch.  ``now`` (seconds, any monotonic origin) defaults
        to wall clock — pass a virtual clock for simulation.
        """
        q = np.asarray(q, np.float32)
        if q.shape != (self.N,):
            raise ValueError(f"query shape {q.shape} != ({self.N},)")
        now = time.perf_counter() if now is None else now
        rid = self._next_id
        self._next_id += 1
        self._c_requests.inc()
        ck = self.cache.key(q) if self.cache.capacity > 0 else None
        if ck is not None:
            hit = self.cache.get(ck)
            if hit is not None:
                self._results[rid] = hit
                self._c_cache_hits.inc()
                self._lat.append(0.0)
                self._h_latency.observe(0.0)
                return rid
        self._pending.append(_Pending(rid, q, now, ck))
        return rid

    def poll(self, now: Optional[float] = None) -> Tuple[List[int], float]:
        """Flush micro-batches whose trigger fired; returns (ids, busy_s).

        Triggers: ``batch_size`` requests waiting (full flush), or the
        oldest pending request older than the batch deadline (deadline
        flush).  ``busy_s`` is the wall time spent in compute, so virtual-
        clock drivers can advance time by it.
        """
        now = time.perf_counter() if now is None else now
        done: List[int] = []
        busy = 0.0
        while self._pending:
            full = len(self._pending) >= self.batch_size
            aged = now - self._pending[0].t_submit >= self.deadline_s
            if not (full or aged):
                break
            self._c_batches.inc(trigger="full" if full else "deadline")
            ids, dt = self._flush(now + busy)
            done.extend(ids)
            busy += dt
        return done, busy

    def drain(self, now: Optional[float] = None) -> Tuple[List[int], float]:
        """Flush everything pending regardless of triggers (shutdown)."""
        now = time.perf_counter() if now is None else now
        done: List[int] = []
        busy = 0.0
        while self._pending:
            self._c_batches.inc(trigger="deadline")
            ids, dt = self._flush(now + busy)
            done.extend(ids)
            busy += dt
        return done, busy

    def result(self, req_id: int):
        """Pop the (ids, scores) result for a completed request, or None."""
        return self._results.pop(req_id, None)

    def _flush(self, now: float) -> Tuple[List[int], float]:
        batch = self._pending[:self.batch_size]
        self._pending = self._pending[len(batch):]
        Qbuf = np.zeros((self.batch_size, self.N), np.float32)
        for i, p in enumerate(batch):
            Qbuf[i] = p.q
        perm = self._perm_source(self._batch_seq)
        ids, scores, rounds, dt = self._exec.dispatch(Qbuf, perm)
        ids = ids[:len(batch)]
        scores = scores[:len(batch)]
        if rounds is not None:
            self._rounds.extend(rounds[:len(batch)].tolist())
        self._batch_seq += 1
        self._occupancy.append(len(batch))
        self._h_occupancy.observe(len(batch))
        done = []
        for i, p in enumerate(batch):
            res = (ids[i].copy(), scores[i].copy())
            self._results[p.req_id] = res
            if p.cache_key is not None:
                self.cache.put(p.cache_key, res)
            self._lat.append((now - p.t_submit) + dt)
            self._h_latency.observe(((now - p.t_submit) + dt) * 1e3)
            if (self._recall_rate > 0.0
                    and self._recall_rng.random() < self._recall_rate):
                self._recalls.append(self._exec.recall_of(p.q, ids[i]))
            done.append(p.req_id)
        if len(self._lat) > 100_000:       # bound the stats memory
            self._lat = self._lat[-10_000:]
        if len(self._occupancy) > 100_000:
            self._occupancy = self._occupancy[-10_000:]
        if len(self._recalls) > 100_000:
            self._recalls = self._recalls[-10_000:]
        if len(self._rounds) > 100_000:
            self._rounds = self._rounds[-10_000:]
        return done, dt

    def _adaptive_stats(self) -> dict:
        """Early-exit telemetry: rounds_used histogram + mean pull frac."""
        out = {"enabled": self._adaptive, "bound": self._bound}
        if not self._adaptive:
            return out
        hist: Dict[int, int] = {}
        for r in self._rounds:
            hist[int(r)] = hist.get(int(r), 0) + 1
        pulls = pulls_through_round(self.plan.schedule)
        total = max(1, int(pulls[-1]))
        samples = max(1, len(self._rounds))
        mean_pulls = sum(int(pulls[min(r, len(pulls) - 1)]) * c
                         for r, c in hist.items()) / samples
        out.update({
            "samples": len(self._rounds),
            "rounds_hist": {str(k): v for k, v in sorted(hist.items())},
            "mean_rounds": (float(np.mean(self._rounds))
                            if self._rounds else 0.0),
            "mean_pull_frac": mean_pulls / total,
        })
        return out

    def stats(self) -> dict:
        """Per-request latency/recall counters as a plain dict.

        latency_ms percentiles include cache hits (latency 0); recall is
        over the sampled fraction only (``nan`` when nothing was sampled).
        """
        occ = np.asarray(self._occupancy, np.float64)
        return {
            "requests": self.n_requests,
            "completed": self.n_requests - len(self._pending),
            "pending": len(self._pending),
            "batches": self.n_batches,
            "full_flushes": self.n_full_flushes,
            "deadline_flushes": self.n_deadline_flushes,
            "mean_batch_occupancy": float(occ.mean()) if occ.size else 0.0,
            "cache": {"hits": self.cache.hits, "misses": self.cache.misses,
                      "entries": len(self.cache),
                      "hit_rate": (self.cache.hits
                                   / max(1, self.cache.hits
                                         + self.cache.misses))},
            "latency_ms": summarize_latencies(
                self._lat, keys=("mean", "p50", "p95", "max")),
            "recall": {"samples": len(self._recalls),
                       "mean": (float(np.mean(self._recalls))
                                if self._recalls else float("nan"))},
            "plan": {"rounds": len(self.plan.schedule.rounds),
                     "pull_speedup": self.plan.schedule.speedup},
            "adaptive": self._adaptive_stats(),
        }
