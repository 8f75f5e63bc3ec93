"""Per-request span tracing on the serving stack's virtual clock.

A copy of ``repro.obs.trace`` (the port imports nothing of the JAX
package); its exports are byte-equal to the reference's for the same
events.

:class:`SpanTracer` records the life of each request through
``ServeRuntime`` — ``submit -> admission -> queued -> batch-assembly ->
dispatch(n) -> retry/backoff -> complete(status)`` — and exports Chrome
trace-event JSON (the ``{"traceEvents": [...]}`` object format) loadable
directly in Perfetto / ``chrome://tracing``.

Layout: everything lives in pid 1.  Thread 0 is the shared
executor/dispatch track (complete ``X`` spans per batch dispatch,
annotated with rung, eps_served, rounds_used, pull fraction and fault
injections); each sampled request gets its own thread ``TID_REQ_BASE +
rid`` carrying the request-scoped spans.  Timestamps are the virtual
clock in microseconds (floats — Chrome accepts fractional ``ts``), so a
trace of a simulated bursty stream reads in real units.

Memory is bounded two ways: per-request tracks go through reservoir
sampling (Algorithm R, deterministic seed) once more than
``max_requests`` requests have begun, and the shared dispatch track is a
ring of the last ``max_global_events`` spans.

Beside it, the port's host spans (`span`, `span_stats`, `reset_spans`):
named ranges of the program's own host work -- the serving engine, the
executor, the cascade's host steps, the decode step and the model's
layers -- recorded on ``torch.profiler``'s clock while a profiler is
recording, and into a process-wide table of per-name aggregates.  Off, a
span is one flag read.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler

#: request tracks start here so tid 0 (dispatch track) stays reserved
TID_REQ_BASE = 16


class SpanTracer:
    """Bounded-memory collector of Chrome trace events (one per run).

    Timestamps are the serving stack's *virtual* clock (seconds,
    rendered as microsecond ``ts``); the export loads directly in
    Perfetto.  Per-request tracks are reservoir-sampled past
    ``max_requests`` so memory stays bounded on long streams.

    Typical wiring (done by ``ServeRuntime`` when constructed with
    ``tracer=``)::

        tr = SpanTracer(max_requests=256, seed=0)
        tr.request_begin(rid, t_submit, priority_class="default")
        tr.instant(rid, "admitted", t_submit)
        tr.span(rid, "queued", t_submit, t_dispatch)
        tr.span(rid, "serve", t_dispatch, t_done, rung=1, eps_served=0.6)
        tr.request_end(rid, t_done, "ok")
        tr.write("trace.json")
    """

    def __init__(self, max_requests: int = 512,
                 max_global_events: int = 4096, seed: int = 0) -> None:
        if max_requests < 1:
            raise ValueError("max_requests must be >= 1")
        self.max_requests = int(max_requests)
        self._rng = np.random.default_rng(seed)
        #: rid -> list of this request's events (sampled requests only)
        self._per_req: Dict[int, List[dict]] = {}
        #: reservoir slots, parallel to _per_req keys
        self._slots: List[int] = []
        #: rid -> (t_begin, args) for the enclosing request span
        self._open: Dict[int, tuple] = {}
        self._global: deque = deque(maxlen=int(max_global_events))
        self.n_seen = 0          #: requests offered to the reservoir
        self.n_dropped = 0       #: requests evicted or never sampled

    # ---- sampling -------------------------------------------------------

    def sampled(self, rid: int) -> bool:
        """True if ``rid`` currently holds a reservoir slot."""
        return rid in self._per_req

    def request_begin(self, rid: int, t: float, **args: object) -> bool:
        """Offer request ``rid`` (beginning at virtual time ``t``) to the
        reservoir.  Returns True if it was sampled; all later per-request
        calls for an unsampled rid are no-ops."""
        self.n_seen += 1
        if len(self._slots) < self.max_requests:
            self._slots.append(rid)
        else:
            j = int(self._rng.integers(0, self.n_seen))
            if j >= self.max_requests:
                self.n_dropped += 1
                return False
            evicted = self._slots[j]
            self._slots[j] = rid
            self._per_req.pop(evicted, None)
            self._open.pop(evicted, None)
            self.n_dropped += 1
        self._per_req[rid] = []
        self._open[rid] = (float(t), dict(args))
        return True

    # ---- event emission -------------------------------------------------

    def span(self, rid: int, name: str, t0: float, t1: float,
             cat: str = "request", **args: object) -> None:
        """Complete span ``[t0, t1]`` on request ``rid``'s track."""
        evs = self._per_req.get(rid)
        if evs is None:
            return
        evs.append(_complete(name, cat, TID_REQ_BASE + rid, t0, t1, args))

    def instant(self, rid: int, name: str, t: float,
                cat: str = "request", **args: object) -> None:
        """Zero-duration marker on request ``rid``'s track."""
        evs = self._per_req.get(rid)
        if evs is None:
            return
        evs.append({"ph": "i", "name": name, "cat": cat, "pid": 1,
                    "tid": TID_REQ_BASE + rid, "ts": _us(t), "s": "t",
                    "args": dict(args)})

    def request_end(self, rid: int, t: float, status: str,
                    **args: object) -> None:
        """Close request ``rid``: emits the enclosing ``request`` span
        from its begin time to ``t``, annotated with the outcome."""
        opened = self._open.pop(rid, None)
        evs = self._per_req.get(rid)
        if opened is None or evs is None:
            return
        t0, a = opened
        a.update(args, status=status)
        evs.append(_complete(f"request rid={rid}", "request",
                             TID_REQ_BASE + rid, t0, max(float(t), t0), a))

    def global_span(self, name: str, t0: float, t1: float, tid: int = 0,
                    cat: str = "dispatch", **args: object) -> None:
        """Complete span on a shared track (tid 0 = dispatch/executor)."""
        self._global.append(_complete(name, cat, tid, t0, t1, args))

    # ---- export ---------------------------------------------------------

    def export(self) -> dict:
        """The Chrome trace-event object: metadata + all retained events.

        Unclosed requests get a zero-length ``request`` span at their
        begin time so every sampled rid has an enclosing span.
        """
        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": "mips-serve"}},
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": 0,
             "args": {"name": "dispatch"}},
        ]
        events.extend(self._global)
        for rid in sorted(self._per_req):
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": TID_REQ_BASE + rid,
                           "args": {"name": f"request {rid}"}})
            events.extend(self._per_req[rid])
            if rid in self._open:
                t0, a = self._open[rid]
                a = dict(a, status="unterminated")
                events.append(_complete(f"request rid={rid}", "request",
                                        TID_REQ_BASE + rid, t0, t0, a))
        return {
            "displayTimeUnit": "ms",
            "otherData": {"n_requests_seen": self.n_seen,
                          "n_requests_sampled": len(self._per_req),
                          "n_requests_dropped": self.n_dropped,
                          "clock": "virtual"},
            "traceEvents": events,
        }

    def write(self, path: str) -> None:
        """Serialize :meth:`export` to ``path`` as JSON."""
        with open(path, "w") as f:
            json.dump(self.export(), f, indent=1)


def _us(t: float) -> float:
    return float(t) * 1e6


def _complete(name: str, cat: str, tid: int, t0: float, t1: float,
              args: dict) -> dict:
    return {"ph": "X", "name": name, "cat": cat, "pid": 1, "tid": tid,
            "ts": _us(t0), "dur": max(_us(t1) - _us(t0), 0.0),
            "args": dict(args)}


# ---- host spans ----------------------------------------------------------


class _Agg:
    """One span name's aggregate: entries, host seconds, host self
    seconds, device seconds (None until a device span resolves) and
    named counters."""

    __slots__ = ("count", "host_s", "self_s", "device_s", "counters")

    def __init__(self) -> None:
        self.count = 0
        self.host_s = 0.0
        self.self_s = 0.0
        self.device_s: Optional[float] = None
        self.counters: Dict[str, float] = {}


#: span name -> its aggregate, over every thread
_AGGS: Dict[str, _Agg] = {}
#: (aggregate, device index, start event, end event) of device spans not
#: yet read (`span_stats`, `reset_spans`)
_PENDING: List[tuple] = []
#: device index -> timing events free for reuse
_EVENTS: Dict[int, List["torch.cuda.Event"]] = {}
_LOCK = threading.Lock()


class _Stack(threading.local):
    def __init__(self) -> None:
        self.open: List["_Span"] = []


_STACK = _Stack()


class _NoSpan:
    """The span of a process where no profiler records: does nothing."""

    __slots__ = ()

    def __bool__(self) -> bool:
        """False, so a body can skip work done only to feed `count`."""
        return False

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False

    def count(self, key: str, n: float) -> None:
        """Counts nothing."""


_NO_SPAN = _NoSpan()


def _event(index: int) -> "torch.cuda.Event":
    free = _EVENTS.get(index)
    if free:
        return free.pop()
    return torch.cuda.Event(enable_timing=True)


def _resolve() -> None:
    """Add the device time of the pending device spans to their
    aggregates, waiting for their end events, and free their events."""
    for agg, index, e0, e1 in _PENDING:
        e1.synchronize()
        agg.device_s = (agg.device_s or 0.0) + e0.elapsed_time(e1) / 1e3
        _EVENTS.setdefault(index, []).extend((e0, e1))
    _PENDING.clear()


class _Span:
    """One recorded entry of a span (see `span`)."""

    __slots__ = ("name", "index", "rf", "ev0", "t0", "child", "counters")

    def __init__(self, name: str, index: Optional[int]) -> None:
        self.name, self.index = name, index
        self.counters: Optional[Dict[str, float]] = None

    def __enter__(self) -> "_Span":
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.ev0 = None
        if self.index is not None:
            self.ev0 = _event(self.index)
            self.ev0.record(torch.cuda.current_stream(self.index))
        self.child = 0.0
        _STACK.open.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        dt = time.perf_counter() - self.t0
        stack = _STACK.open
        stack.pop()
        if stack:
            stack[-1].child += dt
        ev1 = None
        if self.ev0 is not None:
            ev1 = _event(self.index)
            ev1.record(torch.cuda.current_stream(self.index))
        with _LOCK:
            agg = _AGGS.get(self.name)
            if agg is None:
                agg = _AGGS[self.name] = _Agg()
            agg.count += 1
            agg.host_s += dt
            agg.self_s += dt - self.child
            if self.counters:
                for k, n in self.counters.items():
                    agg.counters[k] = agg.counters.get(k, 0) + n
            if ev1 is not None:
                _PENDING.append((agg, self.index, self.ev0, ev1))
        self.rf.__exit__(None, None, None)
        return False

    def count(self, key: str, n: float) -> None:
        """Add ``n`` to this span's counter ``key``."""
        if self.counters is None:
            self.counters = {}
        self.counters[key] = self.counters.get(key, 0) + n


def span(name: str, device: Optional[torch.device] = None):
    """A context manager that records the host work inside it as the span
    ``name`` while a ``torch.profiler`` profile is recording; otherwise
    one flag read and a shared no-op context, which is false.

    On, the span is a host-only range on the profiler's own clock
    (``_RecordFunctionFast``, never ``record_function``, whose device-side
    mirror a device trace would count as device work), so it lands in the
    same trace as the kernels (``prof.export_chrome_trace``), and its
    entry adds to the process-wide aggregate of ``name`` (`span_stats`):
    its count, host seconds, host self seconds (less the time of the spans
    opened inside it on the same thread) and the counters the body adds
    through the context's ``count(key, n)`` (a no-op when off).

    ``device``: a CUDA device also records a timing event on its current
    stream at entry and at exit; the span's device seconds are the
    stream's time between them, which holds idle time too where the
    stream runs dry inside the span.  The events are held until
    `span_stats` or `reset_spans`.  A CPU device records none.
    """
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    index = None
    if device is not None and device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
    return _Span(name, index)


def span_stats() -> Dict[str, dict]:
    """The aggregates recorded since the last `reset_spans`, by span name:
    ``{"count", "host_s", "self_s", "device_s", "counters"}`` (seconds;
    ``device_s`` None for a span that recorded no device time).  Reads
    the device spans' pending events, which waits for them: call it after
    the device work is done (``torch.cuda.synchronize()``)."""
    with _LOCK:
        _resolve()
        return {name: {"count": a.count, "host_s": a.host_s,
                       "self_s": a.self_s, "device_s": a.device_s,
                       "counters": dict(a.counters)}
                for name, a in _AGGS.items()}


def reset_spans() -> None:
    """Forget every aggregate and pending device span."""
    with _LOCK:
        for _, index, e0, e1 in _PENDING:
            _EVENTS.setdefault(index, []).extend((e0, e1))
        _PENDING.clear()
        _AGGS.clear()
