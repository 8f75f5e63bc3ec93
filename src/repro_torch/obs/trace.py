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
"""

from __future__ import annotations

import json
from collections import deque
from typing import Dict, List, Optional

import numpy as np

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
