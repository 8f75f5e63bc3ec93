"""Admission control for the serving runtime (DESIGN.md §13).

A copy of ``repro.launch.admission`` (the port imports nothing of the
JAX package): the same verdicts, order and ``stats()``.

The paper's user-facing (eps, delta) knob is also the system's *overload*
lever: unlike index-based MIPS (whose accuracy is frozen into the index),
BoundedME can re-calibrate per dispatch, so a saturated server can shed
**quality** — provably, inside the contract — before it sheds
**availability**.  This module holds the policy half of that story:

  * :class:`PriorityClass` — a named traffic class with a scheduling
    priority and a per-request completion deadline;
  * :class:`ServeResult` — the typed terminal outcome of every request.
    The runtime *never* raises on bad input or overload: a request ends
    as exactly one of ``ok`` / ``degraded`` / ``rejected`` /
    ``overloaded`` / ``failed``, always carrying the (eps, delta) it was
    actually served under (``eps_served``);
  * :class:`AdmissionController` — a bounded priority queue with
    poison-query validation (NaN/Inf/wrong-dim rejected at the door),
    a quarantine of fingerprints that previously broke a dispatch,
    displacement of lower-priority work when a full queue meets a more
    urgent request, and deadline expiry at batch-assembly time;
  * :class:`DegradationLadder` — the load -> eps policy: a precompiled
    ladder of (eps) rungs from the contract eps up to a configured
    ``eps_floor``; queue pressure picks the rung, so overload first
    relaxes accuracy toward the floor and only then rejects.

Everything here is host-side policy with no torch dependency — the
scheduler/executor halves live in `repro_torch.launch.engine`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry

__all__ = [
    "STATUSES", "PriorityClass", "ServeResult", "Ticket",
    "AdmissionController", "DegradationLadder", "DeficitRoundRobin",
]

#: The closed set of terminal request outcomes.  ``ok`` and ``degraded``
#: carry answers (degraded = served under a relaxed eps, recorded in
#: ``eps_served``); the other three are typed refusals, never exceptions.
STATUSES = ("ok", "degraded", "rejected", "overloaded", "failed")


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """A named traffic class: scheduling priority + completion deadline.

    ``priority`` orders batch assembly (lower = more urgent; FIFO within
    a class).  ``deadline_ms`` is the per-request completion budget from
    submit time: a request still queued past it is shed with a typed
    ``overloaded`` result instead of serving an answer nobody is waiting
    for.  ``sheddable=False`` exempts the class from displacement when
    the queue is full (it can still expire on its own deadline).
    """

    name: str
    priority: int = 1
    deadline_ms: float = 50.0
    sheddable: bool = True

    @property
    def deadline_s(self) -> float:
        """The deadline budget in seconds (``inf`` when non-positive)."""
        return self.deadline_ms * 1e-3 if self.deadline_ms > 0 else math.inf


@dataclasses.dataclass
class ServeResult:
    """Typed terminal outcome of one request (DESIGN.md §13 failure model).

    ``status`` is one of `STATUSES`.  ``ids``/``scores`` are set iff the
    request was answered (``ok`` or ``degraded``); ``eps_served`` /
    ``delta_served`` record the contract the answer actually met —
    ``eps_served > eps`` marks graceful degradation under load, never
    silently.  ``reason`` explains refusals (``poison: ...``,
    ``queue full``, ``deadline``, ``quarantined``, dispatch error text);
    ``retries`` counts dispatch retries this request rode through.
    """

    status: str
    ids: Optional[np.ndarray] = None
    scores: Optional[np.ndarray] = None
    eps_served: Optional[float] = None
    delta_served: Optional[float] = None
    reason: str = ""
    cls: str = "default"
    latency_s: float = 0.0
    retries: int = 0
    cached: bool = False
    #: which tenant's table served this request ("" on the single-table
    #: runtimes; set by `repro_torch.launch.tenancy.MultiTenantRuntime`)
    tenant: str = ""

    @property
    def answered(self) -> bool:
        """True iff this outcome carries (ids, scores) meeting a contract."""
        return self.status in ("ok", "degraded")


@dataclasses.dataclass
class Ticket:
    """One admitted request waiting in the queue."""

    req_id: int
    q: np.ndarray
    cls: PriorityClass
    t_submit: float
    t_deadline: float
    cache_key: Optional[bytes]
    fingerprint: bytes


def _fingerprint(q: np.ndarray) -> bytes:
    """Stable 16-byte digest of a query's exact float32 bytes."""
    return hashlib.blake2b(np.ascontiguousarray(q, np.float32).tobytes(),
                           digest_size=16).digest()


class AdmissionController:
    """Bounded priority queue + request validation + quarantine.

    The runtime's front door (DESIGN.md §13): every query passes
    `validate` (shape / dtype / finiteness — poison queries are rejected
    here, before they can reach a kernel), then the quarantine check
    (fingerprints that previously broke a dispatch are refused outright),
    then capacity admission.  A full queue refuses with a typed
    ``overloaded`` result — or, when the incoming request outranks queued
    sheddable work, displaces the lowest-priority youngest victim
    instead.  `take` assembles dispatch batches in (priority, FIFO)
    order and expires tickets whose class deadline already passed.

    All methods are O(log depth); no torch, no clock reads (callers pass
    ``now`` explicitly, so virtual-clock simulation is exact).
    """

    def __init__(self, dim: int, *, queue_capacity: int = 64,
                 classes: Optional[Dict[str, PriorityClass]] = None,
                 default_class: str = "default",
                 quarantine_capacity: int = 256,
                 metrics: Optional[MetricsRegistry] = None):
        if queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1, "
                             f"got {queue_capacity}")
        self.dim = int(dim)
        self.queue_capacity = int(queue_capacity)
        self.classes = dict(classes) if classes else {}
        if default_class not in self.classes:
            self.classes[default_class] = PriorityClass(default_class)
        self.default_class = default_class
        self._heap: List[Tuple[int, float, int, Ticket]] = []
        self._seq = 0
        self._quarantine: "OrderedDict[bytes, str]" = OrderedDict()
        self.quarantine_capacity = int(quarantine_capacity)
        self.peak_depth = 0
        self._depth_sum = 0.0
        self._depth_samples = 0
        # counters live on the obs registry (shared with the runtime when
        # it passes its own); the legacy n_* attributes read through
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_admitted = m.counter(
            "admission_admitted_total", "Tickets enqueued.")
        self._c_rejected = m.counter(
            "admission_rejected_total",
            "Requests refused at the door, by reason.", ("reason",))
        self._c_rejected.seed(reason="poison")
        self._c_rejected.seed(reason="quarantined")
        self._c_overloaded = m.counter(
            "admission_overloaded_total",
            "Requests refused because the queue was full.")
        self._c_displaced = m.counter(
            "admission_displaced_total",
            "Queued sheddable tickets evicted for higher-priority work.")
        self._c_expired = m.counter(
            "admission_expired_total",
            "Tickets shed at batch assembly past their class deadline.")
        g = m.gauge("admission_queue_depth",
                    "Tickets currently queued.")
        g.set_fn(lambda: len(self._heap))
        g = m.gauge("admission_peak_depth",
                    "High-water mark of the queue depth.")
        g.set_fn(lambda: self.peak_depth)
        g = m.gauge("admission_quarantine_entries",
                    "Fingerprints currently quarantined.")
        g.set_fn(lambda: len(self._quarantine))

    # ---- legacy counter surface (registry-backed) ------------------------

    @property
    def n_admitted(self) -> int:
        """Tickets enqueued."""
        return int(self._c_admitted.total())

    @property
    def n_rejected_poison(self) -> int:
        """Poison (NaN/Inf/shape) rejections (see `count_poison`)."""
        return int(self._c_rejected.get(reason="poison"))

    @property
    def n_rejected_quarantined(self) -> int:
        """Quarantine-hit rejections."""
        return int(self._c_rejected.get(reason="quarantined"))

    @property
    def n_overloaded(self) -> int:
        """Full-queue refusals (no displaceable victim)."""
        return int(self._c_overloaded.total())

    @property
    def n_displaced(self) -> int:
        """Queued tickets evicted by higher-priority arrivals."""
        return int(self._c_displaced.total())

    @property
    def n_expired(self) -> int:
        """Tickets shed past their deadline at batch assembly."""
        return int(self._c_expired.total())

    def count_poison(self) -> None:
        """Count one poison rejection.

        `validate` classifies but doesn't count — the runtime decides
        what a failed validation *means* (it may not even be a request),
        so it calls this when it actually refuses one.
        """
        self._c_rejected.inc(reason="poison")

    # ---- validation / quarantine ----------------------------------------

    def validate(self, q) -> Tuple[Optional[np.ndarray], str]:
        """Coerce one query to (dim,) float32; returns ``(q, "")`` or
        ``(None, reason)`` for poison input (wrong shape / dtype /
        NaN / Inf).  Rejection happens here, at admission — a poison
        query must never reach a dispatch, where its NaNs would poison
        every lane of the micro-batch."""
        try:
            arr = np.asarray(q, np.float32)
        except (TypeError, ValueError):
            return None, "poison: not castable to float32"
        if arr.shape != (self.dim,):
            return None, (f"poison: query shape {arr.shape} != "
                          f"({self.dim},)")
        if not np.all(np.isfinite(arr)):
            return None, "poison: non-finite (NaN/Inf) coordinates"
        return arr, ""

    def quarantined(self, fingerprint: bytes) -> Optional[str]:
        """The quarantine reason for a fingerprint, or None."""
        return self._quarantine.get(fingerprint)

    def add_quarantine(self, fingerprint: bytes, reason: str) -> None:
        """Quarantine a query fingerprint (bounded LRU of offenders).

        Called by the runtime when a dispatch containing this query
        failed past its retry budget: resubmissions of the same bytes
        are refused at admission instead of re-breaking dispatches.
        """
        self._quarantine[fingerprint] = reason
        self._quarantine.move_to_end(fingerprint)
        while len(self._quarantine) > self.quarantine_capacity:
            self._quarantine.popitem(last=False)

    @staticmethod
    def fingerprint(q: np.ndarray) -> bytes:
        """Stable digest used for quarantine identity (exact bytes)."""
        return _fingerprint(q)

    # ---- queue -----------------------------------------------------------

    @property
    def depth(self) -> int:
        """Requests currently queued (admitted, not yet dispatched)."""
        return len(self._heap)

    def resolve_class(self, cls: Optional[str]) -> PriorityClass:
        """Look up a class by name (None = the default class)."""
        name = self.default_class if cls is None else cls
        try:
            return self.classes[name]
        except KeyError:
            raise KeyError(
                f"unknown priority class {name!r}; configured: "
                f"{sorted(self.classes)}") from None

    def admit(self, ticket: Ticket) -> Tuple[
            Optional[ServeResult], List[Tuple[Ticket, ServeResult]]]:
        """Try to enqueue a validated ticket.

        Returns ``(verdict, displaced)``: ``verdict`` is None on success
        or a typed ``rejected``/``overloaded`` `ServeResult`; ``displaced``
        lists (ticket, overloaded-result) pairs for queued lower-priority
        work evicted to make room.  Quarantined fingerprints are refused
        here; capacity refusal prefers displacing the *lowest-priority,
        youngest* sheddable victim when the incoming request strictly
        outranks it.
        """
        reason = self.quarantined(ticket.fingerprint)
        if reason is not None:
            self._c_rejected.inc(reason="quarantined")
            return ServeResult(status="rejected", cls=ticket.cls.name,
                               reason=f"quarantined: {reason}"), []
        displaced: List[Tuple[Ticket, ServeResult]] = []
        if len(self._heap) >= self.queue_capacity:
            victim_i = None
            for i, (pri, t_sub, seq, tk) in enumerate(self._heap):
                if not tk.cls.sheddable or pri <= ticket.cls.priority:
                    continue
                if victim_i is None:
                    victim_i = i
                    continue
                vp, vt, vs, _ = self._heap[victim_i]
                if (pri, t_sub, seq) > (vp, vt, vs):
                    victim_i = i
            if victim_i is None:
                self._c_overloaded.inc()
                return ServeResult(
                    status="overloaded", cls=ticket.cls.name,
                    reason=f"queue full ({self.queue_capacity})"), []
            _, _, _, victim = self._heap.pop(victim_i)
            heapq.heapify(self._heap)
            self._c_displaced.inc()
            displaced.append((victim, ServeResult(
                status="overloaded", cls=victim.cls.name,
                reason="displaced by higher-priority request")))
        heapq.heappush(self._heap, (ticket.cls.priority, ticket.t_submit,
                                    self._seq, ticket))
        self._seq += 1
        self._c_admitted.inc()
        self.peak_depth = max(self.peak_depth, len(self._heap))
        return None, displaced

    def oldest_submit(self) -> Optional[float]:
        """Earliest ``t_submit`` among queued tickets (None when empty)."""
        if not self._heap:
            return None
        return min(item[1] for item in self._heap)

    def take(self, now: float, max_n: int, *, expire: bool = True) -> Tuple[
            List[Ticket], List[Tuple[Ticket, ServeResult]]]:
        """Pop up to ``max_n`` tickets in (priority, FIFO) order.

        Tickets whose class deadline has already passed are *expired*
        instead (typed ``overloaded`` with ``reason='deadline'``) — the
        lane is better spent on a request someone is still waiting for.
        ``expire=False`` (shutdown drain) serves them anyway.  Returns
        ``(batch, expired)``.
        """
        batch: List[Ticket] = []
        expired: List[Tuple[Ticket, ServeResult]] = []
        while self._heap and len(batch) < max_n:
            _, _, _, tk = heapq.heappop(self._heap)
            if expire and now > tk.t_deadline:
                self._c_expired.inc()
                expired.append((tk, ServeResult(
                    status="overloaded", cls=tk.cls.name,
                    reason="deadline",
                    latency_s=now - tk.t_submit)))
                continue
            batch.append(tk)
        self._depth_sum += len(self._heap)
        self._depth_samples += 1
        return batch, expired

    def load(self) -> float:
        """Queue pressure in [0, 1+]: depth / capacity."""
        return len(self._heap) / self.queue_capacity

    def stats(self) -> dict:
        """Admission counters + queue depth telemetry as a plain dict."""
        return {
            "depth": len(self._heap),
            "capacity": self.queue_capacity,
            "peak_depth": self.peak_depth,
            "mean_depth_at_dispatch": (
                self._depth_sum / self._depth_samples
                if self._depth_samples else 0.0),
            "admitted": self.n_admitted,
            "rejected_poison": self.n_rejected_poison,
            "rejected_quarantined": self.n_rejected_quarantined,
            "overloaded": self.n_overloaded,
            "displaced": self.n_displaced,
            "expired_deadline": self.n_expired,
            "quarantine_entries": len(self._quarantine),
        }


class DegradationLadder:
    """Load -> eps policy: relax accuracy toward a floor before refusing.

    Precomputes ``rungs`` eps values geometrically interpolated from the
    contract ``eps`` (rung 0) up to ``eps_floor`` (the worst accuracy the
    operator will serve; DESIGN.md §13 degradation ladder).  `rung(load)`
    maps queue pressure to a rung: below ``start`` load the ladder stays
    at rung 0 (full quality); between ``start`` and 1.0 it climbs
    linearly; at/above full queue it serves the floor.  The runtime
    compiles one executor per rung, so switching rungs costs nothing at
    dispatch time, and each response records its actual ``eps_served`` —
    degradation is always visible, never silent.
    """

    def __init__(self, eps: float, eps_floor: Optional[float] = None, *,
                 rungs: int = 3, start: float = 0.5):
        if eps_floor is None:
            eps_floor = eps
        if eps_floor < eps:
            raise ValueError(
                f"eps_floor ({eps_floor}) must be >= eps ({eps}): "
                f"degradation relaxes eps toward the floor, it cannot "
                f"tighten it")
        if not 0.0 < start <= 1.0:
            raise ValueError(f"start must be in (0, 1], got {start}")
        rungs = max(1, int(rungs))
        if eps_floor == eps:
            rungs = 1
        if rungs == 1:
            self.eps_values = [float(eps)]
        else:
            # geometric interpolation: early rungs give up little
            # accuracy, the last rung lands exactly on the floor
            ratio = (eps_floor / eps) ** (1.0 / (rungs - 1))
            self.eps_values = [float(eps * ratio ** i)
                               for i in range(rungs)]
            self.eps_values[-1] = float(eps_floor)
        self.eps = float(eps)
        self.eps_floor = float(eps_floor)
        self.start = float(start)

    @property
    def n_rungs(self) -> int:
        """Number of rungs (1 = degradation disabled)."""
        return len(self.eps_values)

    def rung(self, load: float) -> int:
        """Map queue pressure (depth/capacity) to a ladder rung index."""
        if self.n_rungs == 1 or load < self.start:
            return 0
        if load >= 1.0:
            return self.n_rungs - 1
        frac = (load - self.start) / (1.0 - self.start)
        return min(self.n_rungs - 1, 1 + int(frac * (self.n_rungs - 1)))


class DeficitRoundRobin:
    """Deficit-round-robin service allocator for cross-tenant fairness.

    Classic DRR (Shreedhar & Varghese) over named flows: each round, a
    *backlogged* flow's deficit grows by ``quantum * weight`` (capped at
    ``cap_rounds`` rounds' worth so an intermittently-backlogged flow
    cannot hoard service credit), and the flow may serve work costing up
    to its current deficit.  A flow whose queue empties forfeits its
    remaining deficit (`reset`) — credit never survives idleness, which is
    what bounds any flow's burst to O(quantum) over fair share.  The
    service order rotates one flow per round so ties break fairly.

    The multi-tenant runtime uses request count as the cost unit with
    ``quantum = lanes``: with every tenant backlogged, each gets about
    one full dispatch per round regardless of arrival-rate skew — an
    8x-hot tenant is throttled to its share instead of starving the
    rest, and an idle tenant costs nothing (work-conserving).

    Host-side policy only; no clock, no torch.
    """

    def __init__(self, quantum: float, *, cap_rounds: float = 2.0):
        if quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        if cap_rounds < 1.0:
            raise ValueError(f"cap_rounds must be >= 1, got {cap_rounds}")
        self.quantum = float(quantum)
        self.cap_rounds = float(cap_rounds)
        self._order: List[str] = []
        self._weight: Dict[str, float] = {}
        self._deficit: Dict[str, float] = {}

    def add_flow(self, name: str, weight: float = 1.0) -> None:
        """Register a flow at ``weight`` x the base quantum (idempotent;
        re-adding updates the weight, keeps the deficit)."""
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        if name not in self._weight:
            self._order.append(name)
            self._deficit[name] = 0.0
        self._weight[name] = float(weight)

    def remove_flow(self, name: str) -> None:
        """Drop a flow and its deficit (no-op if unknown)."""
        if name in self._weight:
            self._order.remove(name)
            del self._weight[name]
            del self._deficit[name]

    def flows(self) -> List[str]:
        """Current service order (rotates one step per `rotate`)."""
        return list(self._order)

    def start_round(self, backlogged: Dict[str, bool]) -> None:
        """Grant each backlogged flow its per-round quantum (capped)."""
        for name in self._order:
            if backlogged.get(name, False):
                w = self._weight[name]
                self._deficit[name] = min(
                    self._deficit[name] + self.quantum * w,
                    self.cap_rounds * self.quantum * w)

    def allowance(self, name: str) -> int:
        """Whole service units the flow may consume right now."""
        return int(self._deficit[name])

    def consume(self, name: str, cost: float) -> None:
        """Charge served work against the flow's deficit."""
        self._deficit[name] = max(0.0, self._deficit[name] - float(cost))

    def reset(self, name: str) -> None:
        """Forfeit a now-idle flow's deficit (credit never survives
        idleness — the DRR burst bound depends on this)."""
        self._deficit[name] = 0.0

    def rotate(self) -> None:
        """Advance the service order by one flow (fair tie-breaking)."""
        if len(self._order) > 1:
            self._order.append(self._order.pop(0))
