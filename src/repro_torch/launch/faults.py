"""Deterministic fault injection for the serving runtime (DESIGN.md §13).

A copy of ``repro.launch.faults`` (the port imports nothing of the JAX
package): the same seeded schedules, counters and ``stats()``, so a
given seed fails the same dispatches and the same store flushes in both
packages.

Robustness claims are worthless untested, and flaky fault tests are worse
than none — so every fault here is drawn from a *seeded, stateless
schedule*: the decision for dispatch ``i`` (or flush ``j``) is a pure
function of ``(seed, fault kind, index, attempt)``, independent of call
order, wall clock, or how many other fault kinds are enabled.  Two runs
with the same seed inject byte-identical fault sequences; CI can assert
exact counters.

Three fault surfaces, matching the runtime's three failure domains:

  * **latency spikes** — heavy-tailed extra seconds added to a
    dispatch's virtual compute time (the virtual clock makes the spike
    exact, not a sleep): exercises deadline expiry, queue growth and the
    degradation ladder;
  * **dispatch exceptions** — :class:`InjectedDispatchError` raised from
    inside the executor call: exercises retry-with-backoff and, past the
    retry budget, the fail-only-this-micro-batch path + quarantine;
  * **store-flush failures** — :class:`repro_torch.store.StoreFlushError`
    raised from the store's ``fault_hook`` before any staged mutation is
    applied: exercises the runtime's keep-serving-the-current-table path
    (the staged ops stay staged and retry at the next poll).

Attach with ``FaultInjector(...).attach(store)`` for the flush surface
and pass the injector to `repro_torch.launch.engine.ServeRuntime` for the
dispatch surfaces.  `stats()` exports exactly what was injected — plus,
per kind, how many decision points the schedule *saw* and the resulting
injection rates (``injected / seen``), so tests can reconcile observed
behaviour against the configured rates.  The same counters live on the
injector's `repro_torch.obs.metrics` registry (``faults_*``), which
`ServeRuntime` adopts into its own registry when the injector is
attached.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.store import StoreFlushError

__all__ = ["InjectedDispatchError", "FaultInjector"]

# stable per-kind stream ids: entropy never collides across fault kinds
_KIND_LATENCY = 1
_KIND_ERROR = 2
_KIND_FLUSH = 3
_ROOT = 0x5EED_FA17  # namespace tag so injector streams never alias
                     # other default_rng(seed) users in the process


class InjectedDispatchError(RuntimeError):
    """A dispatch exception injected by `FaultInjector` (never raised by
    real executor code; tests match on this type to distinguish injected
    faults from genuine regressions)."""


class FaultInjector:
    """Seeded, stateless fault schedule over dispatch/flush indices.

    Args:
      seed: the schedule seed — the *only* source of randomness.
      latency_rate: probability a dispatch gets a latency spike.
      latency_ms: spike scale; actual spikes are ``latency_ms * (1 + P)``
        with P ~ Pareto(``latency_tail``) — heavy-tailed, like real
        stragglers.
      latency_tail: Pareto tail index of the spike distribution (smaller
        = heavier tail).
      error_rate: probability a dispatch raises
        `InjectedDispatchError`.  When it fires, the first
        ``fail_attempts(i)`` attempts fail — usually 1 (a transient the
        retry absorbs); with probability ``persistent_rate`` the fault is
        persistent (fails every attempt, forcing the micro-batch-failure
        path).
      persistent_rate: fraction of injected dispatch errors that never
        stop failing (conditional on an error firing at all).
      flush_failure_rate: probability a store `flush_updates` call is
        failed (via the hook installed by `attach`).
      metrics: an existing `repro_torch.obs.metrics.MetricsRegistry` to file
        the ``faults_*`` metrics under (default: a private registry on
        ``self.metrics``, adopted by the runtime).

    Every decision method is pure in its index arguments; counters track
    what was actually *queried and fired* so `stats()` reconciles with
    runtime counters.
    """

    def __init__(self, seed: int = 0, *, latency_rate: float = 0.0,
                 latency_ms: float = 25.0, latency_tail: float = 1.5,
                 error_rate: float = 0.0, persistent_rate: float = 0.25,
                 flush_failure_rate: float = 0.0,
                 metrics: Optional[MetricsRegistry] = None):
        for name, rate in (("latency_rate", latency_rate),
                           ("error_rate", error_rate),
                           ("persistent_rate", persistent_rate),
                           ("flush_failure_rate", flush_failure_rate)):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        self.seed = int(seed)
        self.latency_rate = float(latency_rate)
        self.latency_ms = float(latency_ms)
        self.latency_tail = float(latency_tail)
        self.error_rate = float(error_rate)
        self.persistent_rate = float(persistent_rate)
        self.flush_failure_rate = float(flush_failure_rate)
        # exact seconds accumulator for the legacy latency stats — the
        # histogram buckets the same spikes in ms, but the stat contract
        # is the exact schedule sum in the schedule's own unit
        self._injected_latency_s = 0.0
        self._flush_idx = 0
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_injected = self.metrics.counter(
            "faults_injected_total", "Faults actually fired, by kind.",
            ("kind",))
        self._c_seen = self.metrics.counter(
            "faults_seen_total",
            "Injection decision points evaluated, by kind.", ("kind",))
        for k in ("latency", "error", "flush"):
            self._c_injected.seed(kind=k)
            self._c_seen.seed(kind=k)
        self._c_persistent = self.metrics.counter(
            "faults_persistent_errors_total",
            "Injected dispatch errors that outlast any retry budget.")
        self._c_error_dispatches = self.metrics.counter(
            "faults_error_dispatches_total",
            "Dispatches with at least one injected error attempt.")
        self._h_latency = self.metrics.histogram(
            "faults_injected_latency_ms",
            "Injected latency spike sizes (ms).")

    # ---- legacy counter surface (registry-backed) ------------------------

    @property
    def n_latency_injected(self) -> int:
        """Latency spikes fired by the schedule."""
        return int(self._c_injected.get(kind="latency"))

    @property
    def injected_latency_s(self) -> float:
        """Total injected spike seconds (exact schedule sum)."""
        return self._injected_latency_s

    @property
    def n_errors_injected(self) -> int:
        """Fired (dispatch, attempt) error injections."""
        return int(self._c_injected.get(kind="error"))

    @property
    def n_persistent_errors(self) -> int:
        """Dispatches given a persistent (retry-proof) error."""
        return int(self._c_persistent.total())

    @property
    def n_flush_failures(self) -> int:
        """Store flush_updates calls failed by the hook."""
        return int(self._c_injected.get(kind="flush"))

    def _rng(self, kind: int, index: int) -> np.random.Generator:
        """The stateless per-(kind, index) generator of the schedule."""
        return np.random.default_rng(
            np.random.SeedSequence([_ROOT, self.seed, kind, int(index)]))

    # ---- dispatch surfaces ----------------------------------------------

    def latency_s(self, dispatch_idx: int) -> float:
        """Extra virtual seconds injected into dispatch ``dispatch_idx``
        (0.0 when the schedule doesn't spike it)."""
        self._c_seen.inc(kind="latency")
        if self.latency_rate <= 0.0:
            return 0.0
        rng = self._rng(_KIND_LATENCY, dispatch_idx)
        if rng.random() >= self.latency_rate:
            return 0.0
        spike = self.latency_ms * 1e-3 * (1.0 + rng.pareto(
            self.latency_tail))
        self._c_injected.inc(kind="latency")
        self._injected_latency_s += spike
        self._h_latency.observe(spike * 1e3)
        return float(spike)

    def fail_attempts(self, dispatch_idx: int) -> int:
        """How many leading attempts of dispatch ``dispatch_idx`` fail.

        0 = no injected error; 1..2 = transient (a retry will clear it);
        a large value (persistent fault) outlasts any retry budget.
        Pure in ``dispatch_idx`` — querying it twice is free.
        """
        if self.error_rate <= 0.0:
            return 0
        rng = self._rng(_KIND_ERROR, dispatch_idx)
        if rng.random() >= self.error_rate:
            return 0
        if rng.random() < self.persistent_rate:
            return 1_000_000           # outlasts any sane retry budget
        return int(rng.integers(1, 3))  # transient: 1-2 failing attempts

    def dispatch_error(self, dispatch_idx: int,
                       attempt: int = 0) -> Optional[InjectedDispatchError]:
        """The error to raise for (dispatch, attempt), or None.

        Counts each fired (dispatch, attempt) injection once; the
        persistent counter increments on the first attempt only, and the
        per-kind ``seen`` counter counts each *dispatch* once (attempt 0).
        """
        if attempt == 0:
            self._c_seen.inc(kind="error")
        fails = self.fail_attempts(dispatch_idx)
        if attempt == 0 and fails > 0:
            self._c_error_dispatches.inc()
        if attempt >= fails:
            return None
        self._c_injected.inc(kind="error")
        if fails > 2 and attempt == 0:
            self._c_persistent.inc()
        kind = "persistent" if fails > 2 else "transient"
        return InjectedDispatchError(
            f"injected {kind} dispatch fault "
            f"(dispatch={dispatch_idx}, attempt={attempt})")

    # ---- store-flush surface --------------------------------------------

    def attach(self, store) -> None:
        """Install this injector as ``store.fault_hook`` (a
        `repro_torch.store.DynamicTableStore` or `ShardedTableStore`).

        The store calls the hook at the top of every `flush_updates`,
        *before* taking staged mutations — a failed flush leaves the
        staged queue intact, so the engine retries it at its next poll.
        Flush ``j`` (counted per hook call) fails by the stateless
        per-(seed, flush) draw, as in the JAX package.
        """
        store.fault_hook = self._flush_hook

    def _flush_hook(self) -> None:
        idx, self._flush_idx = self._flush_idx, self._flush_idx + 1
        self._c_seen.inc(kind="flush")
        if self.flush_failure_rate <= 0.0:
            return
        rng = self._rng(_KIND_FLUSH, idx)
        if rng.random() < self.flush_failure_rate:
            self._c_injected.inc(kind="flush")
            raise StoreFlushError(
                f"injected store flush failure (flush={idx})")

    # ---- observability ---------------------------------------------------

    def stats(self) -> dict:
        """What the schedule injected, saw, and the realized rates.

        The legacy keys are unchanged (``injected_latency_ms`` is
        milliseconds — the same unit as the
        `repro_torch.obs.metrics.LATENCY_BUCKETS_MS` histogram buckets);
        ``seen`` counts decision points per kind (dispatches for
        latency/error, flush calls for flush) and ``rates`` is
        ``injected / seen`` — the *realized* per-kind injection rate to
        reconcile against the configured probabilities.
        """
        seen = {k: int(self._c_seen.get(kind=k))
                for k in ("latency", "error", "flush")}
        fired = {"latency": self.n_latency_injected,
                 # rate denominators are dispatches/flushes, so the error
                 # numerator counts dispatches with >= 1 injected attempt
                 # (n_errors_injected counts per-attempt firings)
                 "error": int(self._c_error_dispatches.total()),
                 "flush": self.n_flush_failures}
        return {
            "seed": self.seed,
            "latency_spikes": self.n_latency_injected,
            "injected_latency_ms": self._injected_latency_s * 1e3,
            "dispatch_errors": self.n_errors_injected,
            "persistent_errors": self.n_persistent_errors,
            "flush_failures": self.n_flush_failures,
            "seen": seen,
            "rates": {k: (fired[k] / seen[k] if seen[k] else 0.0)
                      for k in ("latency", "error", "flush")},
        }
