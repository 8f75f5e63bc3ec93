"""Typed metrics registry for the serving stack.

A copy of ``repro.obs.metrics`` (the port imports nothing of the JAX
package), without its no-op registry.  Three metric kinds —
:class:`Counter` (monotone), :class:`Gauge` (last-write or
callback-backed), :class:`Histogram` (fixed buckets, cumulative counts +
sum) — held in a :class:`MetricsRegistry` keyed by metric name.  Metrics
are *labeled*: one metric object fans out into label rows (e.g.
``serve_batches_total{trigger="full"}``).  Exports are JSON
(:meth:`MetricsRegistry.snapshot`) and Prometheus text exposition format
(:meth:`MetricsRegistry.render_prometheus`) — no client libraries.

Bucket layouts are fixed so runs are comparable across PRs:
``LATENCY_BUCKETS_MS`` is log-scale 0.1 ms .. 2.5 s, ``PULL_BUCKETS``
log4 64 .. 1M pulls, ``PULL_FRAC_BUCKETS`` linear-in-eighths pull
fractions (pulls / budget) used by TUNING.md to pick ``adaptive`` vs
``bound``.
"""

from __future__ import annotations

import bisect
import json
import math
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

#: log-scale latency buckets in milliseconds (upper bounds; +Inf implied).
#: 1-2.5-5 decades from 100us to 2.5s — spans a cache hit (~0.1ms) to a
#: blown 200ms deadline with a Pareto latency spike on top.
LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0)

#: log4-scale pull-count buckets (upper bounds; +Inf implied) for
#: per-query sample-complexity histograms.
PULL_BUCKETS: Tuple[float, ...] = (
    64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0, 1048576.0)

#: linear pull-fraction buckets (pulls used / full-scan budget).  A mass
#: near 1.0 means the cascade degenerates to brute force — see TUNING.md.
PULL_FRAC_BUCKETS: Tuple[float, ...] = (
    0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _fmt(v: float) -> str:
    """Render a sample value the way Prometheus text format expects."""
    if v != v:                                     # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


class Metric:
    """Base class: a named, labeled family of sample rows.

    Subclasses define ``kind`` and the per-row cell shape.  Rows are
    keyed by the tuple of label *values* in declared label-key order and
    materialize on first touch, preserving insertion order (the legacy
    ``stats()`` dicts depend on first-seen ordering).
    """

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = ()) -> None:
        self.name = _check_name(name)
        self.help = help
        self.labels = tuple(labels)
        for lab in self.labels:
            if not _LABEL_RE.match(lab):
                raise ValueError(f"invalid label name {lab!r}")
        self._rows: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        if len(labels) != len(self.labels):
            raise ValueError(
                f"{self.name}: expected labels {self.labels}, "
                f"got {tuple(labels)}")
        try:
            return tuple(str(labels[k]) for k in self.labels)
        except KeyError as e:
            raise ValueError(
                f"{self.name}: expected labels {self.labels}, "
                f"got {tuple(labels)}") from e

    def rows(self) -> List[Tuple[Dict[str, str], object]]:
        """All materialized rows as ``(label_dict, cell)`` in first-seen
        order; gauge callbacks are resolved at call time."""
        out = []
        for key, cell in self._rows.items():
            out.append((dict(zip(self.labels, key)), self._resolve(cell)))
        return out

    def _resolve(self, cell: object) -> object:
        return cell


class Counter(Metric):
    """Monotonically increasing sum; negative increments are rejected."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        """Add ``amount`` (>= 0) to the row selected by ``labels``."""
        if amount < 0:
            raise ValueError(f"{self.name}: counter increment < 0")
        key = self._key(labels)
        self._rows[key] = self._rows.get(key, 0.0) + amount

    def seed(self, **labels: object) -> None:
        """Materialize a row at 0 without incrementing (pins row order
        and makes never-hit outcomes render explicitly as 0)."""
        self._rows.setdefault(self._key(labels), 0.0)

    def get(self, **labels: object) -> float:
        """Current value of one row (0 if the row was never touched)."""
        return float(self._rows.get(self._key(labels), 0.0))

    def total(self) -> float:
        """Sum over all label rows."""
        return float(sum(self._rows.values()))


class Gauge(Metric):
    """Last-written value, or a zero-argument callback sampled on read.

    Callback gauges (:meth:`set_fn`) let live quantities — queue depth,
    store utilization, table version — export without the owner pushing
    updates on every mutation.
    """

    kind = "gauge"

    def set(self, value: float, **labels: object) -> None:
        """Write ``value`` to the row selected by ``labels``."""
        self._rows[self._key(labels)] = float(value)

    def set_fn(self, fn: Callable[[], float], **labels: object) -> None:
        """Back the row with ``fn``, called at snapshot/render time."""
        self._rows[self._key(labels)] = fn

    def get(self, **labels: object) -> float:
        """Current value of one row (callbacks are invoked)."""
        return float(self._resolve(self._rows.get(self._key(labels), 0.0)))

    def _resolve(self, cell: object) -> float:
        return float(cell()) if callable(cell) else float(cell)


class Histogram(Metric):
    """Fixed-bucket histogram: cumulative bucket counts, sum and count.

    Buckets are upper bounds; an implicit +Inf bucket catches the tail.
    The default layout is :data:`LATENCY_BUCKETS_MS`.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS_MS) -> None:
        super().__init__(name, help, labels)
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(set(bs)) or not math.isfinite(bs[-1]):
            raise ValueError(f"{name}: buckets must be finite, sorted, "
                             f"unique: {buckets!r}")
        self.buckets = bs

    def _cell(self, key: Tuple[str, ...]) -> dict:
        cell = self._rows.get(key)
        if cell is None:
            cell = {"counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            self._rows[key] = cell
        return cell

    def observe(self, value: float, **labels: object) -> None:
        """Record one observation into the row selected by ``labels``."""
        cell = self._cell(self._key(labels))
        cell["counts"][bisect.bisect_left(self.buckets, float(value))] += 1
        cell["sum"] += float(value)
        cell["count"] += 1

    def get(self, **labels: object) -> dict:
        """One row's cell: ``{"counts", "sum", "count"}`` (counts are
        per-bucket, not cumulative; +Inf bucket last)."""
        cell = self._cell(self._key(labels))
        return {"counts": list(cell["counts"]),
                "sum": float(cell["sum"]), "count": int(cell["count"])}

    def sum(self) -> float:
        """Sum of observed values over all label rows."""
        return float(sum(c["sum"] for c in self._rows.values()))

    def count(self) -> int:
        """Number of observations over all label rows."""
        return int(sum(c["count"] for c in self._rows.values()))


class MetricsRegistry:
    """Name-keyed collection of metrics with get-or-create semantics.

    Components deep in the stack (stores, the fault injector) create
    their own private registry; composite owners (``MIPSServeEngine``,
    ``ServeRuntime``) :meth:`adopt` those so one :meth:`snapshot` /
    :meth:`render_prometheus` call exports the whole stack.  Get-or-create
    (:meth:`counter` / :meth:`gauge` / :meth:`histogram`) lets the four
    degradation-ladder executors share one labeled metric family instead
    of colliding on registration.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self) -> Iterable[Metric]:
        return iter(self._metrics.values())

    def get(self, name: str) -> Optional[Metric]:
        """The metric registered under ``name``, or None."""
        return self._metrics.get(name)

    def _get_or_create(self, cls: type, name: str, help: str,
                       labels: Sequence[str], **kw: object) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, labels, **kw)
            self._metrics[name] = m
            return m
        if not isinstance(m, cls) or m.labels != tuple(labels):
            raise ValueError(
                f"metric {name!r} re-registered with kind/labels "
                f"({cls.__name__}, {tuple(labels)}) != "
                f"({type(m).__name__}, {m.labels})")
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        """Get or create a :class:`Counter`."""
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        """Get or create a :class:`Gauge`."""
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS
                  ) -> Histogram:
        """Get or create a :class:`Histogram` (bucket layout must match
        on reuse)."""
        h = self._get_or_create(Histogram, name, help, labels,
                                buckets=buckets)
        if h.buckets != tuple(float(b) for b in buckets):
            raise ValueError(f"metric {name!r} re-registered with "
                             f"different buckets")
        return h

    def adopt(self, other: "MetricsRegistry") -> None:
        """Merge ``other``'s metrics into this registry by reference.

        Name collisions must agree on kind and labels; the colliding
        family is then shared (both owners increment the same rows).
        Adopting a registry twice is a no-op.
        """
        if other is self:
            return
        for name, m in other._metrics.items():
            mine = self._metrics.get(name)
            if mine is None:
                self._metrics[name] = m
            elif mine is not m:
                raise ValueError(
                    f"adopt(): metric {name!r} exists in both registries "
                    f"as distinct objects")

    def label_values(self, name: str, label: str) -> List[str]:
        """Distinct values a label key has taken on one metric family.

        First-seen row order, empty when the metric is absent or the
        family has no such label key.  The tenancy layer uses this to
        assert per-tenant coverage of its labeled families (e.g. every
        registered tenant appears in ``tenancy_serve_requests_total``)
        without parsing an exposition dump.
        """
        m = self._metrics.get(name)
        if m is None or label not in m.labels:
            return []
        seen: List[str] = []
        for labels, _ in m.rows():
            v = labels[label]
            if v not in seen:
                seen.append(v)
        return seen

    # ---- export ---------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable snapshot of every metric and row.

        Shape: ``{"metrics": [{"name", "kind", "help", "labels",
        "buckets"?, "values": [{"labels": {...}, "value" | "counts"/
        "sum"/"count"}]}]}`` in registration/row insertion order.
        """
        out = []
        for m in self._metrics.values():
            entry: dict = {"name": m.name, "kind": m.kind, "help": m.help,
                           "labels": list(m.labels)}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
            vals = []
            for labels, cell in m.rows():
                row: dict = {"labels": labels}
                if isinstance(m, Histogram):
                    row.update(counts=list(cell["counts"]),
                               sum=cell["sum"], count=cell["count"])
                else:
                    row["value"] = cell
                vals.append(row)
            entry["values"] = vals
            out.append(entry)
        return {"metrics": out}

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4) for every metric.

        Histograms render cumulative ``_bucket{le=...}`` rows plus
        ``_sum`` / ``_count``; rows appear in insertion order.
        """
        lines: List[str] = []
        for m in self._metrics.values():
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for labels, cell in m.rows():
                if isinstance(m, Histogram):
                    cum = 0
                    for ub, c in zip(list(m.buckets) + [float("inf")],
                                     cell["counts"]):
                        cum += c
                        lab = dict(labels)
                        lab["le"] = _fmt(ub)
                        lines.append(f"{m.name}_bucket{_labelstr(lab)} "
                                     f"{cum}")
                    lines.append(f"{m.name}_sum{_labelstr(labels)} "
                                 f"{_fmt(cell['sum'])}")
                    lines.append(f"{m.name}_count{_labelstr(labels)} "
                                 f"{cell['count']}")
                else:
                    lines.append(
                        f"{m.name}{_labelstr(labels)} {_fmt(cell)}")
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> None:
        """Write the snapshot to ``path``: Prometheus text if the path
        ends in ``.prom`` / ``.txt``, JSON otherwise."""
        if path.endswith((".prom", ".txt")):
            payload = self.render_prometheus()
        else:
            payload = json.dumps(self.snapshot(), indent=1)
        with open(path, "w") as f:
            f.write(payload)


def _labelstr(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels.items())
    return "{" + inner + "}"


def summarize_latencies(lat_s: Sequence[float],
                        keys: Sequence[str] = ("mean", "p50", "p95",
                                               "p99", "max")) -> dict:
    """Latency summary in milliseconds from per-request seconds.

    The single percentile helper for the whole repo (deduplicates the
    engine/runtime/benchmark copies).  Semantics pinned by
    ``tests/test_obs.py``: percentiles are ``np.percentile`` with linear
    interpolation over ``lat_s * 1e3``; an empty input yields all-zero
    entries.  ``keys`` selects and orders the output (the micro-batching
    engine's legacy surface is ``("mean", "p50", "p95", "max")``).
    """
    known = ("mean", "p50", "p95", "p99", "max")
    bad = [k for k in keys if k not in known]
    if bad:
        raise ValueError(f"unknown latency summary keys {bad!r}")
    if len(lat_s) == 0:
        full = {k: 0.0 for k in known}
    else:
        lat = np.asarray(lat_s, dtype=np.float64) * 1e3
        full = {
            "mean": float(lat.mean()),
            "p50": float(np.percentile(lat, 50)),
            "p95": float(np.percentile(lat, 95)),
            "p99": float(np.percentile(lat, 99)),
            "max": float(lat.max()),
        }
    return {k: full[k] for k in keys}
