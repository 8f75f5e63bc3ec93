"""Crash flight recorder: a ring buffer of structured serving events.

A copy of ``repro.obs.flight`` (the port imports nothing of the JAX
package); its dumps are byte-equal to the reference's for the same
events.

:class:`FlightRecorder` keeps the last ``capacity`` structured events —
admissions, displacements, quarantines, fault injections,
recalibrations, codebook refreshes, store flushes — and dumps them to a
JSON file when something goes wrong (a request terminates ``failed`` or
a store flush raises), so post-mortems of fault-injection runs no longer
require rerunning with prints.

Each event is ``{"seq", "t", "kind", ...fields}``: a monotone sequence
number (survives wraparound, so dumps show how much history was lost),
the virtual-clock timestamp (None for events without one, e.g.
store-internal flushes), the event kind, and kind-specific fields.  The
dump payload is ``{"reason", "t", "seq", "capacity", "n_recorded",
"n_dumps", "events"}``; see docs/OBSERVABILITY.md for the schema and the
kind catalog.
"""

from __future__ import annotations

import json
from collections import deque
from typing import List, Optional


class FlightRecorder:
    """Fixed-size ring of structured events with dump-to-JSON-on-failure.

    ``path`` is the default dump destination; each dump overwrites it
    (the *latest* failure context wins — post-mortems care about the
    most recent crash).  With no path configured, :meth:`dump` is a
    no-op returning None, so instrumentation can call it unconditionally.
    """

    def __init__(self, capacity: int = 256,
                 path: Optional[str] = None) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.path = path
        self._buf: deque = deque(maxlen=self.capacity)
        self.n_recorded = 0      #: total events ever recorded
        self.n_dumps = 0         #: dumps actually written

    def record(self, kind: str, t: Optional[float] = None,
               **fields: object) -> None:
        """Append one event (evicting the oldest past ``capacity``)."""
        self.n_recorded += 1
        ev = {"seq": self.n_recorded,
              "t": None if t is None else float(t), "kind": str(kind)}
        ev.update(fields)
        self._buf.append(ev)

    def events(self) -> List[dict]:
        """The retained events, oldest first."""
        return list(self._buf)

    def dump(self, reason: str, t: Optional[float] = None,
             path: Optional[str] = None) -> Optional[str]:
        """Write the ring to ``path`` (or the configured default).

        Returns the path written, or None when no destination is
        configured.  The payload embeds ``reason`` (e.g.
        ``"request_failed"``, ``"store_flush_error"``) and the dump-time
        virtual clock ``t``.
        """
        dest = path or self.path
        if dest is None:
            return None
        payload = {
            "reason": str(reason),
            "t": None if t is None else float(t),
            "seq": self.n_recorded,
            "capacity": self.capacity,
            "n_recorded": self.n_recorded,
            "n_dumps": self.n_dumps + 1,
            "events": self.events(),
        }
        with open(dest, "w") as f:
            json.dump(payload, f, indent=1)
        self.n_dumps += 1
        return dest
