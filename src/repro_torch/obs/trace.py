"""Request-lifecycle tracing with Chrome-trace JSON export (a port of
``repro.obs.trace``).

A :class:`Tracer` accumulates events in the Chrome trace event format
(the ``{"traceEvents": [...]}`` JSON that chrome://tracing and Perfetto
load).  The emitters:

  - the serve stack: one async span per request uid (``ph: b`` / ``e``,
    ``id: uid``) from submit to retire; retroactive complete spans
    (``ph: X``) for the admission wait, swap-in, each burst's
    dispatch → readback window and static buckets, recorded from two
    ``now()`` stamps after the fact so the step loop never waits on the
    tracer; instant events (``ph: i``) for preemption, copy-on-write,
    prefix attach, swap-out, first token, cancel, and the front end's
    crash / restart / failover;
  - the pruning scheduler: one span per stage window (``prune_capture``,
    ``prune_solve``, ``prune_propagate``).

Timestamps are microseconds since the tracer was built, from
``time.monotonic()``.  ``pid`` is 0 and ``tid`` names the emitting
replica or component, so each gets its own track.  A disabled tracer
(``NULL_TRACER``) does nothing, so token streams are the same with
tracing on or off.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class Tracer:
    """Thread-safe Chrome-trace event accumulator."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._t0 = time.monotonic()
        self._tids: Dict[str, int] = {}

    def now(self) -> float:
        """Monotonic stamp for a later retroactive span."""
        return time.monotonic()

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids)
            self._tids[track] = tid
            self._events.append({"name": "thread_name", "ph": "M", "pid": 0,
                                 "tid": tid, "args": {"name": track}})
        return tid

    def _emit(self, ev: dict, track: str) -> None:
        with self._lock:
            ev["pid"] = 0
            ev["tid"] = self._tid(track)
            self._events.append(ev)

    # ---------------------------------------------------------- events
    def complete(self, name: str, start: float, end: float, *,
                 track: str = "main", args: Optional[dict] = None) -> None:
        """A span from two ``now()`` stamps (ph X)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "ts": self._us(start),
              "dur": max(0.0, (end - start) * 1e6)}
        if args:
            ev["args"] = args
        self._emit(ev, track)

    @contextmanager
    def span(self, name: str, *, track: str = "main",
             args: Optional[dict] = None):
        """Context-manager span; free when disabled."""
        if not self.enabled:
            yield
            return
        start = time.monotonic()
        try:
            yield
        finally:
            self.complete(name, start, time.monotonic(), track=track,
                          args=args)

    def instant(self, name: str, *, track: str = "main",
                args: Optional[dict] = None) -> None:
        """A point event (ph i, thread scope)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "ts": self._us(time.monotonic()),
              "s": "t"}
        if args:
            ev["args"] = args
        self._emit(ev, track)

    def async_begin(self, name: str, uid: int, *, track: str = "main",
                    args: Optional[dict] = None) -> None:
        """Open a request's lifecycle span (ph b, id = uid)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "b", "cat": "request", "id": int(uid),
              "ts": self._us(time.monotonic())}
        if args:
            ev["args"] = args
        self._emit(ev, track)

    def async_end(self, name: str, uid: int, *, track: str = "main",
                  args: Optional[dict] = None) -> None:
        """Close a request's lifecycle span (ph e, id = uid)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "e", "cat": "request", "id": int(uid),
              "ts": self._us(time.monotonic())}
        if args:
            ev["args"] = args
        self._emit(ev, track)

    # --------------------------------------------------------- readout
    def events(self, name: Optional[str] = None,
               ph: Optional[str] = None) -> List[dict]:
        """Snapshot of the recorded events, optionally filtered."""
        with self._lock:
            evs = list(self._events)
        return [e for e in evs if (name is None or e.get("name") == name)
                and (ph is None or e.get("ph") == ph)]

    def export(self, path: str) -> int:
        """Write Chrome-trace JSON; returns the number of events."""
        evs = self.events()
        with open(path, "w") as f:
            json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
        return len(evs)

    def clear(self) -> None:
        """Drop every event but the track-name metadata."""
        with self._lock:
            self._events = [e for e in self._events if e.get("ph") == "M"]


NULL_TRACER = Tracer(enabled=False)
