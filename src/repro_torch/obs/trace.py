"""Span tracing with Chrome-trace JSON export (a port of
``repro.obs.trace``, the span half).

A :class:`Tracer` accumulates complete events (``ph: X``) in the Chrome
trace event format — the ``{"traceEvents": [...]}`` JSON that
chrome://tracing and Perfetto load.  The pruning scheduler records one
span per stage window (``prune_capture``, ``prune_solve``,
``prune_propagate``) after the fact, from two ``time.monotonic()``
stamps.  Timestamps are microseconds since the tracer was built; ``pid``
is 0 and ``tid`` names the track.  A disabled tracer (``NULL_TRACER``)
does nothing.
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

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids)
            self._tids[track] = tid
            self._events.append({"name": "thread_name", "ph": "M", "pid": 0,
                                 "tid": tid, "args": {"name": track}})
        return tid

    def complete(self, name: str, start: float, end: float, *,
                 track: str = "main", args: Optional[dict] = None) -> None:
        """A span from two ``time.monotonic()`` stamps (ph X)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "ts": (start - self._t0) * 1e6,
              "dur": max(0.0, (end - start) * 1e6), "pid": 0}
        if args:
            ev["args"] = args
        with self._lock:
            ev["tid"] = self._tid(track)
            self._events.append(ev)

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


NULL_TRACER = Tracer(enabled=False)
