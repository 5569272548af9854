"""Metrics registry of labelled counters (a port of the counter half of
``repro.obs.metrics``).

A :class:`MetricsRegistry` holds metric families keyed by name; a family
carries its help text and label names and one child per label-value
combination.  Counters are monotonic and named ``*_total``
(``*_seconds_total`` for accumulated wall time).
``MetricsRegistry(enabled=False)`` returns a shared no-op family from
every bind, so instrumented code needs no ``if``.  The Prometheus text
export and the serving half wait for the serving slice that reads them.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple


class Counter:
    """Monotonic counter child: ``inc`` only ever adds >= 0."""

    __slots__ = ("_lock", "_v")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._v += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class MetricFamily:
    """One named counter: metadata + a child per label-value tuple.  An
    unlabelled family's ``inc`` / ``value`` go to its single child."""

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Tuple[str, ...]):
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._children: Dict[Tuple[str, ...], Counter] = {}

    def labels(self, **kv) -> Counter:
        """Get or create the child of one label-value combination."""
        if set(kv) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(kv)} != declared "
                             f"{sorted(self.labelnames)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self.registry._lock:
            child = self._children.get(key)
            if child is None:
                child = Counter(self.registry._lock)
                self._children[key] = child
            return child

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    @property
    def value(self) -> float:
        return self.labels().value

    def children(self) -> List[Tuple[Tuple[str, ...], Counter]]:
        with self.registry._lock:
            return sorted(self._children.items())


class _NullFamily:
    """Disabled-mode family: every call is a free no-op."""

    __slots__ = ()
    value = 0.0

    def labels(self, **kv):
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass


_NULL_FAMILY = _NullFamily()


class MetricsRegistry:
    """Thread-safe named-counter registry.

    ``counter`` is get-or-create: binding a name twice returns the same
    family (other label names raise)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> MetricFamily:
        if not self.enabled:
            return _NULL_FAMILY
        labelnames = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(self, name, help, labelnames)
                self._families[name] = fam
        if fam.labelnames != labelnames:
            raise ValueError(f"metric {name!r} label names {fam.labelnames}"
                             f" != {labelnames}")
        return fam

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)


NULL_REGISTRY = MetricsRegistry(enabled=False)
