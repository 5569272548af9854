"""Metrics registry: counters, gauges and histograms (a port of
``repro.obs.metrics``).

One :class:`MetricsRegistry` per deployment unit (the serve launcher
builds a single registry shared by every replica; a bare engine or pool
builds a private one) holds *metric families* keyed by name.  A family
carries the Prometheus metadata (type, help, label names) and a child
per label-value combination; components bind children once at
construction and the hot path is a single ``inc`` / ``observe`` under
one registry-wide lock, which the front end's replica worker threads
share safely.

Conventions, as in the reference:

  - counters are monotonic and named ``*_total`` (``*_seconds_total``
    for accumulated wall time); per-run deltas are the consumer's job
    (``ServeEngine.stats`` re-bases at ``generate()``);
  - gauges may be callback-backed (:meth:`Gauge.set_fn`), evaluated at
    collection time (queue depth, free pages, replica health);
  - histograms use fixed buckets chosen at bind time (:func:`exp_buckets`
    for latencies) and give approximate quantiles by linear
    interpolation within a bucket.

``MetricsRegistry(enabled=False)`` returns a shared no-op family from
every bind, so instrumented code needs no ``if``.
:meth:`MetricsRegistry.render` writes the Prometheus text exposition
format (the front end's ``GET /metrics``), byte for byte the
reference's for the same operations.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple


def exp_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """Geometric bucket upper bounds: start, start*factor, ..."""
    if start <= 0 or factor <= 1.0 or count < 1:
        raise ValueError("exp_buckets needs start > 0, factor > 1, "
                         "count >= 1")
    out, v = [], start
    for _ in range(count):
        # round to 4 significant digits: tidy ``le`` labels, and the
        # rounding error is far below the spacing itself
        out.append(float(f"{v:.4g}"))
        v *= factor
    return tuple(out)


# default latency buckets: ~12% geometric spacing, 100 µs .. ~80 s
LATENCY_BUCKETS = exp_buckets(1e-4, 1.12, 120)
# small-integer buckets (burst lengths, pages per event)
COUNT_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0,
                 48.0, 64.0, 96.0, 128.0)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integral values without the .0."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(b: float) -> str:
    return "+Inf" if b == float("inf") else _fmt(b)


class Counter:
    """Monotonic counter child.  ``inc`` only ever adds >= 0."""

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


class Gauge:
    """Settable gauge child; ``set_fn`` makes it callback-backed
    (evaluated at collection time — queue depths, health bits)."""

    __slots__ = ("_lock", "_v", "_fn")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)
            self._fn = None

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_fn(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._v
        try:                       # outside the lock: fn may take others
            return float(fn())
        except Exception:          # a dead callback must not kill /metrics
            return 0.0


class Histogram:
    """Fixed-bucket histogram child.

    ``buckets`` are the finite upper bounds (``le``); an implicit +Inf
    bucket catches the tail.  ``observe`` is one bisect + two adds.
    """

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count")

    def __init__(self, lock: threading.Lock, bounds: Tuple[float, ...]):
        self._lock = lock
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)      # +Inf tail
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)      # le is inclusive
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def cumulative(self) -> List[int]:
        """Cumulative counts per bucket (Prometheus ``le`` semantics),
        +Inf last."""
        with self._lock:
            counts = list(self._counts)
        out, acc = [], 0
        for c in counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Approximate quantile by linear interpolation inside the
        bucket the rank lands in (histogram_quantile semantics).  The
        +Inf bucket clamps to the highest finite bound."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        cum = self.cumulative()
        total = cum[-1]
        if total == 0:
            return 0.0
        rank = q * total
        for i, c in enumerate(cum):
            if c >= rank:
                if i >= len(self.bounds):           # +Inf bucket
                    return self.bounds[-1] if self.bounds else 0.0
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                prev = cum[i - 1] if i > 0 else 0
                width = c - prev
                frac = (rank - prev) / width if width else 1.0
                return lo + (hi - lo) * frac
        return self.bounds[-1] if self.bounds else 0.0


def merge_histograms(fams) -> Optional[Histogram]:
    """Merge every child of the given histogram families (which must
    share one bucket layout) into a standalone :class:`Histogram` —
    one TTFT percentile across N replicas, or across N registries when
    replicas were built independently.  None when there are no
    children."""
    kids = [c for fam in fams for _, c in fam.children()]
    if not kids:
        return None
    merged = Histogram(threading.Lock(), kids[0].bounds)
    for k in kids:
        with k._lock:
            for i, c in enumerate(k._counts):
                merged._counts[i] += c
            merged._sum += k._sum
            merged._count += k._count
    return merged


_CHILD_TYPES = {"counter": Counter, "gauge": Gauge}


class MetricFamily:
    """One named metric: metadata + a child per label-value tuple.

    Unlabelled families delegate ``inc``/``set``/``observe``/``value``
    etc. to their single default child, so
    ``registry.counter("x_total").inc()`` just works.
    """

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help: str, labelnames: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self.buckets = buckets
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **kv):
        """Get-or-create the child for one label-value combination."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self.registry._lock:
            child = self._children.get(key)
            if child is None:
                if self.kind == "histogram":
                    child = Histogram(self.registry._vlock, self.buckets)
                else:
                    child = _CHILD_TYPES[self.kind](self.registry._vlock)
                self._children[key] = child
            return child

    def _default(self):
        return self.labels()

    # unlabelled convenience surface
    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def set(self, v: float) -> None:
        self._default().set(v)

    def set_fn(self, fn: Callable[[], float]) -> None:
        self._default().set_fn(fn)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self) -> float:
        return self._default().value

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self.registry._lock:
            return sorted(self._children.items())

    # ------------------------------------------------ aggregate reads
    def total(self) -> float:
        """Sum of every child's value (counters/gauges)."""
        return sum(c.value for _, c in self.children())

    def quantile(self, q: float) -> float:
        """Histogram quantile over all children merged (one TTFT
        percentile across every replica)."""
        merged = merge_histograms([self])
        return merged.quantile(q) if merged is not None else 0.0

    def hist_count(self) -> int:
        return sum(c.count for _, c in self.children())

    def hist_sum(self) -> float:
        return sum(c.sum for _, c in self.children())


class _NullChild:
    """Shared do-nothing child for disabled registries."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def set_fn(self, fn) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    value = 0.0
    count = 0
    sum = 0.0
    mean = 0.0

    def quantile(self, q: float) -> float:
        return 0.0

    def cumulative(self):
        return []


class _NullFamily(_NullChild):
    """Disabled-mode family: ``labels()`` and every child method are
    free no-ops, so instrumented code runs unguarded at zero cost."""

    __slots__ = ()

    def labels(self, **kv):
        return self

    def children(self):
        return []

    def total(self) -> float:
        return 0.0

    def hist_count(self) -> int:
        return 0

    def hist_sum(self) -> float:
        return 0.0


_NULL_FAMILY = _NullFamily()


class MetricsRegistry:
    """Thread-safe named-metric registry with Prometheus text export.

    ``counter``/``gauge``/``histogram`` are get-or-create: binding the
    same name twice returns the same family (a kind or label-name
    mismatch raises).  ``enabled=False`` turns every bind into a shared
    no-op — the zero-overhead disabled mode.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()       # family/child creation
        self._vlock = threading.Lock()      # child value mutation
        self._families: Dict[str, MetricFamily] = {}

    # ------------------------------------------------------------- bind
    def _bind(self, name: str, kind: str, help: str,
              labels: Iterable[str],
              buckets: Optional[Tuple[float, ...]] = None) -> MetricFamily:
        if not self.enabled:
            return _NULL_FAMILY
        labelnames = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(self, name, kind, help, labelnames,
                                   buckets=buckets)
                self._families[name] = fam
                return fam
        if fam.kind != kind:
            raise ValueError(f"metric {name!r} already bound as "
                             f"{fam.kind}, not {kind}")
        if fam.labelnames != labelnames:
            raise ValueError(f"metric {name!r} label names {fam.labelnames}"
                             f" != {labelnames}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> MetricFamily:
        return self._bind(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> MetricFamily:
        return self._bind(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Tuple[float, ...] = LATENCY_BUCKETS
                  ) -> MetricFamily:
        return self._bind(name, "histogram", help, labels,
                          buckets=tuple(buckets))

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def reset(self) -> None:
        """Zero every child (isolating a measured run from its warmup;
        never on a live server — Prometheus counters are monotonic)."""
        for fam in self.families():
            for _, child in fam.children():
                with self._vlock:
                    if isinstance(child, Histogram):
                        child._counts = [0] * len(child._counts)
                        child._sum = 0.0
                        child._count = 0
                    elif isinstance(child, Counter):
                        child._v = 0.0
                    # callback gauges keep their fn; plain gauges zero
                    elif child._fn is None:
                        child._v = 0.0

    # ----------------------------------------------------------- export
    def render(self) -> str:
        """Prometheus text exposition format (``GET /metrics``)."""
        if not self.enabled:
            return ""
        out: List[str] = []
        for fam in self.families():
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in fam.children():
                base = ",".join(f'{n}="{v}"'
                                for n, v in zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    cum = child.cumulative()
                    bounds = (*child.bounds, float("inf"))
                    for b, c in zip(bounds, cum):
                        lab = (f'{base},le="{_fmt_le(b)}"' if base
                               else f'le="{_fmt_le(b)}"')
                        out.append(f"{fam.name}_bucket{{{lab}}} {c}")
                    suffix = f"{{{base}}}" if base else ""
                    out.append(f"{fam.name}_sum{suffix} {_fmt(child.sum)}")
                    out.append(f"{fam.name}_count{suffix} {child.count}")
                else:
                    suffix = f"{{{base}}}" if base else ""
                    out.append(f"{fam.name}{suffix} {_fmt(child.value)}")
        return "\n".join(out) + ("\n" if out else "")

    def collect(self) -> Dict[str, Dict]:
        """JSON-friendly snapshot of every family."""
        snap: Dict[str, Dict] = {}
        for fam in self.families():
            entry: Dict = {"type": fam.kind}
            samples: Dict[str, float] = {}
            for values, child in fam.children():
                key = ",".join(f"{n}={v}"
                               for n, v in zip(fam.labelnames, values)) or ""
                if fam.kind == "histogram":
                    samples[key] = {"count": child.count, "sum": child.sum,
                                    "p50": child.quantile(0.5),
                                    "p95": child.quantile(0.95)}
                else:
                    samples[key] = child.value
            entry["samples"] = samples
            snap[fam.name] = entry
        return snap


NULL_REGISTRY = MetricsRegistry(enabled=False)
