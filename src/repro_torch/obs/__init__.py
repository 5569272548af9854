"""Observability: a metrics registry and a Chrome-trace recorder (a port
of ``repro.obs``).

:class:`Obs` bundles one registry, one tracer and the label of the
emitting replica or component.  The serve launcher builds one enabled
bundle and hands each replica a labelled view (``obs.labelled("r1")``):
every serve series then carries a ``replica`` label while all replicas
write one registry, which the front end's ``/metrics`` and ``/stats``
read without racing the worker threads.  A bare engine or pool with no
bundle builds its own metrics-only one; ``Obs.disabled()`` turns every
call site into a no-op.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.obs.metrics import (COUNT_BUCKETS, LATENCY_BUCKETS,
                                     NULL_REGISTRY, MetricsRegistry,
                                     exp_buckets)
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["Obs", "MetricsRegistry", "Tracer", "NULL_REGISTRY",
           "NULL_TRACER", "LATENCY_BUCKETS", "COUNT_BUCKETS", "exp_buckets"]


@dataclass(frozen=True)
class Obs:
    """One registry + tracer, and the label of the emitting component."""

    metrics: MetricsRegistry
    tracer: Tracer
    label: str = "r0"

    @classmethod
    def create(cls, metrics: bool = True, trace: bool = False,
               label: str = "r0") -> "Obs":
        return cls(metrics=MetricsRegistry(enabled=metrics),
                   tracer=Tracer(enabled=trace), label=label)

    @classmethod
    def disabled(cls) -> "Obs":
        return cls(metrics=NULL_REGISTRY, tracer=NULL_TRACER)

    @property
    def enabled(self) -> bool:
        return self.metrics.enabled or self.tracer.enabled

    def labelled(self, label: str) -> "Obs":
        """The same registry and tracer under another label."""
        return replace(self, label=label)
