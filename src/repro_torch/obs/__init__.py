"""Observability for the prune path: a metrics registry of labelled
counters and a Chrome-trace span recorder (a port of the part of
``repro.obs`` that the pruning launcher uses; the serving half —
gauges, histograms, the front end's ``/metrics`` — waits for the
serving slice that needs it).

:class:`Obs` bundles one registry and one tracer.  ``Obs.create`` builds
an enabled bundle; ``Obs.disabled()`` turns every call site into a
no-op.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["Obs", "MetricsRegistry", "Tracer", "NULL_REGISTRY",
           "NULL_TRACER"]


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
