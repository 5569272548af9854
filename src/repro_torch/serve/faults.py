"""Deterministic fault injection for the serve stack (a port of
``repro.serve.faults``).

Supervision, failover and cancellation can be trusted only where every
recovery path can be driven on purpose.  A :class:`FaultPlan` is a list
of :class:`FaultSpec` triggers carried by
:class:`~repro_torch.serve.config.ServeConfig`; each names an injection
*site* (a host-side seam the runtime passes through anyway) and fires
on a given pass, so a chaos run is exactly reproducible.

Sites (``FaultSpec.site``):

  ``engine_step``     raise :class:`FaultError` at burst dispatch,
                      before anything is queued on the device — the
                      session's ``step()`` raises and the replica
                      worker thread dies (the supervisor's path);
  ``replica_worker``  raise in the replica worker loop itself, before
                      any session work — a worker death with the
                      scheduler state consistent;
  ``pool_alloc``      :meth:`PagedKVPool.alloc` reports exhaustion
                      (returns ``None``) — the preemption and blocked
                      admission paths without filling the pool;
  ``slow_burst``      sleep ``delay_s`` at burst dispatch — a stalled
                      step, for the stall-based health check;
  ``swap_error``      host-arena failure: ``swap_out`` returns ``None``
                      (preemption degrades to recompute) and
                      ``swap_in`` returns ``False`` (resume retries).

Sites count every pass, fire while ``after < seen <= after + count`` and
go quiet again, so recovery runs against a healthy system.  A spec with
``replica`` set counts only that replica's passes.

Every injected failure is recoverable without changing any surviving
request's tokens (the per-(uid, step) sampling keys).  The faults fire
on the host only: a real CUDA fault is sticky, and no restart clears it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

SITES = ("engine_step", "replica_worker", "pool_alloc", "slow_burst",
         "swap_error")


class FaultError(RuntimeError):
    """An injected failure (never raised by real code paths) — what a
    crashed worker's ``Replica.crashed`` holds in chaos runs."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic trigger: fire at passes ``after+1 ..
    after+count`` through ``site`` (optionally only counting passes
    from one replica label)."""

    site: str
    after: int = 0            # passes to let through before firing
    count: int = 1            # consecutive firings once triggered
    delay_s: float = 0.5      # stall length (slow_burst only)
    replica: Optional[str] = None   # restrict to one replica label

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """Parse a CLI spec: ``site[:key=value,...]`` with keys
        ``after``, ``count``, ``delay_s``, ``replica`` — e.g.
        ``replica_worker:after=3,replica=r0``."""
        site, _, rest = text.partition(":")
        kw: Dict[str, object] = {}
        if rest:
            for item in rest.split(","):
                k, _, v = item.partition("=")
                k = k.strip()
                if k in ("after", "count"):
                    kw[k] = int(v)
                elif k == "delay_s":
                    kw[k] = float(v)
                elif k == "replica":
                    kw[k] = v.strip()
                else:
                    raise ValueError(f"unknown fault-spec key {k!r}")
        return cls(site=site.strip(), **kw)

    def validate(self) -> "FaultSpec":
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(expected one of {SITES})")
        if self.after < 0:
            raise ValueError("fault 'after' must be >= 0")
        if self.count < 1:
            raise ValueError("fault 'count' must be >= 1")
        if self.delay_s < 0:
            raise ValueError("fault 'delay_s' must be >= 0")
        return self


class FaultPlan:
    """A set of specs plus per-spec pass counters (thread-safe: the
    replica worker threads and the pool all hit sites concurrently).
    One plan is shared by every replica built from one ServeConfig, so
    ``replica``-scoped specs see a per-replica count and unscoped specs
    a global one."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: List[FaultSpec] = [s.validate() for s in specs]
        self._seen: Dict[int, int] = {}
        self._lock = threading.Lock()
        # site -> times it actually fired
        self.fired: Dict[str, int] = {}

    @classmethod
    def parse(cls, texts: Sequence[str]) -> "FaultPlan":
        return cls([FaultSpec.parse(t) for t in texts])

    def __bool__(self) -> bool:
        return bool(self.specs)

    def hit(self, site: str, replica: Optional[str] = None
            ) -> Optional[FaultSpec]:
        """Count one pass through ``site``; return the spec that should
        fail this pass (None = proceed normally).  O(1) when the plan
        is empty."""
        if not self.specs:
            return None
        with self._lock:
            fired = None
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.replica is not None and spec.replica != replica:
                    continue
                seen = self._seen.get(i, 0) + 1
                self._seen[i] = seen
                if fired is None and spec.after < seen <= (spec.after
                                                           + spec.count):
                    fired = spec
            if fired is not None:
                self.fired[site] = self.fired.get(site, 0) + 1
            return fired

    # ---------------------------------------------------- burst seam
    def burst_hook(self, replica: Optional[str] = None) -> None:
        """The host-side hook the engine calls before each burst
        dispatch: a fired ``slow_burst`` sleeps (stalled step),
        a fired ``engine_step`` raises (worker crash)."""
        spec = self.hit("slow_burst", replica)
        if spec is not None:
            time.sleep(spec.delay_s)
        if self.hit("engine_step", replica) is not None:
            raise FaultError(
                f"injected engine_step failure (replica={replica})")
