"""Least-loaded router over N data-parallel ServeEngine replicas (a port
of ``repro.serve.frontend.router``).

Topology: every replica has its own engine — paged KV pool, session and
worker thread — over the (pruned) model's weights (the launcher's
replicas share one packed copy on the card); the router owns uid
assignment and dispatch.  Dispatch is least-loaded
over HEALTHY replicas (ties broken by replica order, so a single
replica degenerates to plain pass-through); a replica whose wait queue
is at its depth cap makes ``submit`` raise ``QueueFull`` and the router
fails over to the next-least-loaded one, raising only when EVERY
healthy replica is full — that terminal ``QueueFull`` is the server's
429.

Parity contract: replicas are built with one shared seed, and sampling
is keyed per (uid, step) inside the engine — a request's token stream
is bit-identical no matter which replica serves it, so least-loaded
placement is purely a latency decision.

``drain()`` is the rolling-shutdown primitive: stop intake everywhere,
wait for in-flight requests to finish, park the workers.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.obs.metrics import merge_histograms
from repro_torch.serve.engine import Request, StreamEvent
from repro_torch.serve.frontend.protocol import (CompletionRequest,
                                                 CompletionResponse,
                                                 to_engine_request)
from repro_torch.serve.frontend.replica import Replica, ReplicaDraining
from repro_torch.serve.scheduler import QueueFull

# the first wait of a retried sweep; each later wait doubles, capped at 1 s
RETRY_BACKOFF_S = 0.05


class ReplicaFailed(RuntimeError):
    """A replica's failure that no restart mends (a lockstep replica
    whose collective failed: a rank is gone)."""


class NoHealthyReplicas(RuntimeError):
    """Every replica is down (crashed/stalled, none merely draining) —
    transient while the supervisor restarts workers, so the server
    surfaces it as HTTP 503 with a ``Retry-After`` hint instead of a
    500-shaped handler crash."""

    retry_after_s: float = 1.0


class Router:
    def __init__(self, replicas: List[Replica]):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = list(replicas)
        self._uids = itertools.count()
        self._uid_lock = threading.Lock()

    # --------------------------------------------------------- dispatch
    def _candidates(self) -> List[Replica]:
        up = [r for r in self.replicas if r.healthy]
        if not up:
            if any(r.draining for r in self.replicas):
                raise ReplicaDraining("all replicas draining")
            raise NoHealthyReplicas("no healthy replicas")
        return sorted(up, key=lambda r: r.load)

    def assign_uid(self, creq: CompletionRequest) -> int:
        if creq.uid is not None:
            return creq.uid
        with self._uid_lock:
            return next(self._uids)

    def submit(self, creq: CompletionRequest,
               on_event: Callable[[StreamEvent], None],
               uid: Optional[int] = None) -> Replica:
        """Place one wire request on the least-loaded healthy replica,
        failing over across full ones.  Returns the replica that took
        it; raises ``QueueFull`` when every healthy replica is at its
        depth cap (HTTP 429), :class:`NoHealthyReplicas` when none is
        up (HTTP 503) and ``ValueError`` on an unservable request."""
        if uid is None:
            uid = self.assign_uid(creq)
        return self.submit_request(to_engine_request(creq, uid), on_event)

    def submit_request(self, req: Request,
                       on_event: Callable[[StreamEvent], None],
                       retries: int = 0) -> Replica:
        """Engine-level submit (the supervisor's failover entry): sweep
        the healthy replicas least-loaded-first, and on a fully
        full/draining/down sweep retry up to ``retries`` times with
        bounded jittered exponential backoff — transient windows during
        a crash/restart resolve instead of bouncing the request.  The
        server's intake passes none: a full sweep is its 429."""
        attempt = 0
        while True:
            last: Optional[Exception] = None
            try:
                cands = self._candidates()
            except (NoHealthyReplicas, ReplicaDraining) as e:
                cands, last = [], e
            for rep in cands:
                try:
                    rep.submit(req, on_event)
                    return rep
                except (QueueFull, ReplicaDraining) as e:
                    last = e
            if attempt >= retries:
                if not cands:       # nobody to even try: typed signal
                    raise last      # (503 / draining) straight through
                raise QueueFull(f"all replicas at capacity ({last})")
            attempt += 1
            # jittered exponential backoff, capped at 1s per wait
            delay = min(1.0, RETRY_BACKOFF_S * (2 ** (attempt - 1)))
            time.sleep(delay * (0.5 + 0.5 * random.random()))

    def cancel(self, uid: int, reason: str = "cancelled") -> bool:
        """Cancel an in-flight request wherever it landed (after a
        failover that may not be the replica that first took it) —
        the server's client-disconnect path.  False when no replica
        knows the uid (already finished)."""
        return any(r.cancel(uid, reason=reason) for r in self.replicas)

    # ----------------------------------------------------- batch client
    def complete(self, creqs: List[CompletionRequest]
                 ) -> List[CompletionResponse]:
        """Blocking batch entry point (the CLI's code path): stream all
        requests through the replicas, return terminal responses in uid
        order."""
        done = threading.Event()
        out: Dict[int, CompletionResponse] = {}
        lock = threading.Lock()
        names: Dict[int, str] = {}
        remaining = len(creqs)
        if not remaining:
            return []

        def make_cb(uid: int):
            def cb(ev: StreamEvent) -> None:
                nonlocal remaining
                if not ev.finished:
                    return
                with lock:
                    out[uid] = CompletionResponse.from_result(
                        ev.result, replica=names.get(uid))
                    remaining -= 1
                    if remaining == 0:
                        done.set()
            return cb

        for creq in creqs:
            uid = self.assign_uid(creq)
            rep = self.submit(creq, make_cb(uid), uid=uid)
            names[uid] = rep.name
        while not done.wait(timeout=0.25):
            self.raise_fatal()
        return [out[k] for k in sorted(out)]

    def raise_fatal(self) -> None:
        """Raise a replica's fatal failure (a lockstep replica whose
        collective failed), if one has one."""
        for r in self.replicas:
            if r.fatal is not None:
                raise ReplicaFailed(
                    f"replica {r.name} failed: {r.fatal!r}") from r.fatal

    # --------------------------------------------------------- lifecycle
    def health(self) -> Dict[str, Dict[str, float]]:
        return {r.name: {"healthy": r.healthy, "load": r.load}
                for r in self.replicas}

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {r.name: r.stats() for r in self.replicas}

    # ----------------------------------------------------- observability
    def registries(self) -> List:
        """The distinct enabled metrics registries behind the replicas
        — ONE when the launcher shares a bundle across replicas (each
        replica then writes its own ``replica``-labelled children), one
        per replica when engines were built independently."""
        regs: List = []
        for r in self.replicas:
            reg = r.engine.obs.metrics
            if reg.enabled and all(reg is not x for x in regs):
                regs.append(reg)
        return regs

    def metrics_text(self) -> str:
        """Prometheus text exposition across every replica registry —
        the body of the server's ``GET /metrics``."""
        return "".join(reg.render() for reg in self.registries())

    def summary(self) -> Dict[str, float]:
        """Request-latency aggregates derived from the registry's
        histograms (all replicas merged) — the ``_summary`` block on
        the trace-enriched ``/stats``."""
        out: Dict[str, float] = {}
        regs = self.registries()
        for key, name in (("ttft", "serve_ttft_seconds"),
                          ("tpot", "serve_tpot_seconds"),
                          ("queue_wait", "serve_queue_wait_seconds")):
            fams = [f for f in (reg.get(name) for reg in regs)
                    if f is not None]
            h = merge_histograms(fams)
            if h is None or h.count == 0:
                continue
            out[f"{key}_count"] = h.count
            out[f"{key}_ms_p50"] = h.quantile(0.5) * 1e3
            out[f"{key}_ms_p95"] = h.quantile(0.95) * 1e3
        return out

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop intake on every replica, then wait for all in-flight
        work to finish.  True only if every replica went idle."""
        ok = True
        for r in self.replicas:
            ok = r.drain(timeout=timeout) and ok
        return ok

    def close(self) -> None:
        for r in self.replicas:
            r.close()
