"""Replica supervision: crash/stall detection, worker restart, and
in-flight failover (a port of ``repro.serve.frontend.supervisor``).

The :class:`Supervisor` watches a :class:`~repro_torch.serve.frontend.
router.Router`'s replicas.  When one goes unhealthy — worker thread dead (an
engine-step raise, an injected ``serve.faults`` failure) or stalled
past ``replica.HEALTH_STALL_S`` — recovery is three deterministic steps:

  1. **snapshot** the dead replica's in-flight requests and their
     delivered-token counts (:meth:`Replica.take_inflight` — the
     per-request event log);
  2. **restart** its worker with a rebuilt session
     (:meth:`Replica.restart` — the shared engine's pool is reset, so
     the new generation starts from consistent state);
  3. **re-submit** every in-flight request through
     :meth:`Router.submit_request` — least-loaded placement over the
     healthy siblings AND the just-restarted replica, with bounded
     jittered-backoff retries riding out the restart window.

Client streams are token-identical to an uninjected run: the per-(uid,
step) sampling key contract makes the re-run reproduce exactly the
original tokens (prefix-cache reuse on a sibling makes the replayed
prefill cheap when the prefix was shared), and the replay-suppression
wrapper drops the prefix the client already received — the same
dedup discipline the session applies to preemption recompute.

Counters and trace: ``replica_restarts_total``,
``requests_failed_over_total``, the ``serve_recovery_seconds``
histogram, and ``replica_crash`` / ``replica_restart`` / ``failover``
trace instants.

A replica whose failure is :attr:`~repro_torch.serve.frontend.replica.
Replica.fatal` (a lockstep replica's collective failed: a rank is gone)
is left down — a restart would carry on without that rank.

``check_once()`` is the whole algorithm and is directly callable —
tests and chip_smoke drive recovery deterministically without
the polling thread; ``start()``/``stop()`` wrap it in a daemon poller
for real serving.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serve.engine import Result, StreamEvent
from repro_torch.serve.frontend.router import Router
from repro_torch.serve.scheduler import QueueFull

# how many times a failed-over request re-sweeps the replicas (with
# backoff) while the crashed one restarts, before its client gets an
# error event
FAILOVER_RETRIES = 8


def _suppress_replay(cb: Callable[[StreamEvent], None],
                     skip: int) -> Callable[[StreamEvent], None]:
    """Wrap a per-request callback so the first ``skip`` replayed
    tokens — the prefix the client already received before the crash —
    are dropped; the stream resumes exactly where it stopped."""
    if skip <= 0:
        return cb
    seen = 0

    def wrapped(ev: StreamEvent) -> None:
        nonlocal seen
        toks = ev.tokens
        if seen < skip:
            drop = min(skip - seen, len(toks))
            toks = toks[drop:]
        seen += len(ev.tokens)
        if toks or ev.finished:
            cb(StreamEvent(uid=ev.uid, tokens=toks, finished=ev.finished,
                           result=ev.result,
                           finish_reason=ev.finish_reason))

    return wrapped


class Supervisor:
    def __init__(self, router: Router, poll_s: float = 0.5):
        self.router = router
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- recovery
    def check_once(self) -> List[str]:
        """One supervision pass: recover every unhealthy, non-draining
        replica.  Returns the recovered replica names (tests call
        this directly for deterministic chaos runs)."""
        recovered: List[str] = []
        for rep in self.router.replicas:
            if rep.healthy or rep.draining or rep.fatal is not None:
                continue
            t0 = time.monotonic()
            m = rep.engine.m
            inflight = rep.take_inflight()
            rep.restart()
            for req, delivered, cb in inflight:
                if cb is None:
                    continue
                wrapped = _suppress_replay(cb, delivered)
                try:
                    target = self.router.submit_request(
                        req, wrapped, retries=FAILOVER_RETRIES)
                except (QueueFull, RuntimeError) as e:
                    # the retry budget ran dry: unblock the client with
                    # a terminal error event instead of a silent hang
                    cb(StreamEvent(
                        uid=req.uid, tokens=[], finished=True,
                        result=Result(uid=req.uid,
                                      tokens=np.zeros(0, np.int32),
                                      prompt_len=len(req.prompt)),
                        finish_reason="error"))
                    m.obs.tracer.instant(
                        "failover_failed", track=m.label,
                        args={"uid": req.uid, "error": repr(e)})
                    continue
                m.failed_over.inc()
                m.obs.tracer.instant(
                    "failover", track=m.label,
                    args={"uid": req.uid, "from": rep.name,
                          "to": target.name, "delivered": delivered})
            m.recovery.observe(time.monotonic() - t0)
            recovered.append(rep.name)
        return recovered

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Run :meth:`check_once` on a daemon poller every ``poll_s``
        seconds until :meth:`stop`."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.poll_s):
                self.check_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="replica-supervisor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
