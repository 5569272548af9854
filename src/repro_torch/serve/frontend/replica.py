"""One serving replica: a ContinuousSession driven by a worker thread (a
port of ``repro.serve.frontend.replica``).

The engine's step loop is synchronous and device-bound; the HTTP server
is an asyncio event loop.  A :class:`Replica` bridges them with the
smallest possible surface: a dedicated worker thread owns the session
and runs ``step()`` whenever there is work, and every public method is
safe to call from any thread (one mutex guards the scheduler state; the
worker holds it across a step, so a concurrent ``submit`` lands between
sync intervals — exactly where the engine admits anyway).

Delivery is callback-based: ``submit(req, on_event)`` registers a
per-request callback that the WORKER thread invokes with each
:class:`StreamEvent` (new tokens only — the session already suppresses
preemption replays).  The asyncio server wraps its callback with
``loop.call_soon_threadsafe``; the batch path just appends to a list.

Backpressure is synchronous: ``submit`` raises ``scheduler.QueueFull``
in the caller's thread when the wait queue is at its depth cap, so the
server can answer 429 without a round trip through the worker.

Lifecycle: a replica is born accepting.  ``drain()`` stops intake
(``ReplicaDraining`` on submit) but finishes everything in flight, then
parks the worker — the router's rolling-shutdown building block.
``close()`` abandons in-flight work (tests / hard shutdown only).

Fault tolerance: a worker that dies — an engine-step raise,
an injected ``serve.faults`` failure — is captured in :attr:`crashed`
instead of vanishing silently, and ``healthy`` goes False (thread dead,
or stalled past ``HEALTH_STALL_S``).  The supervisor's recovery pair is
:meth:`take_inflight` (snapshot the per-request event log: engine
request + tokens already handed to delivery) and :meth:`restart`
(rebuild the session — which resets the shared pool — and start a
fresh worker generation; a stalled previous worker exits at its next
loop check and can no longer deliver into the new generation's
subscriptions).  Per-request delivered-token counts are what failover
replay-suppression trims, so a re-submitted request's client stream
continues exactly where it stopped.

Under a mesh of several ranks (``engine.ranks`` > 1) this is rank 0's
side of a replica that the other ranks' followers mirror
(``serve.frontend.lockstep``): every op it applies to its session — a
submit, a cancel, a restart — is logged, and before each step its worker
takes the turn that the process's replicas share and broadcasts them in
one record, with rank 0's hard-deadline verdict, then steps and gives
the turn up; an idle worker sends a keep-alive record where none went
out, and a worker that ends sends the stop record.  A failure other than
an injected fault is fatal there (:attr:`fatal`): the supervisor leaves
the replica down and the launcher exits non-zero.

PyTorch keeps grad mode, the current device and the current stream per
thread, so the worker sets them itself (``lockstep.worker_scope``): it
steps under ``torch.no_grad()`` and, on the card, on the engine's device
and on a stream of the replica's own, which every worker generation of
the replica takes in turn.  Replicas may overlap on the card; their
host work shares one interpreter.  Callbacks get token ids as Python
ints (``StreamEvent.tokens``, ``Result.tokens`` in numpy), never device
tensors, so no delivery syncs the card.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serve.engine import (Request, Result, ServeEngine,
                                      StreamEvent)
from repro_torch.serve.faults import FaultError
from repro_torch.serve.frontend.lockstep import (Lockstep, locksteps,
                                                 new_stream,
                                                 replica_session,
                                                 worker_scope)

# a replica whose worker hasn't completed a step (or an idle check) in
# this long while work is pending is reported unhealthy
HEALTH_STALL_S = 60.0


class ReplicaDraining(RuntimeError):
    """Raised by :meth:`Replica.submit` after :meth:`Replica.drain` —
    the replica finishes in-flight work but accepts nothing new."""


class Replica:
    def __init__(self, engine: ServeEngine, name: str = "r0",
                 lockstep: Optional[Lockstep] = None):
        """``lockstep``: rank 0's side of this replica under a mesh of
        several ranks (``lockstep.locksteps``: one turn for all the
        replicas of the process); a replica alone under such a mesh
        makes its own."""
        self.name = name
        self.engine = engine
        self.session = replica_session(engine)
        self._stream = new_stream(engine.model.device)
        self._lockstep = lockstep or locksteps([engine])[0]
        # a failure no restart mends (a collective that failed, ranks that
        # parted): the replica stays down
        self.fatal: Optional[BaseException] = None
        # health/queue-depth gauges: callback-backed, evaluated at
        # /metrics collection time (no writes from the worker loop)
        m = engine.m
        m.queue_depth.set_fn(lambda: self.session.depth)
        m.replica_healthy.set_fn(lambda: 1.0 if self.healthy else 0.0)
        if engine.pool is not None:
            m.free_pages.set_fn(lambda: engine.pool.free_pages)
        self._lock = threading.Lock()
        self._subs: Dict[int, Callable[[StreamEvent], None]] = {}
        # the per-request event log (failover): the engine
        # request plus how many tokens were already handed to delivery
        # — what take_inflight() snapshots for re-submission and what
        # replay-suppression trims on the failed-over stream
        self._inflight: Dict[int, Request] = {}
        self._delivered: Dict[int, int] = {}
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._draining = False
        self._closed = False
        self.crashed: Optional[BaseException] = None
        self._gen = 0            # worker generation (restart fencing)
        self.last_step = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"replica-{name}")
        self._thread.start()

    # ------------------------------------------------------------ intake
    def submit(self, req: Request,
               on_event: Callable[[StreamEvent], None]) -> None:
        """Queue a request; ``on_event`` fires from the worker thread
        with each incremental :class:`StreamEvent`.  Raises
        ``QueueFull`` (depth cap), ``ValueError`` (can never fit) or
        :class:`ReplicaDraining` — all synchronously."""
        if self._draining or self._closed:
            raise ReplicaDraining(f"replica {self.name} is draining")
        with self._lock:
            if req.uid in self._subs:
                raise ValueError(f"uid {req.uid} already in flight")
            self.session.submit(req)     # may raise QueueFull/ValueError
            if self._lockstep is not None:
                self._lockstep.log("submit", req)
            self._subs[req.uid] = on_event
            self._inflight[req.uid] = req
        self._idle.clear()
        self._wake.set()

    @property
    def load(self) -> int:
        """Requests in flight (the router's least-loaded signal)."""
        return self.session.depth

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def healthy(self) -> bool:
        """Worker alive and not stalled mid-step."""
        if self._closed or not self._thread.is_alive():
            return False
        return time.monotonic() - self.last_step < HEALTH_STALL_S

    def stats(self) -> Dict[str, float]:
        # ``engine.stats`` is assembled from the registry's locked
        # counters: reading it on the server thread races no worker
        return self.engine.stats

    # ------------------------------------------------------------ worker
    def _run(self) -> None:
        with worker_scope(self._stream):
            self._loop()

    def _loop(self) -> None:
        gen = self._gen
        faults = self.engine.faults
        lockstep = self._lockstep
        try:
            while not self._closed and gen == self._gen:
                if faults is not None and faults.hit(
                        "replica_worker", self.name):
                    raise FaultError(
                        f"injected replica_worker death ({self.name})")
                with self._lock:
                    if gen != self._gen:   # restarted under the lock wait
                        return
                    busy = self.session.has_work()
                    events: List[StreamEvent] = []
                    if busy and lockstep is not None:
                        with lockstep.turn.lock:     # record and step
                            expired = self.session.due_deadlines()
                            lockstep.send(True, expired)
                            events = self.session.step(expired=expired)
                            if self._stream is not None:
                                self._stream.synchronize()
                    elif busy:
                        events = self.session.step()
                    elif lockstep is not None:
                        lockstep.keepalive()
                    subs = [(self._subs.get(ev.uid), ev) for ev in events]
                    for ev in events:
                        # delivered-token accounting happens at the
                        # hand-off to delivery: once recorded here the
                        # tokens are the client's, and a later failover
                        # replay suppresses exactly this many
                        if ev.finished:
                            self._subs.pop(ev.uid, None)
                            self._inflight.pop(ev.uid, None)
                            self._delivered.pop(ev.uid, None)
                        elif ev.tokens:
                            self._delivered[ev.uid] = (
                                self._delivered.get(ev.uid, 0)
                                + len(ev.tokens))
                self.last_step = time.monotonic()
                for cb, ev in subs:
                    if cb is not None:
                        cb(ev)
                if not busy:
                    self._idle.set()
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            if (lockstep is not None and self._closed
                    and gen == self._gen):
                lockstep.stop()              # drained or closed
        except BaseException as e:          # worker death:
            # capture instead of vanishing — healthy goes False (dead
            # thread) and the supervisor drives restart + failover
            self.crashed = e
            self.engine.obs.tracer.instant(
                "replica_crash", track=self.engine.obs.label,
                args={"replica": self.name, "error": repr(e)})
            if lockstep is not None and not isinstance(e, FaultError):
                self.fatal = e
                self._end_inflight()

    # ---------------------------------------------------- fault recovery
    def cancel(self, uid: int, reason: str = "cancelled") -> bool:
        """Retire one in-flight request (client disconnect / explicit
        cancel): the session releases its pages/slot/swap
        immediately and the terminal event (``finish_reason`` =
        ``reason``) is delivered to the subscriber if one is still
        registered.  False when the uid is unknown here."""
        with self._lock:
            ev = self.session.cancel(uid, reason=reason)
            if ev is None:
                return False
            if self._lockstep is not None:
                self._lockstep.log("cancel", uid, reason)
            cb = self._subs.pop(uid, None)
            self._inflight.pop(uid, None)
            self._delivered.pop(uid, None)
        if cb is not None:
            cb(ev)
        return True

    def _end_inflight(self) -> None:
        """A fatal failure: every in-flight request gets its terminal
        event now (``finish_reason`` "error"), so that no client waits on
        a replica that will not step again."""
        for req, _, cb in self.take_inflight():
            if cb is not None:
                cb(StreamEvent(uid=req.uid, tokens=[], finished=True,
                               result=Result(uid=req.uid,
                                             tokens=np.zeros(0, np.int32),
                                             prompt_len=len(req.prompt)),
                               finish_reason="error"))

    def take_inflight(self):
        """Snapshot and clear the in-flight registrations — the
        supervisor's failover intake after a crash.  Returns
        ``[(engine_request, tokens_already_delivered, on_event), ...]``
        in uid order; afterwards this replica owns none of them."""
        with self._lock:
            out = [(self._inflight[uid], self._delivered.get(uid, 0),
                    self._subs.get(uid))
                   for uid in sorted(self._inflight)]
            self._inflight.clear()
            self._subs.clear()
            self._delivered.clear()
        return out

    def restart(self) -> None:
        """Rebuild the session (resetting the pool) and start a fresh
        worker generation — the supervisor's recovery step after
        :meth:`take_inflight`.  A merely-stalled previous worker is
        given a short grace to finish its step; either way the
        generation bump fences it out of the new session (it exits at
        its next loop check, and its late events find no subscribers)."""
        self._gen += 1
        old = self._thread
        if old.is_alive():
            # a lockstep worker may be inside a step's collectives: the
            # new one must not broadcast on the channel before it is out
            old.join(timeout=None if self._lockstep is not None else 2.0)
        self.crashed = None
        with self._lock:
            self.session = replica_session(self.engine)
            if self._lockstep is not None:
                self._lockstep.restart()
        self._subs = {}
        self._inflight = {}
        self._delivered = {}
        self._draining = False
        self._closed = False
        self._idle.set()
        self.last_step = time.monotonic()
        self.engine.m.replica_restarts.inc()
        self.engine.obs.tracer.instant(
            "replica_restart", track=self.engine.obs.label,
            args={"replica": self.name})
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"replica-{self.name}")
        self._thread.start()

    # --------------------------------------------------------- lifecycle
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop intake, finish in-flight requests, park the worker.
        Returns True once idle (False on timeout — work still live).  A
        lockstep replica whose drain times out is closed
        (:meth:`close`): its worker sends the stop record after its
        current step, so that no follower waits on it for ever."""
        self._draining = True
        self._wake.set()
        end = None if timeout is None else time.monotonic() + timeout
        while not (done := self._idle.wait(timeout=0.25)):
            if self.fatal is not None or (end is not None
                                          and time.monotonic() >= end):
                break                        # a failed lockstep: no wait
        if done or self._lockstep is not None:
            self.close()
        return done

    def close(self) -> None:
        """Hard stop: the worker exits after its current step; in-flight
        requests are abandoned (their callbacks never complete)."""
        self._draining = True
        self._closed = True
        self._wake.set()
        self._thread.join(timeout=5.0)
        self._stop_followers()

    def _stop_followers(self) -> None:
        """The stop record from the caller's thread where no worker sent
        it (the worker died first); never beside a live worker, nor over
        a channel that failed."""
        if (self._lockstep is not None and self.fatal is None
                and not self._thread.is_alive()):
            self._lockstep.stop()
