"""The front end under a mesh of several ranks: rank 0's replicas and
the other ranks' followers, stepping in lockstep.

The reference's server is one controller over every device of its mesh;
here every process is one rank.  So rank 0 alone binds the port and runs
the server, the router, the replica worker threads and the supervisor —
it takes requests at times of its own — and every other rank runs one
follower thread (:func:`follow`), which mirrors each of rank 0's
replicas with the same ``ServeEngine`` session (a :class:`Follower`).

One record a step, one step at a time.  Before every ``session.step()``
of a replica, rank 0 broadcasts one record (:class:`Lockstep`): the
replica it is for, the engine requests submitted since that replica's
last record, the cancels and a restart, in the order rank 0 applied
them, the hard-deadline verdict of rank 0's clock, and whether to step
or stop.  The records of every replica go over one control group
(:func:`control_group`), and a replica's worker holds the turn
(:class:`Turn`) from its record to the end of its step: so every rank
runs one replica's collectives at a time, in the order of the records.
The follower thread applies each record to its replica's session and
steps it; the sessions are the same when they step, so their bursts make
the same collectives, and the engine's plan digest
(``ServeEngine._agree``) stays the guard against plans that part.  While
no record goes out rank 0 sends an empty one every :func:`keepalive_s`
— well under the control group's timeout, past which a follower blocked
in the broadcast would fail.

Why one at a time: replicas that stepped at once on every rank would
make their collectives in whatever order each rank's threads made them.
On ``gloo`` that deadlocks or sums the wrong tensors where they share a
group — so each replica's engine also has a channel of its own
(``dist.comm.open_channel``: its model group, its data group and its
world group); on ``nccl`` not even communicators of their own suffice,
since kernels of several communicators that wait on each other across
the ranks need not make progress together on one device.  On the card
each worker thread launches on a stream of its own
(:func:`worker_scope`), and a replica's turn ends once its stream is
idle, so that the next turn's collectives never overlap it.

Faults: a ``replica_worker`` death is rank 0's (its worker loop); the
supervisor's restart is mirrored as a ``restart`` op and the failed-over
requests as submits.  The sites inside a step (``engine_step``,
``pool_alloc``, ``swap_error``, ``slow_burst``) count the same passes
in the same order on every rank, so they fire on every rank at the same
point — a follower whose step raises
:class:`~repro_torch.serve.faults.FaultError` waits for rank 0's
restart.  Any other failure — a collective that fails because a rank
died, or ranks whose plans part — is fatal: the process exits non-zero,
and nothing carries on at a smaller width.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.dist import comm
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import FaultError

# the longest wait between two records of an idle rank 0; a quarter of
# the control group's timeout where that is shorter
KEEPALIVE_S = 5.0
# every replica's session seed, on every rank: sampling is keyed per
# (uid, step) from it, so one seed for all is what makes a request's
# stream the same on any replica (the router's parity contract) and the
# followers' sessions the same as rank 0's
SEED = 0


def replica_session(engine: ServeEngine):
    """A replica's session, rank 0's and its followers' alike: SEED, and
    the engine's ``ServeConfig.queue_depth`` as its wait-queue cap."""
    return engine.session(seed=SEED, max_waiting=engine.config.queue_depth)


def new_stream(device) -> Optional[torch.cuda.Stream]:
    """A stream of its own for one worker thread on ``device``: None on
    the CPU."""
    device = torch.device(device)
    return torch.cuda.Stream(device) if device.type == "cuda" else None


@contextlib.contextmanager
def worker_scope(stream):
    """A worker thread's torch state, which PyTorch keeps per thread:
    grad mode off (the kernel wrappers refuse inputs that require grad
    while it is on) and, on the card, the device and the current stream
    of ``stream``.  The stream first waits for the work queued so far on
    the device's default stream (the weights, a session that another
    thread built); on the way out the thread waits for its stream, so
    that nothing it queued outlives it."""
    if stream is None:
        with torch.no_grad():
            yield
        return
    with torch.no_grad(), torch.cuda.device(stream.device), \
            torch.cuda.stream(stream):
        stream.wait_stream(torch.cuda.default_stream(stream.device))
        try:
            yield
        finally:
            stream.synchronize()


def control_group(engines: Sequence[ServeEngine]):
    """The group that carries every replica's records: the world group
    of the first replica's channel (its timeout is the one the followers
    wait with)."""
    return comm.world_of(engines[0].mesh, engines[0].channel)


def keepalive_s(engine: ServeEngine) -> float:
    """The keep-alive interval of ``engine``'s channel."""
    timeout = None if engine.channel is None else engine.channel.timeout
    return KEEPALIVE_S if timeout is None else min(KEEPALIVE_S, timeout / 4)


class Turn:
    """What rank 0's replicas share: the control group, and the lock that
    one replica holds from its record to the end of its step (a
    re-entrant lock: a turn's record is sent inside it)."""

    def __init__(self, engines: Sequence[ServeEngine]):
        self.group = control_group(engines)
        self.interval = keepalive_s(engines[0])
        self.lock = threading.RLock()
        self.last = time.monotonic()      # the last record, of any replica


class Lockstep:
    """Rank 0's side of replica ``index`` (the followers' ``r{index}``).
    The replica logs each op under its lock as it applies it to its
    session; its worker thread sends the records."""

    def __init__(self, turn: Turn, index: int):
        self.turn = turn
        self.index = index
        self._ops: List[tuple] = []
        self.stopped = False

    def log(self, *op) -> None:
        """One op: ("submit", Request) or ("cancel", uid, reason)."""
        self._ops.append(op)

    def restart(self) -> None:
        """The session was rebuilt: the ops of the old one are void."""
        self._ops = [("restart",)]

    def send(self, step: bool, expired: Sequence[int] = (),
             stop: bool = False) -> None:
        rec = {"replica": self.index, "ops": self._ops, "step": step,
               "expired": list(expired), "stop": stop}
        self._ops = []
        with self.turn.lock:
            comm.broadcast_object(rec, self.turn.group)
            if torch.cuda.is_initialized():   # NCCL returns at once: the
                torch.cuda.current_stream().synchronize()   # record is out
            self.turn.last = time.monotonic()

    def keepalive(self) -> None:
        """An empty record, where none went out for the interval."""
        with self.turn.lock:
            if time.monotonic() - self.turn.last >= self.turn.interval:
                self.send(False)

    def stop(self) -> None:
        """The replica's last record: the followers stop mirroring it."""
        if not self.stopped:
            self.stopped = True
            self.send(False, stop=True)


def locksteps(engines: Sequence[ServeEngine]) -> List[Optional[Lockstep]]:
    """Rank 0's :class:`Lockstep` for each of ``engines`` (one
    :class:`Turn` for all of them) under a mesh of several ranks; None
    for each without one."""
    if engines[0].ranks == 1:
        return [None] * len(engines)
    turn = Turn(engines)
    return [Lockstep(turn, i) for i in range(len(engines))]


class Follower:
    """One replica's mirror on a rank other than 0: its own session of
    ``engine``, to which :func:`follow`'s thread applies rank 0's
    records."""

    def __init__(self, engine: ServeEngine, name: str):
        self.engine = engine
        self.name = name
        self.session = replica_session(engine)
        self.steps = 0

    def apply(self, rec: dict) -> None:
        for op in rec["ops"]:
            if op[0] == "submit":
                self.session.submit(op[1])
            elif op[0] == "cancel":
                self.session.cancel(op[1], reason=op[2])
            else:
                self.session = replica_session(self.engine)
        if rec["step"]:
            try:
                self.session.step(expired=rec["expired"])
            except FaultError:
                # rank 0's step raised at the same pass: its
                # supervisor's restart comes as the next op
                pass
            self.steps += 1


def follow(engines: Sequence[ServeEngine]) -> List[Follower]:
    """A rank other than 0: one :class:`Follower` a replica (``r0``,
    ``r1``, ... as rank 0's router names them), stepped by one thread in
    the order of rank 0's records until every replica's stop record.
    SIGTERM and Ctrl-C print "draining..." and change nothing else: rank
    0 drains and stops every replica.  A follower that fails ends the
    process (:func:`die`)."""
    followers = [Follower(e, f"r{i}") for i, e in enumerate(engines)]
    group = control_group(engines)
    stream = new_stream(engines[0].model.device)
    failed: List[BaseException] = []

    def run() -> None:
        live = set(range(len(followers)))
        try:
            with worker_scope(stream):
                while live:
                    rec = comm.broadcast_object(None, group)
                    followers[rec["replica"]].apply(rec)
                    if rec["stop"]:
                        live.discard(rec["replica"])
        except BaseException as e:           # fatal: the process exits 1
            failed.append(e)

    said = []

    def draining(signum, frame):
        if not said:
            said.append(signum)
            print("draining...", flush=True)

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, draining)
        except ValueError:                   # not the main thread
            pass
    thread = threading.Thread(target=run, daemon=True, name="followers")
    try:
        thread.start()
        while thread.is_alive():
            thread.join(timeout=0.25)
        if failed:
            die(f"the followers failed: {failed[0]!r}")
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return followers


def die(msg: str) -> None:
    """End a rank of a failed lockstep at once, exit code 1: its other
    threads may be blocked in collectives that will never complete, which
    neither an orderly interpreter exit nor a drain would wait out."""
    print(msg, file=sys.stderr, flush=True)
    sys.stdout.flush()
    os._exit(1)
