"""Fault injection, supervision and failover in the port, against the JAX
package.

* ``FaultSpec`` / ``FaultPlan``: the parse round trip, the fire window
  and replica scoping give the reference's results on the same passes.
* The fault sites degrade without changing a stream: ``pool_alloc``
  (forced exhaustion) and ``swap_error`` (swap preemption falls back to
  recompute) give the JAX engine's uninjected streams, sampled.
* The supervisor: an ``engine_step`` raise on r0's third burst kills its
  worker mid-stream; restart and failover give every client stream equal
  to the JAX engine's uninjected one, and the restart, failover and
  recovery series tick.  A ``replica_worker`` death is restarted.
* The HTTP server: 503 with Retry-After when no replica is healthy, 504
  at a hard deadline, and a client disconnect cancels its request and
  frees its pages.

The port's side runs on the sharpened-head 2:4 params of
``tests/test_torch_serve.py``; tolerance: exact equality for tokens and
counters.
"""

import asyncio
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.faults import FaultPlan as JFaultPlan
from repro.serve.faults import FaultSpec as JFaultSpec
from repro_torch.serve.engine import Request, ServeEngine, StreamEvent
from repro_torch.serve.faults import SITES, FaultError, FaultPlan, FaultSpec
from repro_torch.serve.frontend import (CompletionRequest, Replica, Router,
                                        Server, Supervisor)
from test_torch_serve import _pruned_pair

SAMPLED = dict(temperature=0.9, top_k=20)       # the key contract bears
BASE = dict(max_batch=4, max_len=64, page_size=8, prefill_chunk=8)
SEED = 0


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    # the JAX engine draws under the partitionable threefry scheme, which
    # the port implements (its worker threads see the global setting)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        yield _pruned_pair("paper_tiny_lm")
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def _reqs(n=8, max_new=(2, 5, 9, 14)):
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, 256, size=(4, 7, 12)[i % 3],
                             dtype=np.int32), max_new[i % len(max_new)])
            for i in range(n)]


TRAFFIC = _reqs(n=6, max_new=(6, 9, 12, 14))


@pytest.fixture(scope="module")
def reference(pair):
    """The JAX engine's uninjected, sampled streams of TRAFFIC (per
    (uid, step) keys: the same for any batch, burst length or
    preemption)."""
    jm, jp, _, _ = pair
    eng = JServeEngine(jm, jp, prefix_cache=False, **SAMPLED, **BASE)
    res = eng.generate([JRequest(uid=u, prompt=p, max_new_tokens=m)
                        for u, p, m in TRAFFIC], seed=SEED)
    return {r.uid: [int(t) for t in r.tokens] for r in res}


def _engine(pair, **kw):
    _, _, tm, tp = pair
    return ServeEngine(tm, tp, **dict(BASE, **kw))


def _requests(traffic=TRAFFIC):
    return [Request(uid=u, prompt=p, max_new_tokens=m) for u, p, m in
            traffic]


# ----------------------------------------------------------------------
# the plan
# ----------------------------------------------------------------------
SPECS = ("replica_worker:after=3,count=2,replica=r1",
         "slow_burst:delay_s=0.25", "engine_step",
         " pool_alloc : after=1 , count=3", "swap_error:replica= r0 ")


def test_fault_spec_parse_and_window_match_reference():
    assert SITES == ("engine_step", "replica_worker", "pool_alloc",
                     "slow_burst", "swap_error")
    for text in SPECS:
        t, j = FaultSpec.parse(text), JFaultSpec.parse(text)
        assert (t.site, t.after, t.count, t.delay_s, t.replica) == (
            j.site, j.after, j.count, j.delay_s, j.replica), text
        t.validate()
    for bad in ("nonsense", "engine_step:bogus=1"):
        for spec, plan in ((FaultSpec, FaultPlan), (JFaultSpec, JFaultPlan)):
            with pytest.raises(ValueError):
                plan([spec.parse(bad)])
    for kw in (dict(count=0), dict(after=-1), dict(delay_s=-1.0)):
        with pytest.raises(ValueError):
            FaultPlan([FaultSpec("engine_step", **kw)])
    passes = [("pool_alloc", None), ("pool_alloc", "r0"), ("swap_error",
                                                          "r1"),
              ("pool_alloc", "r1"), ("swap_error", "r0"),
              ("pool_alloc", None), ("pool_alloc", None)]
    out = []
    for plan in (FaultPlan.parse(["pool_alloc:after=2,count=2",
                                  "swap_error:replica=r0"]),
                 JFaultPlan.parse(["pool_alloc:after=2,count=2",
                                   "swap_error:replica=r0"])):
        out.append(([plan.hit(*p) is not None for p in passes],
                    dict(plan.fired)))
    assert out[0] == out[1]
    assert out[0][0] == [False, False, False, True, True, True, False]
    assert not FaultPlan() and FaultPlan().hit("engine_step") is None


def test_fault_plan_replica_scoping():
    plan = FaultPlan([FaultSpec("replica_worker", after=1, replica="r1")])
    assert all(plan.hit("replica_worker", "r0") is None for _ in range(5))
    assert plan.hit("replica_worker", "r1") is None       # pass 1 = after
    assert plan.hit("replica_worker", "r1") is not None   # pass 2 fires
    assert plan.hit("replica_worker", "r1") is None       # quiet again
    assert plan.fired == {"replica_worker": 1}
    hook = FaultPlan([FaultSpec("engine_step", replica="r0")])
    hook.burst_hook("r1")                                 # not r0's pass
    with pytest.raises(FaultError, match="replica=r0"):
        hook.burst_hook("r0")


# ----------------------------------------------------------------------
# the pool's sites
# ----------------------------------------------------------------------
def test_pool_alloc_fault_gives_the_jax_streams(pair, reference):
    plan = FaultPlan([FaultSpec("pool_alloc", after=3, count=3)])
    eng = _engine(pair, prefix_cache=False, faults=plan, **SAMPLED)
    got = eng.generate(_requests(), seed=SEED)
    assert plan.fired["pool_alloc"] == 3
    assert {r.uid: [int(t) for t in r.tokens] for r in got} == reference
    eng.pool.check_invariants()


def test_swap_error_degrades_to_recompute_with_the_jax_streams(pair,
                                                               reference):
    """With the arena failing, every preemption recomputes: the streams
    are the JAX engine's, nothing swaps, nothing leaks."""
    on = _engine(pair, prefix_cache=False, num_pages=7, **SAMPLED)
    on.generate(_requests(), seed=SEED)
    assert on.stats["preempt_swap"] > 0          # the arena works ...
    plan = FaultPlan([FaultSpec("swap_error", count=1000)])
    eng = _engine(pair, prefix_cache=False, num_pages=7, faults=plan,
                  **SAMPLED)
    got = eng.generate(_requests(), seed=SEED)
    assert {r.uid: [int(t) for t in r.tokens] for r in got} == reference
    st = eng.stats                               # ... and here it fails
    assert st["preempt_swap"] == 0 and st["swap_out_pages"] == 0
    assert st["preempt_recompute"] > 0 and plan.fired["swap_error"] > 0
    eng.pool.check_invariants()
    assert eng.pool.arena.free_slots == eng.pool.arena.capacity


def test_engine_step_fault_raises_before_dispatch(pair):
    """The burst seam fires before the burst is dispatched: the step
    raises, the pool's accounting still holds, and a fresh session on
    the same engine serves."""
    plan = FaultPlan([FaultSpec("engine_step", after=1)])
    eng = _engine(pair, faults=plan)
    ses = eng.session()
    for r in _requests()[:2]:
        ses.submit(r)
    ses.step()
    before = eng.stats["host_syncs"]
    with pytest.raises(FaultError):
        ses.step()
    assert eng.stats["host_syncs"] == before     # nothing was read back
    eng.pool.check_invariants()
    assert len(eng.generate(_requests()[:2])[1].tokens) == TRAFFIC[1][2]


# ----------------------------------------------------------------------
# the supervisor
# ----------------------------------------------------------------------
def _serve_through(router, sup, reqs, timeout=60.0):
    lock = threading.Lock()
    toks, done = {}, {}

    def make_cb(uid):
        def cb(ev: StreamEvent) -> None:
            with lock:
                toks.setdefault(uid, []).extend(ev.tokens)
                if ev.finished:
                    done[uid] = ev
        return cb

    for r in reqs:
        router.submit_request(r, make_cb(r.uid))
    deadline = time.monotonic() + timeout
    while len(done) < len(reqs):
        assert time.monotonic() < deadline, f"stuck: done={sorted(done)}"
        sup.check_once()
        time.sleep(0.01)
    return toks, done


def test_supervisor_failover_streams_equal_jax(pair, reference):
    """An injected raise on r0's third burst kills its worker mid-stream:
    the supervisor restarts it and re-submits its in-flight requests with
    the delivered prefix suppressed; every client stream equals the JAX
    engine's uninjected one."""
    kw = dict(steps_per_sync=2, prefix_cache=False, **SAMPLED)
    plan = FaultPlan([FaultSpec("engine_step", after=2)])
    r0 = Replica(_engine(pair, faults=plan, **kw), name="r0")
    r1 = Replica(_engine(pair, **kw), name="r1")
    router = Router([r0, r1])
    sup = Supervisor(router)
    try:
        toks, done = _serve_through(router, sup, _requests())
        recovered = r0.crashed is None and r0.healthy
    finally:
        sup.stop()
        router.close()
    assert plan.fired["engine_step"] == 1 and recovered
    assert toks == reference
    assert {ev.finish_reason for ev in done.values()} <= {"stop", "length"}
    s0 = r0.engine.m.snapshot()
    assert s0["replica_restarts"] == 1 and s0["failed_over"] >= 1
    rec = r0.engine.obs.metrics.get("serve_recovery_seconds")
    assert rec.hist_count() == 1
    for r in (r0, r1):
        r.engine.pool.check_invariants()


def test_replica_worker_death_and_restart(pair):
    plan = FaultPlan([FaultSpec("replica_worker")])
    rep = Replica(_engine(pair, faults=plan), name="r0")
    router = Router([rep])                 # the first worker pass kills it
    sup = Supervisor(router)
    try:
        deadline = time.monotonic() + 30
        while rep.healthy and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not rep.healthy and isinstance(rep.crashed, FaultError)
        assert sup.check_once() == ["r0"]
        assert rep.healthy and rep.crashed is None
        out = router.complete([CompletionRequest(prompt=[1, 2, 3],
                                                 max_tokens=3, uid=0)])
        assert len(out[0].tokens) == 3 and out[0].replica == "r0"
        assert rep.engine.m.snapshot()["replica_restarts"] == 1
    finally:
        sup.stop()
        router.close()


# ----------------------------------------------------------------------
# the HTTP server
# ----------------------------------------------------------------------
async def _post(host, port, obj):
    body = json.dumps(obj).encode()
    r, w = await asyncio.open_connection(host, port)
    w.write(f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await w.drain()
    data = await r.read()
    w.close()
    head, _, rest = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), head, rest


def test_server_503_retry_after_and_504_deadline(pair):
    """No healthy replica: 503 with a Retry-After header.  An expired
    wire ``deadline_ms``: 504, and the deadline counter ticks."""
    plan = FaultPlan([FaultSpec("replica_worker")])
    dead = Router([Replica(_engine(pair, faults=plan), name="r0")])
    rep = Replica(_engine(pair), name="r0")
    live = Router([rep])

    async def scenario():
        deadline = time.monotonic() + 30
        while dead.replicas[0].healthy and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        srv = Server(dead, port=0)
        host, port = await srv.start()
        status, head, _ = await _post(host, port, {"prompt": [1, 2],
                                                   "max_tokens": 2})
        assert status == 503 and b"retry-after: 1" in head.lower(), head
        srv._server.close()
        await srv._server.wait_closed()
        srv = Server(live, port=0)
        host, port = await srv.start()
        status, _, rest = await _post(host, port, {
            "prompt": [1, 2, 3], "max_tokens": 30, "deadline_ms": 0.0})
        assert status == 504 and b"deadline exceeded" in rest, rest
        await srv.shutdown(timeout=30)

    try:
        asyncio.run(scenario())
        assert rep.engine.stats["deadline_exceeded"] == 1
    finally:
        dead.close()
        live.close()


def test_client_disconnect_cancels_and_frees_pages(pair):
    eng = _engine(pair, prefix_cache=False, steps_per_sync=1)
    rep = Replica(eng, name="r0")
    router = Router([rep])
    full = eng.pool.free_pages

    async def scenario():
        srv = Server(router, port=0)
        host, port = await srv.start()
        body = json.dumps({"prompt": [1, 2, 3, 4], "max_tokens": 50,
                           "stream": True}).encode()
        r, w = await asyncio.open_connection(host, port)
        w.write(f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await w.drain()
        await r.readuntil(b"\n\n")        # the stream is flowing: hang up
        w.close()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if rep.load == 0 and eng.pool.free_pages == full:
                break
            await asyncio.sleep(0.02)
        assert rep.load == 0, "the request was not cancelled"
        assert eng.pool.free_pages == full, "the disconnect leaked pages"
        eng.pool.check_invariants()
        srv._server.close()
        await srv._server.wait_closed()

    try:
        asyncio.run(scenario())
        assert eng.stats["cancelled"] == 1
    finally:
        router.close()
