"""The port's serving front end against the JAX package's.

* Protocol: the wire objects' JSON and the SSE frames byte for byte.
* Router: two replicas, sampled, give the streams of the JAX router and
  of one engine's ``generate``, whichever replica served a request.
* HTTP: SSE streams (more than one frame each) equal to the batch
  engine's and to the JAX server's for the same uids; non-stream JSON
  equal to the concatenated stream; /healthz, /stats, 404 and 400; 429
  at the queue cap; ``/metrics`` family names, help, types and label
  sets equal to the JAX server's after the same traffic, and the
  deterministic counters (tokens, host syncs, device steps, prefill
  chunks, prefix hits, requests) equal per replica.
* The CLI: continuous batch mode prints the reference CLI's tokens for a
  checkpoint the reference wrote; ``--server`` answers a streamed
  completion and drains on SIGTERM.

Params: the sharpened-head 2:4 ones of ``tests/test_torch_serve.py``;
tolerance: exact equality for tokens, bytes and counters.
"""

import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.store import save_pytree
from repro.serve.frontend import CompletionChunk as JChunk
from repro.serve.frontend import CompletionRequest as JCReq
from repro.serve.frontend import CompletionResponse as JCResp
from repro.serve.frontend import Server as JServer
from repro.serve.frontend import sse_decode as j_sse_decode
from repro.serve.frontend import sse_encode as j_sse_encode
from repro.serve.frontend import to_engine_request as j_to_engine_request
from repro_torch.serve.engine import Request, Result, ServeEngine
from repro_torch.serve.frontend import (CompletionChunk, CompletionRequest,
                                        CompletionResponse, Router, Server,
                                        sse_decode, sse_encode,
                                        to_engine_request)
from test_torch_serve import ROOT, _pruned_pair

SAMPLED = dict(temperature=0.9, top_k=20)
BASE = dict(max_batch=4, max_len=64, page_size=8, prefill_chunk=8,
            steps_per_sync=2)


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
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        yield _pruned_pair("paper_tiny_lm")
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(scope="module")
def jrouter(pair):
    """The JAX launcher's router of the file: two sampled replicas on one
    registry (their compiles are the cost), shared by the router, HTTP
    and /metrics cases."""
    from repro.launch.serve import make_router as j_make_router
    from repro.serve.config import ServeConfig as JServeConfig

    jm, jp, _, _ = pair
    router = j_make_router(jm, jp, JServeConfig(replicas=2, **SAMPLED,
                                                **BASE))
    yield router
    router.close()


def _router(pair, n=2, **kw):
    """The port launcher's router: ``n`` replicas on one registry."""
    from repro_torch.launch.serve import make_router
    from repro_torch.serve.config import ServeConfig

    _, _, tm, tp = pair
    return make_router(tm, tp, ServeConfig(replicas=n, **dict(
        BASE, **SAMPLED, **kw)))


def _traffic(n=8, max_new=(5, 9, 12, 7), seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 256, size=(4, 7, 12)[i % 3]).tolist(),
             max_new[i % len(max_new)]) for i in range(n)]


# ----------------------------------------------------------------------
# protocol
# ----------------------------------------------------------------------
BODIES = (
    {"prompt": [1, 2, 3], "max_tokens": 4, "stream": True, "priority": 2,
     "deadline_ms": 500.0, "uid": 7},
    {"prompt": [9]},
    {"prompt": [5, 6], "deadline_ms": None, "uid": None, "max_tokens": "3"},
)
BAD = (b"not json", b"[1,2]", b'{"prompt": []}', b'{"prompt": ["a"]}',
       b'{"prompt": [1], "max_tokens": 0}', b'\xff\xfe')


def test_protocol_and_sse_bytes_equal_reference():
    for obj in BODIES:
        body = json.dumps(obj).encode()
        t, j = CompletionRequest.from_json(body), JCReq.from_json(body)
        assert vars(t) == vars(j)
        tr = to_engine_request(t, uid=11, now=100.0)
        jr = j_to_engine_request(j, uid=11, now=100.0)
        assert (tr.uid, tr.max_new_tokens, tr.priority, tr.deadline,
                tr.deadline_hard) == (jr.uid, jr.max_new_tokens,
                                      jr.priority, jr.deadline,
                                      jr.deadline_hard)
        np.testing.assert_array_equal(tr.prompt, jr.prompt)
        assert tr.prompt.dtype == np.int32
    for bad in BAD:
        msgs = []
        for cls in (CompletionRequest, JCReq):
            with pytest.raises(ValueError) as e:
                cls.from_json(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    chunks = [(1, [5, 6], False, None), (1, [], True, "length"),
              (2, [7], True, "cancelled")]
    wire = b"".join(sse_encode(CompletionChunk(*c)) for c in chunks)
    jwire = b"".join(j_sse_encode(JChunk(*c)) for c in chunks)
    assert wire == jwire
    wire += b"data: [DONE]\n\n" + sse_encode(CompletionChunk(9, [1]))
    assert [vars(c) for c in sse_decode(wire)] == [
        vars(c) for c in j_sse_decode(wire)] == [
        dict(uid=u, tokens=t, finished=f, finish_reason=r)
        for u, t, f, r in chunks]
    res = Result(uid=3, tokens=np.asarray([4, 5], np.int32), prompt_len=6,
                 decode_steps=3, preemptions=1)
    t = CompletionResponse.from_result(res, replica="r1",
                                       finish_reason="stop")
    j = JCResp.from_result(res, replica="r1", finish_reason="stop")
    assert json.dumps(t.to_json()) == json.dumps(j.to_json())


# ----------------------------------------------------------------------
# router
# ----------------------------------------------------------------------
def test_router_two_replica_sampled_parity_with_jax_router(pair, jrouter):
    """The streams do not depend on which replica served a request: the
    port's two replicas, the JAX router's two and one port engine's
    ``generate`` all give the same tokens."""
    traffic = _traffic()
    creqs = [dict(prompt=p, max_tokens=m, uid=u) for u, p, m in traffic]
    router = _router(pair)
    try:
        got = router.complete([CompletionRequest(**c) for c in creqs])
    finally:
        router.close()
    want = jrouter.complete([JCReq(**c) for c in creqs])
    _, _, tm, tp = pair
    one = ServeEngine(tm, tp, **BASE, **SAMPLED).generate(
        [Request(uid=u, prompt=np.asarray(p, np.int32), max_new_tokens=m)
         for u, p, m in traffic])
    assert sorted({c.replica for c in got}) == ["r0", "r1"]
    assert [(c.uid, c.tokens) for c in got] == [
        (c.uid, c.tokens) for c in want] == [
        (r.uid, r.tokens.tolist()) for r in one]
    assert [c.prompt_len for c in got] == [c.prompt_len for c in want]


# ----------------------------------------------------------------------
# HTTP
# ----------------------------------------------------------------------
async def _request(host, port, method, path, obj=None):
    body = json.dumps(obj).encode() if obj is not None else b""
    r, w = await asyncio.open_connection(host, port)
    w.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await w.drain()
    data = await r.read()
    w.close()
    head, _, rest = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


def _post(host, port, obj):
    return _request(host, port, "POST", "/v1/completions", obj)


def _serve(router, scenario):
    """Run ``scenario(host, port)`` against a server over ``router``."""

    async def main():
        srv = Server(router, port=0) if isinstance(router, Router) else \
            JServer(router, port=0)
        host, port = await srv.start()
        try:
            return await scenario(host, port)
        finally:
            srv._server.close()
            await srv._server.wait_closed()

    return asyncio.run(main())


def test_http_streams_match_batch_and_jax_server(pair, jrouter):
    traffic = _traffic(n=6)

    async def scenario(host, port):
        outs = await asyncio.gather(*[
            _post(host, port, {"prompt": p, "max_tokens": m, "uid": u,
                               "stream": True}) for u, p, m in traffic])
        whole = await _post(host, port, {"prompt": traffic[1][1],
                                         "max_tokens": traffic[1][2],
                                         "uid": traffic[1][0]})
        extra = [await _request(host, port, "GET", path)
                 for path in ("/healthz", "/stats", "/nope")]
        extra.append(await _post(host, port, {"prompt": "nope"}))
        return outs, whole, extra

    router = _router(pair)
    try:
        outs, whole, extra = _serve(router, scenario)
    finally:
        router.close()
    jouts, jwhole, _ = _serve(jrouter, scenario)
    _, _, tm, tp = pair
    batch = {r.uid: r.tokens.tolist() for r in ServeEngine(
        tm, tp, **BASE, **SAMPLED).generate(
        [Request(uid=u, prompt=np.asarray(p, np.int32), max_new_tokens=m)
         for u, p, m in traffic])}
    for (u, _, _), (status, rest), (jstatus, jrest) in zip(traffic, outs,
                                                           jouts):
        assert status == jstatus == 200
        chunks = sse_decode(rest)
        assert len(chunks) > 1 and chunks[-1].finished
        assert chunks[-1].finish_reason == "length"
        toks = [t for c in chunks for t in c.tokens]
        assert toks == batch[u]
        assert toks == [t for c in j_sse_decode(jrest) for t in c.tokens]
        assert rest.endswith(b"data: [DONE]\n\n")
    status, body = whole
    obj, jobj = json.loads(body), json.loads(jwhole[1])
    assert status == 200 and obj["tokens"] == batch[traffic[1][0]]
    assert {k: v for k, v in obj.items() if k != "replica"} == {
        k: v for k, v in jobj.items() if k != "replica"}
    (hs, hb), (ss, sb), (ns, _), (bs, _) = extra
    assert hs == 200 and json.loads(hb) == {
        "r0": {"healthy": True, "load": 0}, "r1": {"healthy": True,
                                                   "load": 0}}
    stats = json.loads(sb)
    assert ss == 200 and set(stats) == {"r0", "r1", "_summary"}
    assert stats["_summary"]["ttft_count"] == len(traffic) + 1
    assert (ns, bs) == (404, 400)


def test_http_backpressure_429(pair):
    """One slot and a queue of one: a burst of 6 concurrent long
    requests sees a 429, and every accepted one completes."""
    router = _router(pair, n=1, max_batch=1, queue_depth=1)

    async def scenario(host, port):
        return await asyncio.gather(*[
            _post(host, port, {"prompt": [1, 2, 3, i], "max_tokens": 20,
                               "uid": i}) for i in range(6)])

    try:
        outs = _serve(router, scenario)
        rejected = router.replicas[0].engine.m.rejected.value
    finally:
        router.close()
    statuses = sorted(s for s, _ in outs)
    assert statuses[0] == 200 and statuses[-1] == 429, statuses
    assert rejected == statuses.count(429)
    for status, body in outs:
        if status == 200:
            assert len(json.loads(body)["tokens"]) == 20
        else:
            assert b"depth cap" in body


_SAMPLE = re.compile(r"^([a-z_]+)(?:\{(.*)\})? (\S+)$")
DETERMINISTIC = ("serve_tokens_total", "serve_host_syncs_total",
                 "serve_device_steps_total", "serve_prefill_chunks_total",
                 "serve_prefix_hit_tokens_total", "serve_requests_total",
                 "serve_prefill_tokens_total",
                 "serve_prefix_pages_reused_total", "sparse_dispatch_total",
                 "serve_slot_steps_total")


def _parse(text):
    """(metadata lines, {(series, labels): value}) of an exposition."""
    meta = [ln for ln in text.splitlines() if ln.startswith("#")]
    samples = {}
    for ln in text.splitlines():
        if ln.startswith("#"):
            continue
        m = _SAMPLE.match(ln)
        assert m, ln
        samples[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return meta, samples


def test_metrics_families_and_counters_match_jax_server(pair, jrouter):
    """Sequential traffic — one request after the other, a prompt sent
    twice so the prefix index serves it — through both servers: the
    expositions carry the same families (HELP / TYPE lines), the same
    label sets, and equal deltas of the deterministic counters.  The
    prompts are new to the JAX router's prefix index, which holds the
    earlier cases' pages."""
    traffic = _traffic(n=3, seed=1)
    traffic.append((3, traffic[2][1], 5))

    async def scenario(host, port):
        before = (await _request(host, port, "GET", "/metrics"))[1]
        for u, p, m in traffic:
            status, _ = await _post(host, port, {
                "prompt": p, "max_tokens": m, "uid": 100 + u,
                "stream": bool(u % 2)})
            assert status == 200
        return before.decode(), (await _request(host, port, "GET",
                                                "/metrics"))[1].decode()

    router = _router(pair)
    try:
        before, after = _serve(router, scenario)
    finally:
        router.close()
    jbefore, jafter = _serve(jrouter, scenario)
    meta, got = _parse(after)
    jmeta, want = _parse(jafter)
    assert meta == jmeta
    assert {k for k in got} == {k for k in want}
    assert {k[1] for k in got if not k[0].endswith("_bucket")} == {
        'replica="r0"', 'replica="r1"'}
    base, jbase = _parse(before)[1], _parse(jbefore)[1]
    for (name, labels), v in got.items():
        if name in DETERMINISTIC:
            assert v - base.get((name, labels), 0) == (
                want[(name, labels)] - jbase.get((name, labels), 0)), (
                name, labels)
    assert got[("serve_prefix_hit_tokens_total", 'replica="r0"')] > 0
    assert got[("serve_tokens_total", 'replica="r0"')] == sum(
        m for _, _, m in traffic)
    assert got[("serve_replica_healthy", 'replica="r1"')] == 1


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def test_cli_batch_prints_the_reference_cli_tokens(pair, tmp_path, capsys,
                                                   monkeypatch):
    """Continuous batch mode goes through ``make_router`` and
    ``Router.complete`` in both launchers: on a checkpoint the reference
    wrote, the printed streams are equal line for line."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    path = str(tmp_path / "pruned_params")
    save_pytree(path, pair[1], extra={"method": "mag"})
    argv = ["--arch", "paper-tiny-lm", "--smoke", "--params", path,
            "--sparse", "--requests", "5", "--max-new", "6",
            "--max-batch", "2", "--steps-per-sync", "2", "--sampling",
            "top-k", "--temperature", "0.9", "--top-k", "20"]
    serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    want = capsys.readouterr().out

    def reqs(text):
        return [ln for ln in text.splitlines() if ln.startswith("req ")]

    assert len(reqs(got)) == 4 and reqs(got) == reqs(want)
    assert "30 tokens in" in got and "30 tokens in" in want
    assert "packed 14 2:4-sparse weights" in got


def test_cli_server_answers_and_drains_on_sigterm():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "paper-tiny-lm", "--smoke", "--device", "cpu", "--server",
         "--port", "0", "--replicas", "2", "--queue-depth", "4"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = proc.stdout.readline()
        m = re.match(r"serving on http://([\d.]+):(\d+)\s+\(replicas: "
                     r"\['r0', 'r1'\]\)", line)
        assert m, line
        host, port = m.group(1), int(m.group(2))
        status, rest = asyncio.run(_post(host, port, {
            "prompt": [3, 1, 4, 1, 5], "max_tokens": 6, "stream": True}))
        chunks = sse_decode(rest)
        assert status == 200 and chunks[-1].finished
        assert len([t for c in chunks for t in c.tokens]) == 6
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "draining..." in out


def test_cli_batch_drains_on_sigterm():
    """SIGTERM in the middle of the continuous batch (bursts slowed by an
    injected ``slow_burst``) takes Ctrl-C's path: "draining...", the
    router's in-flight requests finish, exit 0 — no summary, since the
    batch did not complete."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "paper-tiny-lm", "--smoke", "--device", "cpu", "--magnitude-24",
         "--sparse", "--requests", "2", "--max-new", "8",
         "--steps-per-sync", "2", "--replicas", "2", "--inject-fault",
         "slow_burst:count=1000,delay_s=0.5"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("packed "), line
        time.sleep(0.5)                 # inside Router.complete's bursts
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "draining..." in out and "tokens in" not in out, out
