"""The serve CLI's router, its replicas and the HTTP server under a mesh
of two CPU ranks (``gloo``), against one device.

* the server: ``python -m repro_torch.launch.serve --server --mesh 1x2
  --device cpu --replicas 2`` as two processes (RANK / WORLD_SIZE /
  MASTER_PORT set, as ``torchrun`` sets them), rank 0 on port 0 with
  each replica's group timeout at ``SERVER_TIMEOUT_S``: idle for three
  timeouts first (an idle follower blocked in its broadcast would time
  out without rank 0's keep-alives), then six concurrent streamed
  completions, a client that hangs up mid-stream (the cancel goes to
  the followers as an op) and one more completion — every stream equal
  to the same model's on one device; ``engine_step`` injected without a
  replica (the fourth step of either replica: the ranks step the
  replicas one at a time in the same order, so it raises on both ranks
  at the same burst, with requests in flight — the supervisor restarts
  that replica and fails them over) and ``replica_worker`` on r1 (rank
  0's alone, mirrored as a restart op); SIGTERM to both ranks: each
  prints "draining..." and exits 0;
* a follower killed outright: rank 0's next keep-alive fails and it
  exits non-zero;
* on ``tests/torch_dist_worker.py``'s gloo ranks (``_server_cases``):
  the batch CLI with ``--replicas 2`` under ``--mesh 1x2`` prints one
  device's streams in continuous mode (the router, and a follower a
  replica on rank 1) and static mode; a ``replica_worker`` death armed
  once r0 has streamed a token — it dies with requests in flight, the
  supervisor restarts it and fails them over, and every stream equals
  one device's; a drain that times out with a request in flight, which
  stops the follower;
* what the streams are held to, the CLI's model on one device, against
  the JAX engine's greedy streams;
* on two cards (skipped without them), the server over NCCL.
"""

import asyncio
import json
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

import torch_dist_worker as W
from repro_torch.serve.frontend import sse_decode

ROOT = Path(__file__).resolve().parents[1]
IDLE_S = 3 * W.SERVER_TIMEOUT_S
AFTER_CANCEL = (100, [7, 7, 7], 12)   # the request after the cancel
BATCH_CLI = ["--requests", "4", "--max-new", "6"]
SERVER = W.SERVER_ARGS + [
    "--mesh", "1x2", "--server", "--port", "0", "--replicas", "2",
    "--group-timeout", str(W.SERVER_TIMEOUT_S),
    "--inject-fault", "engine_step:after=3",
    "--inject-fault", "replica_worker:after=40,replica=r1"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(argv, env=None):
    """The serve CLI as the two ranks of a 1x2 mesh (``env``: variables
    beside the rendezvous's); rank 0's port once it prints where it
    serves (None if it never does)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2", **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        cwd=ROOT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    lines, up = [], queue.Queue()

    def pump():                       # rank 0's output, line by line
        for line in procs[0].stdout:
            lines.append(line)
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            if m:
                up.put(int(m.group(1)))
                return
        up.put(None)                  # it ended first

    threading.Thread(target=pump, daemon=True).start()
    try:
        return procs, lines, up.get(timeout=300)
    except queue.Empty:
        return procs, lines, None


def _finish(procs, lines, sig=signal.SIGTERM):
    """Signal both ranks (None: none) and wait: [(exit code, output)]."""
    if sig is not None:
        for p in procs:
            p.send_signal(sig)
    out = []
    for i, p in enumerate(procs):
        try:
            text = p.communicate(timeout=120)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            text = p.communicate()[0]
        out.append((p.returncode,
                    ("".join(lines) if i == 0 else "") + (text or "")))
    return out


async def _request(port, method, path, obj=None, hang_up=False):
    return await asyncio.wait_for(
        _exchange(port, method, path, obj, hang_up), timeout=120)


async def _exchange(port, method, path, obj, hang_up):
    body = json.dumps(obj).encode() if obj is not None else b""
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await w.drain()
    if hang_up:                       # leave after the first SSE frame
        await r.readuntil(b"\r\n\r\n")
        await r.readuntil(b"\n\n")
        w.close()
        return None
    data = await r.read()
    w.close()
    head, _, rest = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), rest


def _stream(port, uid, prompt, max_new):
    return _request(port, "POST", "/v1/completions",
                    {"prompt": prompt, "max_tokens": max_new, "uid": uid,
                     "stream": True})


def _tokens(reply):
    status, rest = reply
    chunks = sse_decode(rest)
    assert status == 200 and chunks and chunks[-1].finished, reply
    return [t for ch in chunks for t in ch.tokens]


def _metric(text, name, replica):
    m = re.search(rf'^{name}{{replica="{replica}"}} (\S+)$', text, re.M)
    return float(m.group(1)) if m else None


@pytest.fixture(scope="module")
def served():
    """One run of the two-rank server through every scenario, and the
    one-device streams of its requests."""
    reqs = W.server_requests()
    after = AFTER_CANCEL
    want = W.one_device_streams(reqs + [after])
    procs, lines, port = _start(SERVER)
    out = {"want": want, "port": port}
    try:
        assert port is not None, "".join(lines)
        t0 = time.monotonic()
        time.sleep(IDLE_S)

        async def scenario():
            got = await asyncio.gather(*[_stream(port, *r) for r in reqs])
            out["idle_s"] = time.monotonic() - t0
            await _request(port, "POST", "/v1/completions",
                           {"prompt": [9, 9, 9], "max_tokens": 40,
                            "uid": 50, "stream": True}, hang_up=True)
            got.append(await _stream(port, *after))
            _, metrics = await _request(port, "GET", "/metrics")
            return got, metrics.decode()

        got, out["metrics"] = asyncio.run(scenario())
        out["streams"] = [_tokens(g) for g in got]
    finally:
        out["ranks"] = _finish(procs, lines)
    return out


def test_one_device_streams_equal_jax_engine():
    """What every stream of this file is held to — the CLI's model served
    on one device, ``W.one_device_streams`` and the batch CLI without a
    mesh — equals the JAX engine's greedy streams of the same weights:
    the server's requests, the failover case's and the batch CLI's."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.ckpt.store import _unflatten_into
    from repro.configs import get_smoke as j_get_smoke
    from repro.models import LM as JLM
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(W.SERVER_ARGS + BATCH_CLI)
    cfg, model, params = serve.load_model(args)
    cli = [(c.uid, c.prompt, c.max_tokens)
           for c in serve._random_requests(cfg, args)]
    reqs = [(i, p, m) for i, (_, p, m) in enumerate(
        W.server_requests() + [AFTER_CANCEL] + W.server_requests(8, 16)
        + cli)]
    jm = JLM(j_get_smoke(args.arch))
    jp = jax.tree.map(jnp.asarray, _unflatten_into(
        jax.eval_shape(jm.init, jax.random.key(0)),
        model.params_to_flat(params)))
    want = [np.asarray(r.tokens).tolist() for r in JServeEngine(
        jm, jp, mode="static", max_batch=4, max_len=64).generate(
        [JRequest(uid=u, prompt=np.asarray(p, np.int32), max_new_tokens=m)
         for u, p, m in reqs])]
    assert [len(w) for w in want] == [m for _, _, m in reqs]
    assert W.one_device_streams(reqs) == want
    one, err = W._cli(W.SERVER_ARGS + BATCH_CLI)
    assert err is None
    printed = [line.split(": ", 1)[1].split("  [")[0]
               for line in one.splitlines() if line.startswith("req ")]
    assert printed == [str(w) for w in want[-len(cli):]]


def test_server_streams_equal_one_device(served):
    assert served["streams"] == served["want"]


def test_idle_server_outlives_its_group_timeout(served):
    """The first requests came after three group timeouts of idling."""
    assert served["idle_s"] >= IDLE_S
    assert served["streams"][0] == served["want"][0]


def test_cancel_mid_stream_reaches_every_rank(served):
    text = served["metrics"]
    cancelled = sum(_metric(text, "requests_cancelled_total", r) or 0
                    for r in ("r0", "r1"))
    assert cancelled == 1
    assert served["streams"][-1] == served["want"][-1]


def test_injected_faults_restart_and_fail_over(served):
    """Two restarts — ``engine_step``'s, on whichever replica made the
    fourth step, and ``replica_worker``'s on r1 — and requests failed
    over, with every stream still one device's."""
    text = served["metrics"]
    restarts = [_metric(text, "replica_restarts_total", r) or 0
                for r in ("r0", "r1")]
    assert sum(restarts) == 2 and restarts[1] >= 1
    assert sum(_metric(text, "requests_failed_over_total", r) or 0
               for r in ("r0", "r1")) >= 1
    assert served["streams"] == served["want"]


def test_sigterm_drains_every_rank(served):
    for code, text in served["ranks"]:
        assert code == 0, text[-2000:]
        assert "draining..." in text


def test_dead_follower_ends_rank_0():
    """A follower killed outright: rank 0's next keep-alive broadcast
    fails, and it exits non-zero — nothing serves on at a smaller
    width."""
    procs, lines, port = _start(W.SERVER_ARGS + [
        "--mesh", "1x2", "--server", "--port", "0",
        "--group-timeout", str(W.SERVER_TIMEOUT_S)])
    try:
        assert port is not None, "".join(lines)
        procs[1].kill()
        procs[1].wait(timeout=30)
        code = procs[0].wait(timeout=60)
    finally:
        ranks = _finish(procs, lines, sig=None)
    assert code != 0, ranks[0][1][-2000:]
    assert "failed" in ranks[0][1]


@pytest.mark.cuda
@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two cards: one rank of an NCCL group each")
@pytest.mark.parametrize("replicas", [1, 2])
def test_nccl_server_on_two_cards(replicas):
    """The server under ``--mesh 1x2 --device cuda``, one card a rank over
    NCCL: three rounds of eight concurrent streamed completions (with two
    replicas, both busy at once) equal one card's streams, and SIGTERM
    ends both ranks with exit 0.  A round that hangs aborts both ranks,
    whose threads' stacks (``PYTHONFAULTHANDLER``) the failure shows."""
    argv = [a if a != "cpu" else "cuda" for a in W.SERVER_ARGS]
    rounds = [[(100 * r + u, [1 + u, 2, 3 + r, 4 + u, 5, 6], 10)
               for u in range(8)] for r in range(3)]
    want = W.one_device_streams([q for rnd in rounds for q in rnd], argv)
    procs, lines, port = _start(argv + [
        "--mesh", "1x2", "--server", "--port", "0", "--replicas",
        str(replicas)], env={"PYTHONFAULTHANDLER": "1"})
    got, hung = [], False
    try:
        assert port is not None, "".join(lines)
        for rnd in rounds:
            async def burst(rnd=rnd):
                return await asyncio.wait_for(asyncio.gather(
                    *[_stream(port, *q) for q in rnd]), timeout=60)
            try:
                got += [_tokens(g) for g in asyncio.run(burst())]
            except asyncio.TimeoutError:
                hung = True
                break
    finally:
        ranks = _finish(procs, lines,
                        sig=signal.SIGABRT if hung else signal.SIGTERM)
    assert not hung, "\n".join(text[-8000:] for _, text in ranks)
    assert got == want
    for code, text in ranks:
        assert code == 0, text[-2000:]
        assert "draining..." in text


@pytest.fixture(scope="module")
def gloo_ranks():
    return W.run_groups((2,), None, None, timeout=600.0,
                        cases="tp_server")[2]


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_batch_cli_replicas_under_a_mesh(gloo_ranks, mode):
    def streams(text):      # the router names the replica that served
        return [line.split("  [")[0] for line in text.splitlines()
                if line.startswith("req ")]

    one, _ = W._cli(W.SERVER_ARGS + BATCH_CLI
                    + (["--serve-mode", "static"] if mode == "static"
                       else []))
    out, err = gloo_ranks[0]["cli"][mode]
    assert err is None
    assert len(streams(out)) == 4 and streams(out) == streams(one)
    assert "mesh 1x2" in out
    if mode == "continuous":
        assert {"[r0]", "[r1]"} <= set(re.findall(r"\[r\d\]", out))
    assert gloo_ranks[1]["cli"][mode][0] == ""   # rank 1 prints nothing


def test_worker_death_mid_stream_fails_over(gloo_ranks):
    death = gloo_ranks[0]["death"]
    assert death["fired"] == {"replica_worker": 1}
    assert death["restarts"] == 1 and death["failed_over"] >= 1
    assert "r0" in death["placed"].values()
    assert death["streams"] == death["one_device"]
    assert all(n > 0 for n in gloo_ranks[1]["death"]["steps"])


def test_drain_timeout_stops_the_followers(gloo_ranks):
    """A drain that times out with a request in flight closes the lockstep
    replica: its stop record ends the follower, which would otherwise
    wait in its broadcast until the group's timeout ended its process —
    both ranks come back."""
    drain = gloo_ranks[0]["drain"]
    assert drain["drained"] is False
    assert 0 < drain["tokens"] < W.DRAIN_MAX_NEW
    assert not drain["worker_alive"]
    assert gloo_ranks[1]["drain"]["steps"][0] > 0
