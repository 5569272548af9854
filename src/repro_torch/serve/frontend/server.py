"""Asyncio HTTP front end: OpenAI-style completions over SSE (a port of
``repro.serve.frontend.server``).

Stdlib only (asyncio + hand-rolled HTTP/1.1 — no new deps).  Endpoints:

  POST /v1/completions   JSON :class:`protocol.CompletionRequest`.
                         ``"stream": true`` answers ``text/event-stream``
                         — one ``data:`` frame per engine sync interval
                         carrying that request's NEW tokens, then a
                         terminal frame (``finished``) and ``[DONE]``.
                         Otherwise a single JSON
                         :class:`protocol.CompletionResponse`.
  GET  /healthz          router health {replica: {healthy, load}}.
  GET  /stats            per-replica engine counters, plus a
                         ``_summary`` block of TTFT/TPOT/queue-wait
                         aggregates derived from the obs registry's
                         histograms.
  GET  /metrics          Prometheus text exposition of every serve
                         series (counters, gauges, histograms) across
                         all replica registries — the scrape endpoint.

Status mapping: scheduler ``QueueFull`` → **429** (backpressure — the
wait queue is at its depth cap; retry later), validation → 400,
unknown route → 404, draining → 503, every replica down → **503 with a
``Retry-After`` hint** (transient while the supervisor restarts
workers), hard deadline exceeded → **504** with
``finish_reason="timeout"`` (non-streaming; a stream carries the
reason on its terminal chunk).

Cancellation: each completion handler watches its client
connection for EOF while it waits on engine events; a client that
disconnects mid-stream triggers ``router.cancel(uid)``, which retires
the sequence at any phase and frees its KV pages immediately — no
orphaned decode burning pool capacity.

Streaming bridge: the replica worker thread fires per-request callbacks
(`replica.py`); the handler wraps each in ``loop.call_soon_threadsafe``
pushing onto an ``asyncio.Queue`` the response writer awaits — tokens
hit the wire the same sync interval the device reports them.  Responses
set ``Connection: close`` (stream length is unknown up front; clients
read to EOF).

``Server.shutdown`` drains the router (finish in flight, refuse new)
before closing the listener — the CLI's SIGINT path.
"""

from __future__ import annotations

import asyncio
import json
from typing import Dict, Optional, Tuple

from repro_torch.serve.engine import StreamEvent
from repro_torch.serve.frontend.protocol import (SSE_DONE,
                                                 CompletionChunk,
                                                 CompletionRequest,
                                                 CompletionResponse,
                                                 sse_encode)
from repro_torch.serve.frontend.replica import ReplicaDraining
from repro_torch.serve.frontend.router import NoHealthyReplicas, Router
from repro_torch.serve.scheduler import QueueFull

_MAX_BODY = 8 << 20


def _response(status: int, body: bytes,
              ctype: str = "application/json",
              headers: Optional[Dict[str, str]] = None) -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              429: "Too Many Requests", 500: "Internal Server Error",
              503: "Service Unavailable", 504: "Gateway Timeout"}
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    return (f"HTTP/1.1 {status} {reason.get(status, 'Error')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n{extra}"
            f"Connection: close\r\n\r\n").encode() + body


def _error(status: int, msg: str,
           headers: Optional[Dict[str, str]] = None) -> bytes:
    return _response(status, json.dumps({"error": msg}).encode(),
                     headers=headers)


class Server:
    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    # --------------------------------------------------------- lifecycle
    async def start(self) -> Tuple[str, int]:
        """Bind and start accepting; returns (host, port) — port 0 in
        the constructor picks a free one)."""
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def shutdown(self, timeout: Optional[float] = 30.0) -> None:
        """Drain-on-shutdown: refuse new requests, let in-flight ones
        finish streaming, then close the listener."""
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.router.drain(timeout=timeout))
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ------------------------------------------------------------- HTTP
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            parts = line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            headers: Dict[str, str] = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            clen = int(headers.get("content-length", "0"))
            body = await reader.readexactly(min(clen, _MAX_BODY))

            if method == "POST" and path == "/v1/completions":
                await self._completions(body, reader, writer)
            elif method == "GET" and path == "/healthz":
                writer.write(_response(
                    200, json.dumps(self.router.health()).encode()))
            elif method == "GET" and path == "/stats":
                stats = self.router.stats()
                stats["_summary"] = self.router.summary()
                writer.write(_response(200, json.dumps(stats).encode()))
            elif method == "GET" and path == "/metrics":
                writer.write(_response(
                    200, self.router.metrics_text().encode(),
                    ctype="text/plain; version=0.0.4"))
            else:
                writer.write(_error(404, f"no route {method} {path}"))
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except ConnectionError:
                pass

    # ------------------------------------------------------ completions
    async def _completions(self, body: bytes,
                           reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            creq = CompletionRequest.from_json(body)
        except ValueError as e:
            writer.write(_error(400, str(e)))
            return

        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def on_event(ev: StreamEvent) -> None:   # replica worker thread
            loop.call_soon_threadsafe(q.put_nowait, ev)

        uid = self.router.assign_uid(creq)
        try:
            rep = self.router.submit(creq, on_event, uid=uid)
        except QueueFull as e:
            writer.write(_error(429, str(e)))
            return
        except ReplicaDraining:
            writer.write(_error(503, "server is draining"))
            return
        except NoHealthyReplicas as e:
            writer.write(_error(
                503, str(e),
                headers={"Retry-After":
                         str(max(1, int(round(e.retry_after_s))))}))
            return
        except ValueError as e:
            writer.write(_error(400, str(e)))
            return

        # client-disconnect watcher: the request body is
        # fully read and responses are Connection: close, so the next
        # byte a well-behaved client sends is EOF — reader.read()
        # returning means the peer hung up and we cancel the request,
        # freeing its pages instead of decoding into the void.
        eof_task = asyncio.ensure_future(reader.read())

        async def next_event() -> Optional[StreamEvent]:
            """Engine event, or None on client disconnect."""
            get = asyncio.ensure_future(q.get())
            done, _ = await asyncio.wait(
                {get, eof_task}, return_when=asyncio.FIRST_COMPLETED)
            if get in done:
                return get.result()
            get.cancel()
            return None

        try:
            if creq.stream:
                writer.write(b"HTTP/1.1 200 OK\r\n"
                             b"Content-Type: text/event-stream\r\n"
                             b"Cache-Control: no-cache\r\n"
                             b"Connection: close\r\n\r\n")
                await writer.drain()
                while True:
                    ev = await next_event()
                    if ev is None:
                        self.router.cancel(uid)
                        return
                    writer.write(sse_encode(CompletionChunk(
                        uid=ev.uid, tokens=ev.tokens, finished=ev.finished,
                        finish_reason=ev.finish_reason)))
                    await writer.drain()  # per-interval flush: tokens
                    if ev.finished:       # stream as they decode
                        break
                writer.write(SSE_DONE)
            else:
                while True:
                    ev = await next_event()
                    if ev is None:
                        self.router.cancel(uid)
                        return
                    if ev.finished:
                        break
                if ev.finish_reason == "timeout":
                    writer.write(_error(
                        504, f"deadline exceeded for request {uid}"))
                    return
                resp = CompletionResponse.from_result(
                    ev.result, replica=rep.name,
                    finish_reason=ev.finish_reason)
                writer.write(
                    _response(200, json.dumps(resp.to_json()).encode()))
        except ConnectionError:
            # write-side failure is the same client disconnect
            self.router.cancel(uid)
            raise
        finally:
            eof_task.cancel()


async def run_server(router: Router, host: str = "127.0.0.1",
                     port: int = 8000) -> None:
    """CLI entry: serve until cancelled, then drain."""
    srv = Server(router, host, port)
    await srv.start()
    print(f"serving on http://{srv.host}:{srv.port}  "
          f"(replicas: {[r.name for r in router.replicas]})", flush=True)
    try:
        await srv.serve_forever()
    except asyncio.CancelledError:
        pass
    finally:
        await srv.shutdown()
