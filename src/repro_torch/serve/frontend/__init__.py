"""Async serving front end over the continuous-batching engine (a port
of ``repro.serve.frontend``).

  protocol   wire objects: CompletionRequest/Chunk/Response + SSE
             framing — shared by the HTTP server AND the batch CLI
  replica    one ServeEngine session on a worker thread: thread-safe
             submit, callback token delivery, drain/health/load
  router     least-loaded dispatch over N data-parallel replicas,
             QueueFull failover, bounded-backoff retries,
             drain-on-shutdown
  server     stdlib-asyncio HTTP/1.1: POST /v1/completions (JSON or
             SSE streaming), /healthz, /stats; 429 backpressure,
             client-disconnect cancellation, 503 + Retry-After, 504
             deadline mapping
  supervisor replica crash/stall detection, worker restart, and
             in-flight failover with replay suppression
  lockstep   under a mesh of several ranks: rank 0's replicas send one
             record a step to the other ranks' followers

The reference's docs/serving_frontend.md describes the API surface and
its contracts, the failure model included; they hold here unchanged.
"""

from repro_torch.serve.frontend.protocol import (CompletionChunk,
                                                 CompletionRequest,
                                                 CompletionResponse,
                                                 sse_decode, sse_encode,
                                                 to_engine_request)
from repro_torch.serve.frontend.lockstep import Follower, follow
from repro_torch.serve.frontend.replica import Replica, ReplicaDraining
from repro_torch.serve.frontend.router import NoHealthyReplicas, Router
from repro_torch.serve.frontend.server import Server, run_server
from repro_torch.serve.frontend.supervisor import Supervisor

__all__ = [
    "CompletionChunk",
    "CompletionRequest",
    "CompletionResponse",
    "Follower",
    "NoHealthyReplicas",
    "Replica",
    "ReplicaDraining",
    "Router",
    "Server",
    "Supervisor",
    "follow",
    "run_server",
    "sse_decode",
    "sse_encode",
    "to_engine_request",
]
