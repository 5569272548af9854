"""Wire objects for the serving front end (a port of
``repro.serve.frontend.protocol``; the JSON is the reference's, byte for
byte).

OpenAI-completions-shaped, minus a tokenizer: the repo has none, so
``prompt`` is a token-id array (the OpenAI API accepts exactly that
form) and responses carry token ids.  One set of request/response
objects serves every entry point — the HTTP server, the router, and
``launch/serve.py``'s batch path — so there is no parallel prompt-list
plumbing to drift.

``CompletionRequest.deadline_ms`` is a *relative* SLA budget (ms from
arrival); :func:`to_engine_request` converts it to the absolute
``time.monotonic()`` timestamp ``serve.scheduler`` orders admission by.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serve.engine import Request, Result


@dataclasses.dataclass
class CompletionRequest:
    """One completion call, as posted to ``/v1/completions``."""

    prompt: List[int]                    # token ids (no tokenizer in repo)
    max_tokens: int = 16
    stream: bool = False
    priority: int = 0                    # higher admits first
    deadline_ms: Optional[float] = None  # SLA budget relative to arrival
    uid: Optional[int] = None            # client-chosen id; router assigns
    #                                      a fresh one when omitted

    @classmethod
    def from_json(cls, body: bytes) -> "CompletionRequest":
        try:
            obj = json.loads(body)
        except (ValueError, UnicodeDecodeError) as e:
            raise ValueError(f"body is not valid JSON: {e}") from None
        if not isinstance(obj, dict):
            raise ValueError("body must be a JSON object")
        prompt = obj.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise ValueError("'prompt' must be a non-empty list of "
                             "token ids (ints)")
        req = cls(
            prompt=prompt,
            max_tokens=int(obj.get("max_tokens", 16)),
            stream=bool(obj.get("stream", False)),
            priority=int(obj.get("priority", 0)),
            deadline_ms=(float(obj["deadline_ms"])
                         if obj.get("deadline_ms") is not None else None),
            uid=(int(obj["uid"]) if obj.get("uid") is not None else None),
        )
        if req.max_tokens < 1:
            raise ValueError("'max_tokens' must be >= 1")
        return req


def to_engine_request(creq: CompletionRequest, uid: int,
                      now: Optional[float] = None) -> Request:
    """Lower a wire request to the engine's :class:`Request`, pinning
    the relative ``deadline_ms`` to an absolute monotonic timestamp at
    admission time.  A wire deadline is HARD: past it the
    engine retires the request with ``finish_reason="timeout"`` — the
    server's HTTP 504 — instead of silently truncating."""
    if now is None:
        now = time.monotonic()
    return Request(
        uid=uid,
        prompt=np.asarray(creq.prompt, np.int32),
        max_new_tokens=creq.max_tokens,
        priority=creq.priority,
        deadline=(now + creq.deadline_ms / 1e3
                  if creq.deadline_ms is not None else None),
        deadline_hard=creq.deadline_ms is not None,
    )


@dataclasses.dataclass
class CompletionChunk:
    """One SSE event: the NEW tokens a request accrued at one engine
    sync (never a replay — the session dedups preemption recompute)."""

    uid: int
    tokens: List[int]
    finished: bool = False
    finish_reason: Optional[str] = None   # stop|length|timeout|cancelled
    #                                       on the terminal chunk

    def to_json(self) -> Dict[str, Any]:
        return {"id": self.uid, "object": "completion.chunk",
                "tokens": self.tokens, "finished": self.finished,
                "finish_reason": self.finish_reason}


@dataclasses.dataclass
class CompletionResponse:
    """Terminal response (non-streaming call, or the summary a client
    can reassemble from its chunks)."""

    uid: int
    tokens: List[int]
    prompt_len: int
    decode_steps: int = 0
    preemptions: int = 0
    replica: Optional[str] = None        # which replica served it
    finish_reason: Optional[str] = None  # stop|length|timeout|cancelled

    @classmethod
    def from_result(cls, r: Result, replica: Optional[str] = None,
                    finish_reason: Optional[str] = None
                    ) -> "CompletionResponse":
        return cls(uid=r.uid, tokens=[int(t) for t in r.tokens],
                   prompt_len=r.prompt_len, decode_steps=r.decode_steps,
                   preemptions=r.preemptions, replica=replica,
                   finish_reason=finish_reason)

    def to_json(self) -> Dict[str, Any]:
        return {"id": self.uid, "object": "completion",
                "tokens": self.tokens, "prompt_len": self.prompt_len,
                "decode_steps": self.decode_steps,
                "preemptions": self.preemptions, "replica": self.replica,
                "finish_reason": self.finish_reason}


# ---------------------------------------------------------------- SSE
SSE_DONE = b"data: [DONE]\n\n"


def sse_encode(chunk: CompletionChunk) -> bytes:
    """One server-sent event frame (``data: <json>\\n\\n``)."""
    return b"data: " + json.dumps(chunk.to_json()).encode() + b"\n\n"


def sse_decode(stream: bytes) -> List[CompletionChunk]:
    """Parse a full SSE byte stream back into chunks (test/client
    helper; stops at the ``[DONE]`` sentinel)."""
    chunks: List[CompletionChunk] = []
    for frame in stream.split(b"\n\n"):
        frame = frame.strip()
        if not frame.startswith(b"data: "):
            continue
        payload = frame[len(b"data: "):]
        if payload == b"[DONE]":
            break
        obj = json.loads(payload)
        chunks.append(CompletionChunk(
            uid=obj["id"], tokens=obj["tokens"], finished=obj["finished"],
            finish_reason=obj.get("finish_reason")))
    return chunks
