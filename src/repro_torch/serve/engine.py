"""Serving engine: continuous batching over a paged serve cache, or
static prompt-length buckets over a dense cache.

Continuous mode (the default) is a step loop over serve.scheduler:
requests join the running batch as soon as a slot and prompt pages are
free, their prompts stream in as fixed-size token chunks interleaved
with everyone else's decode, and the decode inner loop runs as a burst
of ``steps_per_sync`` steps with the state on the device (serve.fused) —
one host readback per burst.  When the pool runs dry the youngest
request is preempted: swapped to the host arena when it has room
(tokens kept, resume mid-stream), recomputed otherwise — always
recomputed for a model with recurrent state (Mamba, the xLSTM), whose
state rows the arena does not tier; admission resets a slot's state rows
(kvpool.StatePool).  Admission consults the pool's prefix index: cached
prompt pages attach shared, without prefill, with copy-on-write on
divergence (serve.kvpool; no index for recurrent state).  A
session can cancel a request anywhere in its lifecycle, and retires
requests whose hard deadline has passed.

Decoding is greedy at temperature 0 and sampled otherwise (top-k /
top-p filtering optional).  Every continuous-mode draw is keyed per
(request uid, step) off the session's ``key(seed)``, so a stream does
not depend on the batch, on ``steps_per_sync`` or on preemption: a
recompute replays the same tokens.

Static mode (``mode="static"``) buckets requests by prompt length; a
bucket is one batched prefill into a dense cache and one device loop
(serve.fused.static_burst) over its decode steps, read back once.  Each
bucket's key is the next ``split`` of ``key(seed)``.  A MoE model serves
static whatever mode is asked, as in the reference: expert capacity
drops tokens by the batch's routing, so a row's logits depend on the
other rows, which continuous batching's guarantees (a stream independent
of the batch, bit-exact recompute) cannot carry.  So does a model with a
modality frontend — the prefix-LM and the encoder-decoder — and any
engine given ``extra_batch`` (the frontend's ``frontend_feats`` (B, F,
fd), a row per request of the bucket, or one row for all): the paged
cache holds neither a bidirectional prefix nor cross K / V, as in the
reference.  A prefix-LM's decode positions start past its frontend_len
prefix positions.  ``engine.mode`` is the effective mode;
``config.mode`` stays as asked.

Under a mesh (``mesh=``, or the active ``dist.use_mesh`` context; the
reference's ``ServeEngine``) every process is one rank and runs this
same engine on the same requests.  A model axis > 1 is tensor-parallel
serving: the params are packed first and then sharded
(``dist.sharding.shard_params`` under the model's config: whole
attention heads, Mamba's d_inner channels, whole mLSTM / sLSTM heads, a
block of the experts), each rank's pool holds its KV heads and its
width of the recurrent state rows (``StatePool``'s init rows too), and
the layers make one all-reduce a block and all-gather the logits, so
every rank samples the same tokens — the prefix-LM's frontend prefix
and the encoder-decoder's encoder output too.  A MoE's experts dispatch
expert-parallel:
the tokens of a bucket split over data route in each data rank's rows,
those of a bucket every rank holds in the reference's token blocks
(``models.moe``).  The ranks' schedules
are the same because the scheduler is deterministic and reads only what
every rank holds alike; the one wall-clock decision, the hard-deadline
sweep, is rank 0's, broadcast.  Before each burst the ranks compare a
digest of its plan (burst length, chunk, slots, positions, block tables)
and raise if they differ, instead of parting in a collective.  The data
axis replicates continuous mode's schedule, pool and burst state (the
reference replicates them over ``data``); in static mode a bucket whose
rows divide over the data axes splits them (the reference's
``_place_batch``), each data rank decodes its rows — drawing the whole
bucket's noise when sampling, its rows of ``extra_batch`` with them — and
the tokens are all-gathered.  Every rank returns the same results; the
launcher prints rank 0's.  An engine's collectives take its ``channel``
(``dist.comm.open_channel``): each of the front end's replicas has one,
so that two replicas stepping at times of their own never share a group
(``serve.frontend.lockstep``).

Counters, latency histograms and request spans go to the engine's
:class:`~repro_torch.obs.Obs` bundle (``obs=``; the serve launcher
shares one among its replicas, each under its own label) through
:class:`~repro_torch.serve.metrics.ServeMetrics`, which the scheduler
and the pool bind too.  ``engine.stats`` is the reference's flat view
over them, re-based at each ``generate()``.  The ``engine_step`` and
``slow_burst`` fault sites (serve.faults) fire on the host just before
each burst dispatch, before anything of the burst is launched.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.dist import comm
from repro_torch.dist.api import current_ctx, use_mesh
from repro_torch.dist.mesh import dp_axes_of
from repro_torch.dist.sharding import (batch_sharding, model_shard,
                                       shard_params)
from repro_torch.obs import Obs
from repro_torch.serve import fused
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.kvpool import PagedKVPool, StatePool
from repro_torch.serve.metrics import POOL_KEYS, SCHED_KEYS, ServeMetrics
from repro_torch.serve.scheduler import Scheduler, SeqState
from repro_torch.serve.sparse import compressed_param_tree, count_packed

STAT_KEYS = ("requests", "tokens", "host_syncs", "device_steps",
             "prefill_chunks", "slot_steps", "cancelled",
             "deadline_exceeded", *SCHED_KEYS, *POOL_KEYS, "decode_wall_s",
             "sparse_dispatch", "kv_quant_pages", "replica_restarts",
             "failed_over")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                   # (L,) int32
    max_new_tokens: int = 16
    priority: int = 0                    # wait-queue order: higher first,
    deadline: Optional[float] = None     # then earlier deadline, arrival
    # deadline is a time.monotonic() stamp; with deadline_hard set the
    # request is also retired once it passes (finish_reason "timeout")
    deadline_hard: bool = False


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray                   # generated tokens (≤ max_new)
    prompt_len: int
    decode_steps: int = 0                # steps the slot was live for
    preemptions: int = 0                 # times preempted (swap or
    #                                      recompute)

    @property
    def utilization(self) -> float:
        """Emitted tokens / slot-steps occupied."""
        if self.decode_steps <= 0:
            return 0.0
        return len(self.tokens) / self.decode_steps


@dataclasses.dataclass
class StreamEvent:
    """One request's newly emitted tokens at one host sync (a recompute
    replays the delivered prefix, which the session suppresses).  The
    final event carries ``result`` and ``finish_reason``: "stop" (EOS),
    "length" (max_new_tokens), "timeout" (hard deadline) or
    "cancelled"."""

    uid: int
    tokens: List[int]
    finished: bool = False
    result: Optional[Result] = None
    finish_reason: Optional[str] = None


def effective_mode(cfg, mode: str, extra_batch=None) -> str:
    """The mode an engine serves ``cfg`` in when ``mode`` is asked: a MoE
    model, a modality-frontend model (prefix-LM, encoder-decoder) and an
    engine with ``extra_batch`` serve static (see the module
    docstring)."""
    paged_ok = (cfg.moe is None and not cfg.encdec and cfg.frontend is None
                and not extra_batch)
    return mode if paged_ok else "static"


class ServeEngine:
    def __init__(self, model, params, config: Optional[ServeConfig] = None,
                 *, extra_batch: Optional[Dict[str, torch.Tensor]] = None,
                 obs: Optional[Obs] = None, mesh=None, channel=None,
                 **knobs):
        """``config`` carries every knob; bare keywords build one (or
        override fields of the given one).  Validation happens once, in
        ``ServeConfig.validate``.  ``extra_batch``: batch entries beside
        the tokens that every bucket's prefill takes (a frontend model's
        ``frontend_feats``).  ``obs`` is the metrics / trace bundle
        (default: a private one from ``config.metrics`` / ``trace``).
        ``mesh``: a DeviceMesh to serve under (default: the active
        context's; see the module docstring); ``channel``: the groups its
        collectives take (a ``dist.comm.Channel``; None: the mesh's own).
        ``params`` may be another engine's on the same mesh: the leaves
        that already are this rank's blocks stay as they are."""
        if config is None:
            config = ServeConfig(**knobs)
        elif knobs:
            config = dataclasses.replace(config, **knobs)
        config.validate()
        self.config = config
        self.model = model
        self.max_batch, self.max_len = config.max_batch, config.max_len
        if mesh is None:
            ctx = current_ctx()
            mesh = ctx.mesh if ctx is not None else None
        self.mesh = mesh
        self.channel = channel
        self.tp = model_shard(mesh).count
        self.dp_axes = dp_axes_of(mesh) if mesh is not None else ()
        self.dp = batch_sharding(mesh).count if mesh is not None else 1
        self.ranks = mesh.mesh.numel() if mesh is not None else 1
        # compressed-weight serving: leaves that verify as 2:4 are packed
        # ONCE at load, so the device holds only (vals, idx) — and then
        # each rank's blocks of them (whole heads a rank)
        if config.sparse_weights == "auto":
            params = compressed_param_tree(params)
        self.n_sparse_leaves = count_packed(params)
        if self.tp > 1:
            params = shard_params(params, mesh, cfg=model.cfg)
        self.params = params
        self.extra_batch = extra_batch or {}
        self.mode = effective_mode(model.cfg, config.mode, self.extra_batch)
        self.eos = -1 if config.eos_id is None else int(config.eos_id)
        self.sampling = dict(temperature=config.temperature,
                             top_k=config.top_k, top_p=config.top_p)
        self.steps_per_sync = config.steps_per_sync
        self.page_size = config.page_size
        self.chunk_size = config.prefill_chunk
        if obs is None:
            obs = Obs.create(metrics=config.metrics, trace=config.trace)
        self.obs = obs
        self.m = ServeMetrics(obs)
        self._stats_base: Dict[str, float] = {}
        self.faults = config.faults
        self.pool = None
        self.state_pool = None
        self._swap_ok = False
        if self.mode == "static":
            return                    # a dense cache per bucket, no pool
        with self._context():           # the pool holds this rank's heads
            self.pool = PagedKVPool(
                model, num_pages=config.resolved_num_pages(),
                page_size=config.page_size, max_slots=config.max_batch,
                max_len=config.max_len,
                dtype=torch.int8 if config.kv_dtype == "int8" else None,
                prefix_cache=config.prefix_cache,
                host_swap_pages=config.resolved_swap_pages(), obs=obs,
                faults=self.faults)
            state = StatePool(model, self.pool.kv)   # the rank's widths
        self.state_pool = state if state.has_state else None
        # swap preemption preserves KV pages only: recurrent-state rows
        # live outside the page pool, so those models keep recompute
        self._swap_ok = (self.state_pool is None
                         and self.pool.arena is not None)
        # output ring: burst length + 1 for a prefill burst's token 0
        self._ring = self.steps_per_sync + 1

    def _context(self, data: bool = False):
        """The engine's mesh as the context of the model calls it makes
        (in whichever thread runs them); ``data``: a bucket whose rows
        split over the data axes, which a MoE layer routes whole —
        replicated work routes per rank.  A null context without a
        mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_mesh(self.mesh, self.dp_axes, split_rows=data,
                        channel=self.channel)

    def _agree(self, plan) -> None:
        """Raise unless every rank is about to run the same ``plan`` (a
        burst's digest), before any collective of it can part."""
        if self.ranks == 1:
            return
        mine = hashlib.blake2b(repr(plan).encode(),
                               digest_size=8).hexdigest()
        every = comm.all_gather_object(
            mine, comm.world_of(self.mesh, self.channel))
        if len(set(every)) > 1:
            raise RuntimeError(
                f"serve ranks parted: burst plan digests {every} differ "
                f"(this rank's plan: {plan!r})")

    @property
    def stats(self) -> Dict[str, float]:
        """The flat counter view (engine, scheduler and pool series) read
        from the registry: cumulative since the engine was built,
        re-based at each ``generate()``.  Reading it races no worker
        thread: the registry's counters are locked."""
        cur = self.m.snapshot()
        base = self._stats_base
        return {k: cur[k] - base.get(k, 0) for k in STAT_KEYS}

    def session(self, seed: int = 0, max_waiting: Optional[int] = None
                ) -> "ContinuousSession":
        """An incremental session: ``submit`` at any time, each ``step()``
        is one host-sync interval returning per-request StreamEvents.
        ``seed`` keys sampled decoding; ``max_waiting`` caps the wait
        queue (``scheduler.QueueFull`` past it, the front end's 429)."""
        if self.mode != "continuous":
            raise RuntimeError(
                "streaming sessions need the continuous paged runtime "
                f"(engine is mode={self.mode!r})")
        return ContinuousSession(self, seed=seed, max_waiting=max_waiting)

    def generate(self, requests: Sequence[Request], seed: int = 0
                 ) -> List[Result]:
        """Serve a set of requests (continuous batching; static mode
        buckets by prompt length); ``self.stats`` then holds the run's
        counters.  ``seed`` keys sampled decoding."""
        self._stats_base = self.m.snapshot()   # the registry is monotonic
        if self.mode == "static":
            return self._generate_static(requests, seed)
        session = self.session(seed)
        for r in requests:
            session.submit(r)
        results: List[Result] = []
        while session.has_work():
            for ev in session.step():
                if ev.finished:
                    results.append(ev.result)
        return sorted(results, key=lambda r: r.uid)

    # ------------------------------------------------------ static mode
    def _generate_static(self, requests: Sequence[Request], seed: int
                         ) -> List[Result]:
        """Buckets by prompt length, in length order, at most
        ``max_batch`` a bucket; each bucket runs under the next split of
        the run's key: ``key, bucket_key = split(key)``."""
        buckets: Dict[int, List[Request]] = {}
        for r in requests:
            buckets.setdefault(len(r.prompt), []).append(r)
        results: List[Result] = []
        key = rnd.key(seed, self.model.device)
        for plen in sorted(buckets):
            bucket = buckets[plen]
            for i in range(0, len(bucket), self.max_batch):
                key, bk = rnd.split(key).unbind(0)
                results.extend(self._run_bucket(
                    bucket[i:i + self.max_batch], bk))
        return sorted(results, key=lambda r: r.uid)

    def _run_bucket(self, reqs: List[Request], key: torch.Tensor
                    ) -> List[Result]:
        """One batched prefill into a dense cache, then the whole decode
        loop on the device and ONE host readback.  Under a mesh whose
        data axes divide the bucket, a data rank runs its rows and the
        tokens are all-gathered."""
        b = len(reqs)
        plen = len(reqs[0].prompt)
        off = self.model.prefix_len or 0     # the prefix-LM's frontend rows
        max_new = max(r.max_new_tokens for r in reqs)
        if off + plen + max_new > self.max_len:
            raise ValueError("bucket exceeds max_len")
        split = self.dp > 1 and b % self.dp == 0
        rows = batch_sharding(self.mesh, self.dp_axes).rows(b) if split \
            else slice(0, b)
        mine = reqs[rows]
        bl = len(mine)
        dev = self.model.device
        toks = torch.from_numpy(np.stack([np.asarray(r.prompt, np.int32)
                                          for r in mine])).to(dev)
        extra = {k: v[rows] if v.shape[0] >= b else v[:1].expand(
            bl, *v.shape[1:]) for k, v in self.extra_batch.items()}
        # EOS off and one max_new_tokens: the done scan could never fire
        # early, so the fori variant drops that bookkeeping
        early_exit = not (self.config.eos_id is None
                          and len({r.max_new_tokens for r in reqs}) == 1)
        max_new_arr = np.asarray([r.max_new_tokens for r in mine], np.int32)
        with self._context(data=split):
            cache = self.model.init_cache(bl, self.max_len)
            logits = self.model.prefill(self.params, toks, cache, **extra)
            t0 = time.monotonic()
            out, n_emitted, steps_run = fused.static_burst(
                self.model, self.params, cache, logits, key, max_new_arr,
                off + plen, max_new, early_exit=early_exit, eos=self.eos,
                rows=(rows.start, b) if split else None, **self.sampling)
        if split:
            group = comm.group_of(self.mesh, self.dp_axes, self.channel)
            out = comm.all_gather_rows(out, group)
            n_emitted = comm.all_gather_rows(n_emitted, group)
            steps_run = comm.all_reduce_(steps_run.reshape(1).clone(),
                                         group, op=comm.MAX)
        blob = torch.cat([out.reshape(-1), n_emitted,
                          steps_run.reshape(1)]).cpu().numpy()
        out = blob[:b * max_new].reshape(b, max_new)   # ONE sync a bucket
        n_emitted = blob[b * max_new:b * max_new + b]
        steps = int(blob[-1])
        t1 = time.monotonic()
        m = self.m
        m.decode_wall.inc(t1 - t0)
        m.host_syncs.inc()
        m.device_steps.inc(steps)
        m.burst_steps.observe(steps)
        m.requests.inc(b)
        m.tokens.inc(int(n_emitted.sum()))
        m.slot_steps.inc(steps * b)
        self.obs.tracer.complete(
            "static_bucket", t0, t1, track=self.obs.label,
            args={"batch": b, "prompt_len": plen, "steps": steps})
        # every request holds its slot for the whole bucket: the gap to
        # n_emitted is the scrap-position waste continuous batching saves
        return [Result(uid=r.uid, tokens=out[i, :n_emitted[i]].copy(),
                       prompt_len=plen, decode_steps=steps)
                for i, r in enumerate(reqs)]


class ContinuousSession:
    """Step-driven view of the continuous-batching loop: each
    :meth:`step` admits, maps page capacity (may preempt), then makes ONE
    device dispatch — the K-step decode burst, or a prompt chunk fused in
    front of it — and reads the state back once."""

    def __init__(self, engine: ServeEngine, seed: int = 0,
                 max_waiting: Optional[int] = None):
        self.engine = engine
        engine.pool.reset()
        self.sched = Scheduler(engine.pool, engine.max_batch,
                               max_waiting=max_waiting,
                               swap=engine._swap_ok, obs=engine.obs)
        self.base_key = rnd.key(seed, engine.model.device)
        self._emitted: Dict[int, int] = {}    # uid -> tokens delivered

    def submit(self, req: Request):
        """Queue a request (admitted at the next step).  Raises
        ``ValueError`` for one that can never fit and
        ``scheduler.QueueFull`` past ``max_waiting``."""
        if len(req.prompt) + req.max_new_tokens > self.engine.max_len:
            raise ValueError(f"request {req.uid} exceeds max_len")
        return self.sched.submit(req)

    def has_work(self) -> bool:
        return self.sched.has_work()

    @property
    def depth(self) -> int:
        """Requests in flight, waiting and slotted (the router's load)."""
        return len(self.sched.waiting) + len(self.sched.running)

    def _event(self, seq) -> Optional[StreamEvent]:
        sent = self._emitted.get(seq.req.uid, 0)
        new = [int(t) for t in seq.tokens[sent:]]
        fin = seq.state is SeqState.FINISHED
        if not new and not fin:
            return None
        self._emitted[seq.req.uid] = sent + len(new)
        m = self.engine.m
        if new and sent == 0 and seq.first_tok_ts == 0.0:
            # the first delivered token (a recompute's replay is
            # suppressed above, so this fires once a request)
            seq.first_tok_ts = time.monotonic()
            m.ttft.observe(seq.first_tok_ts - seq.submit_ts)
            m.obs.tracer.instant("first_token", track=m.label,
                                 args={"uid": seq.req.uid})
        result = reason = None
        if fin:
            self._emitted.pop(seq.req.uid, None)
            if seq.first_tok_ts and len(seq.tokens) > 1:
                m.tpot.observe((time.monotonic() - seq.first_tok_ts)
                               / (len(seq.tokens) - 1))
            m.obs.tracer.async_end("request", seq.req.uid, track=m.label,
                                   args={"tokens": len(seq.tokens),
                                         "preemptions": seq.preemptions})
            result = _result(seq)
            reason = ("stop" if len(seq.tokens) < seq.req.max_new_tokens
                      else "length")
        return StreamEvent(uid=seq.req.uid, tokens=new, finished=fin,
                           result=result, finish_reason=reason)

    def cancel(self, uid: int, reason: str = "cancelled"
               ) -> Optional[StreamEvent]:
        """Retire a request anywhere in its lifecycle — waiting,
        mid-prefill, mid-decode or swapped out.  Pages, slot and arena
        slots are released at once; returns the terminal event (no new
        tokens, ``finish_reason`` = ``reason``), or None for an unknown
        uid (already finished, or never submitted)."""
        seq = self.sched.cancel(uid)
        if seq is None:
            return None
        m = self.engine.m
        (m.deadline_exceeded if reason == "timeout" else m.cancelled).inc()
        m.obs.tracer.instant("cancel", track=m.label,
                             args={"uid": uid, "reason": reason,
                                   "tokens": len(seq.tokens)})
        m.obs.tracer.async_end("request", uid, track=m.label,
                               args={"tokens": len(seq.tokens),
                                     "finish_reason": reason})
        self._emitted.pop(uid, None)
        return StreamEvent(uid=uid, tokens=[], finished=True,
                           result=_result(seq), finish_reason=reason)

    def due_deadlines(self) -> List[int]:
        """The uids whose ``deadline_hard`` deadline has passed on this
        process's clock — waiting, swapped out or slotted."""
        now = time.monotonic()
        return [s.req.uid for s in (*self.sched.running, *self.sched.waiting)
                if s.req.deadline_hard and s.req.deadline is not None
                and now >= s.req.deadline]

    def _expire_deadlines(self, expired: Optional[List[int]] = None
                          ) -> List[StreamEvent]:
        """The hard-deadline sweep, once per sync interval: every request
        of ``expired`` (default: :meth:`due_deadlines`) is cancelled with
        ``finish_reason="timeout"``.  Under a mesh the verdict is rank
        0's: given by its caller (the front end's lockstep record), or
        broadcast here — every rank holds the same hard-deadline
        requests, so all of them join the broadcast or none does."""
        if expired is None:
            if not any(s.req.deadline_hard and s.req.deadline is not None
                       for s in (*self.sched.running, *self.sched.waiting)):
                return []
            expired = self.due_deadlines()
            eng = self.engine
            if eng.ranks > 1:        # the clock is rank 0's alone
                expired = comm.broadcast_object(
                    expired, comm.world_of(eng.mesh, eng.channel))
        return [ev for uid in expired
                if (ev := self.cancel(uid, reason="timeout")) is not None]

    # ------------------------------------------------- one sync interval
    def step(self, expired: Optional[List[int]] = None
             ) -> List[StreamEvent]:
        """One sync interval; ``expired``: rank 0's hard-deadline verdict
        where its caller carries it (default: swept here)."""
        with self.engine._context():
            return self._step(expired)

    def _step(self, expired: Optional[List[int]] = None
              ) -> List[StreamEvent]:
        eng, sched, pool = self.engine, self.sched, self.engine.pool
        m = eng.m
        # 0) hard deadlines retire before what they hold shapes admission
        events: List[StreamEvent] = self._expire_deadlines(expired)
        # 1) join-at-prefill: new requests take free slots/pages now
        #    (recurrent-state slot rows reset to the init state — stale
        #    state cannot be masked by length as pages are)
        for seq in sched.admit():
            if seq.req.max_new_tokens <= 0:        # nothing to emit
                sched.finish(seq)
                events.append(self._event(seq))
            elif eng.state_pool is not None:
                eng.state_pool.reset_slot(seq.slot)
        if sched.next_prefill() is None and not sched.decoding():
            return events                          # blocked on slots/pages
        # 2) page capacity for this interval's first write (may preempt)
        sched.ensure_decode_capacity()
        running = sched.decoding()
        pseq = sched.next_prefill()
        if pseq is None and not running:
            return events
        # 3) burst length: steps_per_sync clamped to the longest possible
        #    remaining emission and to the pages the pool can map without
        #    preempting
        plen = len(pseq.req.prompt) if pseq is not None else 0
        will_activate = (pseq is not None
                         and pseq.n_prefilled + eng.chunk_size >= plen)
        k = 1
        if running:
            k = min(eng.steps_per_sync,
                    max(s.req.max_new_tokens - len(s.tokens)
                        for s in running))
        can_decode = True
        if will_activate:
            k = max(k, min(eng.steps_per_sync,
                           max(1, pseq.req.max_new_tokens - 1)))
        if pseq is not None and k > 1:
            # ramp-up throttle: while more prompt work is queued and the
            # batch has room, decode one step per chunk and let the
            # activations accumulate (the reference's policy)
            chunks_left = -(-(plen - pseq.n_prefilled) // eng.chunk_size)
            backlog = (chunks_left > 1
                       or any(s is not pseq and s.state is SeqState.PREFILL
                              for s in sched.running)
                       or len(sched.waiting) > 0)
            room = (len(running) + (1 if will_activate else 0)
                    < eng.max_batch)
            if backlog and room:
                k = 1
        if will_activate:
            pseq.n_written = plen
            k, can_decode = sched.extend_with_activation(max(1, k), pseq)
        elif running:
            k = sched.extend_decode_capacity(max(1, k))
        k = max(1, k)
        # 4) ONE device dispatch for the interval
        state = fused.init_burst_state(eng.max_batch, eng._ring)
        for s in running:
            state["tok"][s.slot] = s.tokens[-1]
            state["pos"][s.slot] = s.n_written
            state["uid"][s.slot] = s.req.uid
            state["n_tok"][s.slot] = len(s.tokens)
            state["max_new"][s.slot] = s.req.max_new_tokens
        state["steps_left"] = np.asarray(k, np.int32)
        eng._agree((k, can_decode, None if pseq is None else (
            pseq.req.uid, pseq.slot, pseq.n_prefilled),
            [(s.slot, s.req.uid, s.n_written, len(s.tokens))
             for s in running], pool.block_tables.tobytes()))
        st = fused.upload(state, eng.model.device)
        tables = pool.tables_device()
        t0 = time.monotonic()
        if eng.faults is not None:            # the fault seam: the burst
            eng.faults.burst_hook(eng.obs.label)   # is not launched yet
        if pseq is not None:
            start = pseq.n_prefilled
            chunk = np.zeros((1, eng.chunk_size), np.int32)
            piece = pseq.req.prompt[start:start + eng.chunk_size]
            chunk[0, :len(piece)] = piece
            p = {"tokens": torch.from_numpy(chunk).to(eng.model.device),
                 "start": start, "length": plen, "slot": pseq.slot,
                 "uid": pseq.req.uid, "max_new": pseq.req.max_new_tokens,
                 "pos0": plen if can_decode else -1}
            fused.prefill_burst(eng.model, eng.params, pool.kv, tables, st,
                                self.base_key, p, steps=k,
                                page_size=eng.page_size,
                                chunk_size=eng.chunk_size, eos=eng.eos,
                                **eng.sampling)
            pseq.n_prefilled = min(start + eng.chunk_size, plen)
            pseq.occupied_steps += 1
            m.prefill_chunks.inc()
            m.slot_steps.inc()
        else:
            fused.decode_loop(eng.model, eng.params, pool.kv, tables, st,
                              self.base_key, steps=k,
                              page_size=eng.page_size, eos=eng.eos,
                              **eng.sampling)
        host = fused.read_back(st)            # the ONE host sync
        t1 = time.monotonic()
        steps_run = k - host["steps_left"]
        m.decode_wall.inc(t1 - t0)
        m.host_syncs.inc()
        m.device_steps.inc(steps_run)
        if eng.n_sparse_leaves:
            # this interval's packed projections took the nm_spmm kernels
            m.sparse_dispatch.inc()
        m.burst_steps.observe(steps_run)
        eng.obs.tracer.complete(
            "prefill_burst" if pseq is not None else "decode_burst", t0, t1,
            track=eng.obs.label,
            args={"k": k, "steps": steps_run, "decoding": len(running),
                  **({"chunk_uid": int(pseq.req.uid)}
                     if pseq is not None else {})})
        # 5) advance / retire from the state read back
        live = list(running)
        if will_activate:
            pseq.state = SeqState.RUNNING
            live.append(pseq)
            if pool.prefix is not None:
                # the prompt's full pages are written and immutable now
                # (decode writes land past them): index them
                pool.prefix.register(pseq.req.prompt,
                                     pool.slot_pages(pseq.slot))
        for s in live:
            n = int(host["n_out"][s.slot])
            if n:
                s.tokens.extend(int(t) for t in host["out"][s.slot, :n])
                # the activated request's token 0 rode the chunk: only
                # its remaining n-1 tokens took decode writes
                adv = n - 1 if (will_activate and s is pseq) else n
                s.n_written += adv
                s.occupied_steps += adv
                m.slot_steps.inc(adv)
            if bool(host["done"][s.slot]):
                if pool.prefix is not None:
                    # index the generated continuation too, with the
                    # partial tail; the KV covers positions < n_written
                    # (the last sampled token never wrote its entry)
                    kv_toks = np.concatenate([
                        np.asarray(s.req.prompt, np.int32),
                        np.asarray(s.tokens, np.int32)])[:s.n_written]
                    pool.prefix.register(kv_toks, pool.slot_pages(s.slot),
                                         include_partial=True)
                sched.finish(s)
            ev = self._event(s)
            if ev is not None:
                events.append(ev)
        m.tokens.inc(sum(len(e.tokens) for e in events))
        return events


def _result(seq) -> Result:
    return Result(uid=seq.req.uid, tokens=np.asarray(seq.tokens, np.int32),
                  prompt_len=len(seq.req.prompt),
                  decode_steps=seq.occupied_steps,
                  preemptions=seq.preemptions)
