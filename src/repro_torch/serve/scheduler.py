"""Step-level request scheduler for continuous batching.

State machine per request:

    WAITING --admit--> PREFILL --last chunk--> RUNNING --finish--> FINISHED
       ^                  |                       |
       +----------------- + ------ preempt ------+
         (swap: exclusive pages to the host arena, streamed back on
          resume · recompute: pages released, prefix replayed on re-admit)

Every engine step the scheduler (1) **admits** waiting requests into
free slots while the pool can back their prompts (join-at-prefill; the
engine feeds admitted prompts through in fixed-size chunks, one chunk
per step, interleaved with everyone else's decode); (2) **ensures decode
capacity** — each decoding request about to cross a page boundary gets
one more page, preempting the *youngest* admitted request when the pool
is exhausted; (3) **retires** requests at EOS / ``max_new_tokens``,
recycling slot and pages at once.

Preemption prefers **swap** when the pool has a host arena with room:
the victim's exclusive pages go to the arena, its shared pages stay on
the device pinned by its :class:`~repro_torch.serve.kvpool.SwapRecord`,
and its tokens and prefill progress are kept — resume streams the pages
back and continues where it stopped.  Otherwise **recompute**: pages and
generated tokens are dropped and the prefix is replayed on re-admission
(the per-(uid, step) keys reproduce the same tokens).  Either way the victim
re-queues with its original arrival.

A model with recurrent state is preempted by recompute only (the engine
turns swap off), and one without attention layers has no pages: the
page passes below are no-ops for it.

Admission consults the pool's prefix index when there is one: matched
full pages attach read-only, a matched tail attaches through an eager
copy-on-write, and prefill starts at the first uncovered position.  The
matched pages are pinned before the fresh-page alloc, so that alloc's
LRU eviction cannot recycle them.

The wait queue sorts by ``(-priority, deadline, arrival)`` and is exact
FIFO when neither SLA field is set; the queue head blocks admission when
the pool cannot back its prompt.

Counters (requests, rejections, preemptions, prefix hits) go to the
metrics registry of the scheduler's ``obs`` bundle — the pool's unless
the engine hands one down — with the reference's spans: the request's
async span opens at submit, ``queue_wait`` covers submit → first
admission, and ``swap_resume``, ``prefix_attach``, ``preempt_swap`` and
``preempt_recompute`` are instants.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import Obs
from repro_torch.serve.kvpool import PagedKVPool, SwapRecord
from repro_torch.serve.metrics import SCHED_KEYS, ServeMetrics


class SeqState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    FINISHED = "finished"


class QueueFull(RuntimeError):
    """Raised by :meth:`Scheduler.submit` past the ``max_waiting`` cap."""


@dataclasses.dataclass
class Sequence:
    """Scheduler-side tracking of one request's lifecycle."""

    req: "repro_torch.serve.engine.Request"        # noqa: F821
    state: SeqState = SeqState.WAITING
    slot: int = -1
    n_prefilled: int = 0        # prompt tokens already chunk-prefilled
    n_written: int = 0          # KV entries written (prompt + decoded)
    tokens: List[int] = dataclasses.field(default_factory=list)
    occupied_steps: int = 0     # steps while slotted (chunks + decodes)
    preemptions: int = 0
    arrival: int = 0            # submission order, kept across preemption
    swap: Optional[SwapRecord] = None   # set while swapped to the arena
    # time.monotonic() stamps (0.0: not yet), kept across preemption:
    # the queue wait is submit → first admission, TTFT submit → first
    # delivered token
    submit_ts: float = 0.0
    first_tok_ts: float = 0.0
    admitted_once: bool = False

    def sort_key(self) -> Tuple[float, float, int]:
        dl = self.req.deadline
        return (-self.req.priority, dl if dl is not None else float("inf"),
                self.arrival)


class Scheduler:
    def __init__(self, pool: PagedKVPool, max_slots: int,
                 max_waiting: Optional[int] = None,
                 swap: bool = False, obs: Optional[Obs] = None):
        self.pool = pool
        self.max_waiting = max_waiting
        # swap preemption needs the pool's host arena and no recurrent
        # state rows (the engine decides); a bare Scheduler stays
        # recompute-only
        self.swap_enabled = swap and pool.arena is not None
        self.obs = obs if obs is not None else pool.obs
        self.m = ServeMetrics(self.obs)
        self._waiting: List[Tuple[Tuple[float, float, int], Sequence]] = []
        # admission-ordered (PREFILL + RUNNING): running[-1] is always the
        # youngest — the preemption victim
        self.running: List[Sequence] = []
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self._arrivals = itertools.count()

    @property
    def waiting(self) -> List[Sequence]:
        """The wait queue in admission order."""
        return [s for _, s in sorted(self._waiting, key=lambda e: e[0])]

    @property
    def stats(self) -> Dict[str, float]:
        """The scheduler's counters (cumulative, from the registry)."""
        cur = self.m.snapshot()
        return {k: cur[k] for k in SCHED_KEYS}

    # ------------------------------------------------------------ intake
    def submit(self, req) -> Sequence:
        if (self.max_waiting is not None
                and len(self._waiting) >= self.max_waiting):
            self.m.rejected.inc()
            raise QueueFull(f"wait queue at its depth cap "
                            f"({self.max_waiting}) — retry later")
        seq = Sequence(req=req, arrival=next(self._arrivals),
                       submit_ts=time.monotonic())
        self.m.requests.inc()
        self.obs.tracer.async_begin("request", req.uid, track=self.obs.label,
                                    args={"prompt_len": len(req.prompt),
                                          "max_new": req.max_new_tokens})
        self._push(seq)
        return seq

    def _push(self, seq: Sequence) -> None:
        heapq.heappush(self._waiting, (seq.sort_key(), seq))

    def has_work(self) -> bool:
        return bool(self._waiting or self.running)

    def _note_admitted(self, seq: Sequence) -> None:
        """The queue wait, at the first admission only (a re-queue after
        preemption is a capacity event, not another wait)."""
        if seq.admitted_once:
            return
        seq.admitted_once = True
        now = time.monotonic()
        self.m.queue_wait.observe(now - seq.submit_ts)
        self.obs.tracer.complete("queue_wait", seq.submit_ts, now,
                                 track=self.obs.label,
                                 args={"uid": seq.req.uid})

    # --------------------------------------------------------- admission
    def admit(self) -> List[Sequence]:
        """Move waiting requests into free slots while the pool can back
        them, in wait-queue order; the head blocking on pages stalls
        admission (no bypass, so a large request cannot starve).

        A swapped-out head resumes through :meth:`PagedKVPool.swap_in`
        and re-enters PREFILL or RUNNING where it was preempted.  A fresh
        head consults the prefix index: matched full pages attach shared,
        a matched tail is copied into the first fresh page, and
        ``n_prefilled`` starts at the covered length."""
        admitted: List[Sequence] = []
        while self._waiting and self._free_slots:
            seq = self._waiting[0][1]
            if seq.swap is not None:
                slot = self._free_slots[-1]
                if not self.pool.swap_in(slot, seq.swap):
                    break              # the pool cannot back the resume yet
                heapq.heappop(self._waiting)
                seq.slot = self._free_slots.pop()
                seq.swap = None
                seq.state = (SeqState.RUNNING
                             if seq.n_prefilled >= len(seq.req.prompt)
                             else SeqState.PREFILL)
                self.running.append(seq)
                admitted.append(seq)
                self._note_admitted(seq)
                self.obs.tracer.instant("swap_resume", track=self.obs.label,
                                        args={"uid": seq.req.uid})
                continue
            need = self.pool.pages_for(len(seq.req.prompt))
            if need > self.pool.capacity:
                raise RuntimeError(
                    f"request {seq.req.uid}: prompt needs {need} pages but "
                    f"the pool only has {self.pool.capacity} — raise "
                    f"num_pages or max_len")
            shared: List[int] = []
            cow_src: Optional[int] = None
            n_reuse = 0
            if self.pool.prefix is not None and need > 0:
                shared, cow_src, n_reuse = self.pool.prefix.match(
                    seq.req.prompt)
            # pin the matched pages BEFORE alloc: its LRU eviction may
            # drop their index entries, but pinned pages cannot recycle
            pins = shared + ([cow_src] if cow_src is not None else [])
            for p in pins:
                self.pool.retain(p)
            # the copy-on-write destination is one of the fresh pages
            fresh = self.pool.alloc(need - len(shared))
            if fresh is None:
                self.pool.release(pins)
                break
            heapq.heappop(self._waiting)
            seq.slot = self._free_slots.pop()
            if shared:           # the pins become the slot's references
                self.pool.assign(seq.slot, shared)
            if cow_src is not None:
                cow_page, fresh = fresh[0], fresh[1:]
                self.pool.assign(seq.slot, [cow_page])
                self.pool.copy_page(cow_src, cow_page)
                self.pool.release([cow_src])        # unpin the source
            if fresh:
                self.pool.assign(seq.slot, fresh)
            seq.state = SeqState.PREFILL
            seq.n_prefilled = n_reuse
            self.m.prefix_hit_tokens.inc(n_reuse)
            self.m.prefill_tok.inc(len(seq.req.prompt) - n_reuse)
            if n_reuse:
                reused = len(shared) + (1 if cow_src is not None else 0)
                self.m.prefix_pages_reused.inc(reused)
                self.obs.tracer.instant(
                    "prefix_attach", track=self.obs.label,
                    args={"uid": seq.req.uid, "pages": reused,
                          "tokens": n_reuse})
            self.running.append(seq)
            admitted.append(seq)
            self._note_admitted(seq)
        return admitted

    def next_prefill(self) -> Optional[Sequence]:
        """The oldest admitted request with prompt chunks left to feed."""
        for seq in self.running:
            if seq.state is SeqState.PREFILL:
                return seq
        return None

    def decoding(self) -> List[Sequence]:
        """Admitted requests past prefill."""
        return [s for s in self.running if s.state is SeqState.RUNNING]

    # -------------------------------------------------- decode capacity
    def ensure_decode_capacity(self) -> None:
        """Before a decode step: every decoding request writing position
        ``n_written`` must have that page mapped and exclusively owned.
        Pool exhausted → preempt the youngest admitted request, retry.
        A no-op for pure recurrent-state models (nothing pages)."""
        if not self.pool.has_kv_pages:
            return
        ps = self.pool.page_size
        for seq in list(self.running):       # oldest first
            if seq.state is not SeqState.RUNNING:
                continue
            while seq.state is SeqState.RUNNING:
                if self.pool.slot_page_count(seq.slot) <= seq.n_written // ps:
                    page = self.pool.alloc(1)
                    if page is not None:
                        self.pool.assign(seq.slot, page)
                        continue
                elif self.pool.ensure_writable(seq.slot, seq.n_written):
                    break                    # mapped and exclusive
                victim = self.running[-1]    # youngest
                if victim is seq and len(self.running) == 1:
                    raise RuntimeError(
                        "kv pool exhausted by a single request — raise "
                        "num_pages")
                self.preempt(victim)
                if victim is seq:
                    break

    def extend_decode_capacity(self, k: int) -> int:
        """Burst lookahead: map pages so every decoding request can write
        up to ``k`` more tokens without a host sync.  Never preempts —
        the burst shortens instead.  Returns the safe burst length (``k``
        for pure recurrent-state models)."""
        if not self.pool.has_kv_pages:
            return k
        k_safe, _ = self._extend(k, self.decoding(), activating=None)
        return k_safe

    def extend_with_activation(self, k: int, activating: Sequence
                               ) -> Tuple[int, bool]:
        """Burst lookahead when this interval's prefill chunk is the
        request's final one: as :meth:`extend_decode_capacity`, with the
        activating request in the decoding set (its ``n_written`` already
        set to the prompt length).  ``can_decode`` is False when not even
        one decode write of the activating slot can be backed; it then
        activates frozen and waits for the next capacity pass."""
        if not self.pool.has_kv_pages:
            return k, True
        return self._extend(k, self.decoding(), activating)

    def _extend(self, k: int, decoding: List[Sequence],
                activating: Optional[Sequence]) -> Tuple[int, bool]:
        ps = self.pool.page_size
        if activating is not None:
            decoding = decoding + [activating]

        def extra_pages(seq: Sequence, kk: int) -> int:
            drawn = len(seq.tokens) + (1 if seq is activating else 0)
            want = max(0, min(kk, seq.req.max_new_tokens - drawn))
            need = -(-(seq.n_written + want) // ps)
            return max(0, need - self.pool.slot_page_count(seq.slot))

        def total(kk: int) -> int:
            return sum(extra_pages(s, kk) for s in decoding)

        k_safe = k
        while k_safe > 1 and total(k_safe) > self.pool.free_pages:
            k_safe -= 1
        can_decode = True
        if activating is not None and total(k_safe) > self.pool.free_pages:
            decoding.remove(activating)
            can_decode = False
        for seq in decoding:
            n = extra_pages(seq, k_safe)
            if n:
                self.pool.assign(seq.slot, self.pool.alloc(n))
        return k_safe, can_decode

    # --------------------------------------------------------- lifecycle
    def preempt(self, seq: Sequence) -> None:
        """Preempt ``seq``: swap when enabled and the arena has room for
        its exclusive pages (tokens and prefill progress kept), else
        recompute (slot, pages and generated tokens dropped).  Either way
        it re-queues with its original arrival (ahead of later
        submissions)."""
        seq.preemptions += 1
        if self.swap_enabled:
            record = self.pool.swap_out(seq.slot)
            if record is not None:
                # swap_out cleared the table row; free the slot without
                # releasing the kept references (the record owns them)
                self._free_slots.append(seq.slot)
                self.running.remove(seq)
                seq.slot = -1
                seq.swap = record
                seq.state = SeqState.WAITING
                self.m.preempt_swap.inc()
                self.obs.tracer.instant("preempt_swap", track=self.obs.label,
                                        args={"uid": seq.req.uid,
                                              "host_pages": record.n_host})
                self._push(seq)
                return
        self._release(seq)
        seq.state = SeqState.WAITING
        seq.n_prefilled = 0
        seq.n_written = 0
        seq.tokens = []
        self.m.preempt_recompute.inc()
        self.obs.tracer.instant("preempt_recompute", track=self.obs.label,
                                args={"uid": seq.req.uid})
        self._push(seq)

    def finish(self, seq: Sequence) -> None:
        self._release(seq)
        seq.state = SeqState.FINISHED

    def cancel(self, uid: int) -> Optional[Sequence]:
        """Retire one request wherever it is: a slotted one releases slot
        and pages, a waiting one leaves the queue, a swapped-out one also
        frees its arena slots and kept references.  Returns the sequence
        (now FINISHED), or None for an unknown uid."""
        for seq in self.running:
            if seq.req.uid == uid:
                self.finish(seq)
                return seq
        for i, (_, seq) in enumerate(self._waiting):
            if seq.req.uid == uid:
                self._waiting[i] = self._waiting[-1]
                self._waiting.pop()
                heapq.heapify(self._waiting)
                if seq.swap is not None:
                    self.pool.drop_swap(seq.swap)
                    seq.swap = None
                seq.state = SeqState.FINISHED
                return seq
        return None

    def _release(self, seq: Sequence) -> None:
        self.pool.clear_slot(seq.slot)
        self._free_slots.append(seq.slot)
        self.running.remove(seq)
        seq.slot = -1
