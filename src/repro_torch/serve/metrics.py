"""The serve stack's metric series (a port of ``repro.serve.metrics``).

:class:`ServeMetrics` binds every serve series against one
:class:`repro_torch.obs.Obs` bundle and keeps the bound children as
plain attributes, so the engine, scheduler and pool hot paths do one
``child.inc()`` with no name lookup.  Binding is get-or-create on the
registry: an engine, its pool and its scheduler built from one bundle
share the same children, and N replicas sharing one registry each get
their own through the ``replica`` label.  Series names and help strings
are the reference's.

The flat ``stats`` dicts of the engine, the pool and the scheduler are
views over :meth:`ServeMetrics.snapshot`, under the keys they always
had: the reference's, plus ``requests``, ``slot_steps`` and
``prefix_pages_reused`` (series the reference's view leaves out) and
``preemptions`` (swap + recompute, no series of its own).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.obs import COUNT_BUCKETS, Obs

# flat keys that are wall-clock seconds (kept float in snapshots;
# everything else reads as int)
_WALL_KEYS = ("decode_wall_s", "swap_in_wall_s")

# the pool's and the scheduler's slices of the namespace
POOL_KEYS = ("cow_copies", "prefix_evictions", "swap_out_pages",
             "swap_in_pages", "swap_in_wall_s")
SCHED_KEYS = ("preemptions", "preempt_swap", "preempt_recompute",
              "prefix_hit_tokens", "prefill_tok", "prefix_pages_reused")


class ServeMetrics:
    """Bound serve-series children for one replica label."""

    def __init__(self, obs: Obs):
        self.obs = obs
        reg = obs.metrics
        lbl = {"replica": obs.label}

        def c(name: str, help: str):
            return reg.counter(name, help, ("replica",)).labels(**lbl)

        def g(name: str, help: str):
            return reg.gauge(name, help, ("replica",)).labels(**lbl)

        def h(name: str, help: str, **kw):
            return reg.histogram(name, help, ("replica",),
                                 **kw).labels(**lbl)

        # ---- step loop -------------------------------------------------
        self.host_syncs = c(
            "serve_host_syncs_total",
            "Blocking device readbacks (one per burst interval)")
        self.device_steps = c(
            "serve_device_steps_total",
            "Fused on-device decode steps executed")
        self.prefill_chunks = c(
            "serve_prefill_chunks_total",
            "Prompt chunk dispatches (fused into their interval's burst)")
        self.tokens = c(
            "serve_tokens_total", "Tokens emitted to consumers")
        self.decode_wall = c(
            "serve_decode_wall_seconds_total",
            "Wall time inside burst dispatch->readback windows")
        self.slot_steps = c(
            "serve_slot_steps_total",
            "Slot-steps occupied (chunks + decode writes) — "
            "tokens/slot_steps is aggregate utilization")
        # ---- admission -------------------------------------------------
        self.requests = c(
            "serve_requests_total", "Requests accepted into the scheduler")
        self.rejected = c(
            "serve_requests_rejected_total",
            "Requests refused at the wait-queue depth cap (QueueFull/429)")
        # ---- preemption / paging --------------------------------------
        self.preempt_swap = c(
            "serve_preempt_swap_total",
            "Preserve-KV preemptions (pages swapped to the host arena)")
        self.preempt_recompute = c(
            "serve_preempt_recompute_total",
            "Drop-and-replay preemptions")
        self.prefix_hit_tokens = c(
            "serve_prefix_hit_tokens_total",
            "Prompt tokens covered by the prefix index at admission")
        self.prefill_tok = c(
            "serve_prefill_tokens_total",
            "Prompt tokens actually chunk-prefilled")
        self.prefix_pages_reused = c(
            "serve_prefix_pages_reused_total",
            "KV pages attached from the prefix index (shared + CoW tail)")
        self.cow_copies = c(
            "serve_cow_copies_total", "Copy-on-write page copies")
        self.prefix_evictions = c(
            "serve_prefix_evictions_total",
            "Prefix-index entries evicted to refill the pool")
        self.swap_out_pages = c(
            "serve_swap_out_pages_total",
            "Pages gathered to the host arena")
        self.swap_in_pages = c(
            "serve_swap_in_pages_total",
            "Pages restored from the host arena")
        self.swap_in_wall = c(
            "serve_swap_in_seconds_total",
            "Wall time inside swap-in restores")
        # ---- compressed weights / quantized KV -------------------------
        self.sparse_dispatch = c(
            "sparse_dispatch_total",
            "Burst dispatches routed through the compressed 2:4 "
            "weight path (packed QKV/MLP projections)")
        self.kv_quant_pages = c(
            "kv_quant_pages_total",
            "int8 KV pages allocated (quantize-on-write pools only)")
        # ---- fault tolerance -------------------------------------------
        self.replica_restarts = c(
            "replica_restarts_total",
            "Replica workers restarted by the supervisor after a "
            "crash/stall")
        self.failed_over = c(
            "requests_failed_over_total",
            "In-flight requests re-submitted after a replica "
            "crash (already-streamed prefixes replay-suppressed)")
        self.cancelled = c(
            "requests_cancelled_total",
            "Requests cancelled mid-flight (client disconnect / "
            "explicit cancel) — pages and slot released immediately")
        self.deadline_exceeded = c(
            "requests_deadline_exceeded_total",
            "Requests retired at their hard deadline "
            "(finish_reason=timeout / HTTP 504)")
        # ---- latency histograms ---------------------------------------
        self.ttft = h(
            "serve_ttft_seconds",
            "Submit -> first token (time to first token)")
        self.tpot = h(
            "serve_tpot_seconds",
            "Per-token decode latency after the first token")
        self.queue_wait = h(
            "serve_queue_wait_seconds", "Submit -> admission wait")
        self.burst_steps = h(
            "serve_burst_steps", "Decode steps per device burst",
            buckets=COUNT_BUCKETS)
        self.recovery = h(
            "serve_recovery_seconds",
            "Crash/stall detection -> worker restarted and every "
            "in-flight request re-submitted")
        # ---- gauges (replica.py binds the callbacks) -------------------
        self.queue_depth = g(
            "serve_queue_depth", "Requests in flight (waiting + slotted)")
        self.replica_healthy = g(
            "serve_replica_healthy",
            "1 while the replica worker is alive and not stalled")
        self.free_pages = g(
            "serve_free_pages", "KV pool free-list length")

        # the flat namespace of ServeEngine.stats et al.
        self._flat = {
            "requests": self.requests,
            "slot_steps": self.slot_steps,
            "prefix_pages_reused": self.prefix_pages_reused,
            "host_syncs": self.host_syncs,
            "device_steps": self.device_steps,
            "prefill_chunks": self.prefill_chunks,
            "tokens": self.tokens,
            "decode_wall_s": self.decode_wall,
            "preempt_swap": self.preempt_swap,
            "preempt_recompute": self.preempt_recompute,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefill_tok": self.prefill_tok,
            "cow_copies": self.cow_copies,
            "prefix_evictions": self.prefix_evictions,
            "swap_out_pages": self.swap_out_pages,
            "swap_in_pages": self.swap_in_pages,
            "swap_in_wall_s": self.swap_in_wall,
            "sparse_dispatch": self.sparse_dispatch,
            "kv_quant_pages": self.kv_quant_pages,
            "replica_restarts": self.replica_restarts,
            "failed_over": self.failed_over,
            "cancelled": self.cancelled,
            "deadline_exceeded": self.deadline_exceeded,
        }

    @property
    def tracer(self):
        return self.obs.tracer

    @property
    def label(self) -> str:
        return self.obs.label

    def snapshot(self) -> Dict[str, float]:
        """Current cumulative values under the flat key names.  The
        per-run ``ServeEngine.stats`` view is ``snapshot() - base``
        with the base taken at ``generate()`` start."""
        snap = {k: (child.value if k in _WALL_KEYS else int(child.value))
                for k, child in self._flat.items()}
        snap["preemptions"] = snap["preempt_swap"] + snap["preempt_recompute"]
        return snap
