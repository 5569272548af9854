"""ServeConfig: every serve-runtime knob, validated in one place.

The reference's fields, defaults and validation.  As in the reference:

  ``temperature``       0 decodes greedily; > 0 samples (per-(uid, step)
                        keys in continuous mode), after ``top_k`` /
                        ``top_p`` filtering when they are set;
  ``mode``              "continuous" (paged, continuous batching) or
                        "static" (prompt-length buckets over a dense
                        cache, one host sync a bucket);

  ``prefix_cache``      hash-based prefix reuse over refcounted pages
                        (kvpool.PrefixCache), on by default;
  ``host_swap_pages``   the host swap arena's capacity in pages
                        (kvpool.HostArena): ``None`` sizes it to the pool
                        (swap preferred), ``0`` turns swap off
                        (recompute-only preemption);
  ``replicas``          data-parallel engines behind the front end's
                        least-loaded router (``launch/serve.py``);
  ``queue_depth``       each replica's wait-queue cap: past it a submit
                        raises ``QueueFull`` (HTTP 429);
  ``metrics``           the counter / gauge / histogram registry behind
                        ``engine.stats`` and ``/metrics`` (off: every
                        call site a no-op);
  ``trace``             Chrome-trace request spans (``--trace-out``);
  ``faults``            a :class:`~repro_torch.serve.faults.FaultPlan`
                        shared by every replica built from this config.

Token streams are the same under every combination of the last three.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serve.faults import FaultPlan

_MODES = ("continuous", "static")


@dataclasses.dataclass
class ServeConfig:
    """Every serve-runtime knob, validated in one place."""

    # engine
    mode: str = "continuous"
    max_batch: int = 8
    max_len: int = 256
    eos_id: Optional[int] = None
    # sampling: temperature 0 = greedy
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    # paged runtime
    page_size: int = 16
    num_pages: Optional[int] = None     # None → dense-cache equivalent
    prefill_chunk: int = 32
    steps_per_sync: int = 8
    # prefix caching + host swap
    prefix_cache: bool = True
    host_swap_pages: Optional[int] = None   # None → pool-sized; 0 → off
    # KV page dtype: "fp32" keeps the model dtype, "int8" quantizes pages
    # with per-row f32 scales (the default pool sizing then doubles the
    # page count at the same bytes)
    kv_dtype: str = "fp32"
    # "auto" packs 2:4 leaves at engine load; "off" serves the tree as is
    sparse_weights: str = "auto"
    # front end
    replicas: int = 1
    queue_depth: Optional[int] = None   # wait-queue cap (QueueFull past it)
    # observability
    metrics: bool = True
    trace: bool = False
    # fault injection (None: nothing ever fires)
    faults: Optional[FaultPlan] = None

    def validate(self) -> "ServeConfig":
        """The single validation point.  Returns self (chainable)."""
        if self.mode not in _MODES:
            raise ValueError(f"unknown serve mode {self.mode!r} "
                             f"(expected one of {_MODES})")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_len < 1:
            raise ValueError("max_len must be >= 1")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.num_pages is not None and self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is scrap)")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.steps_per_sync < 1:
            raise ValueError("steps_per_sync must be >= 1")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError("top_k must be >= 1")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.host_swap_pages is not None and self.host_swap_pages < 0:
            raise ValueError("host_swap_pages must be >= 0 (0 = off)")
        if self.kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r} "
                             "(expected 'fp32' or 'int8')")
        if self.sparse_weights not in ("auto", "off"):
            raise ValueError(f"unknown sparse_weights "
                             f"{self.sparse_weights!r} "
                             "(expected 'auto' or 'off')")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.queue_depth is not None and self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if self.faults is not None:
            for spec in self.faults.specs:
                spec.validate()
        return self

    def resolved_num_pages(self) -> int:
        """The pool size: explicit, or the dense cache's token capacity +
        the scrap page (doubled per slot for int8 pages)."""
        if self.num_pages is not None:
            return self.num_pages
        per_slot = -(-self.max_len // self.page_size)
        if self.kv_dtype == "int8":
            per_slot *= 2
        return self.max_batch * per_slot + 1

    def resolved_swap_pages(self) -> int:
        """Host-arena capacity: explicit, or pool-sized (every live page
        can swap out)."""
        if self.host_swap_pages is not None:
            return self.host_swap_pages
        return self.resolved_num_pages()

    @classmethod
    def from_args(cls, args) -> "ServeConfig":
        """The ``launch/serve.py`` flags → knobs, as the reference's
        ``from_args`` (``--sparse`` sets ``sparse_weights``).
        ``--sampling`` resolves to (temperature, top_k, top_p): the
        sampled modes need a live draw, so a zero temperature becomes
        1.0."""
        temperature = args.temperature
        top_k = args.top_k if args.sampling == "top-k" else None
        top_p = args.top_p if args.sampling == "top-p" else None
        if args.sampling != "greedy" and temperature <= 0.0:
            temperature = 1.0
        return cls(
            mode=args.serve_mode, max_batch=args.max_batch,
            max_len=args.max_len, temperature=temperature, top_k=top_k,
            top_p=top_p, page_size=args.page_size,
            num_pages=args.num_pages, prefill_chunk=args.prefill_chunk,
            steps_per_sync=args.steps_per_sync,
            prefix_cache=args.prefix_cache,
            host_swap_pages=args.host_swap_pages, kv_dtype=args.kv_dtype,
            sparse_weights="auto" if args.sparse else "off",
            replicas=args.replicas, queue_depth=args.queue_depth,
            metrics=args.metrics, trace=args.trace_out is not None,
            faults=(FaultPlan.parse(args.inject_fault)
                    if args.inject_fault else None),
        ).validate()
