"""Paged serve cache: refcounted KV pages, prefix reuse, host swap.

The continuous-batching runtime stores every request's attention KV in
fixed-size pages drawn from one pool — per layer a (num_pages,
page_size, KV, hd) K and V tensor (``LM.init_paged_cache``).  A request
owns a block-table row mapping its logical token positions to physical
page ids.

Page ownership is refcounted: ``alloc`` hands out pages at refcount 1,
``retain``/``release`` move the count, and a page returns to the free
list when its last reference drops.  One page can back the same token
prefix in many block tables at once; a shared page (refcount > 1) is
read-only: :meth:`PagedKVPool.ensure_writable` copies it into a fresh
page before a write lands in it.

Page 0 is the reserved scrap page: never allocated, it absorbs the
writes of padded prompt positions and idle decode slots (attention
masks by length, so scrap contents are never read).

:class:`PrefixCache` is the hash-based prefix index over shared pages:
prompts are hashed page by page (``h_i = blake2b(h_{i-1} ‖ tokens of
page i)``, token-exact verified, so a collision is a miss and never
wrong KV); matching full pages attach without prefill, and a matching
partial tail attaches through an eager copy-on-write.  Entries are
evicted LRU-leaf-first, lazily, from inside :meth:`PagedKVPool.alloc`.

:class:`HostArena` is the host swap tier: preemption can move a
victim's exclusive pages into preallocated host memory (pinned when the
pool is on the card) and stream them back on resume instead of
recomputing; shared pages stay on the device, pinned by the victim's
:class:`SwapRecord`.

Recurrent mixers (Mamba, the xLSTM) carry O(1) state a request instead of
per-token KV: their leaves in the same per-layer cache list are rows
indexed by serve slot, and :class:`StatePool` resets a slot's rows at
admission.  A model without attention layers has no pages at all
(``has_kv_pages``): prompts cost 0 pages and nothing is paged.  A model
with recurrent state gets no prefix index — unlike the reference, which
builds one and then prefills an attached request's recurrent layers from
the reset state at the first uncovered position (ROADMAP.md, "One fault
of the reference") — and its engine keeps recompute preemption, since
the host arena tiers pages only.

The page tensors and state rows are updated in place by the model's
writes and by the copies here (the JAX pool is rebuilt functionally and
donated instead).

The counters (copy-on-write copies, evictions, swap pages and seconds,
int8 pages) live in the engine's metrics registry
(:class:`~repro_torch.serve.metrics.ServeMetrics`); ``stats`` is the
reference's per-run view over them, re-based at every :meth:`reset`.
Two fault sites live here (``serve.faults``): ``pool_alloc`` makes
:meth:`PagedKVPool.alloc` report exhaustion, ``swap_error`` makes the
arena fail — both on paths real exhaustion takes anyway.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import Obs
from repro_torch.serve.metrics import POOL_KEYS, ServeMetrics


def _wait(device: torch.device) -> None:
    """Block until the device's queued copies have landed."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class PagedKVPool:
    """Refcounted free-list page allocator + the device page tensors.

    Allocation state (free list, refcounts, block tables, per-slot page
    counts) is host-side numpy; :meth:`tables_device` keeps a device
    mirror of the block tables, re-uploading only rows that changed.
    ``prefix_cache`` builds :attr:`prefix`, ``host_swap_pages`` > 0 the
    swap arena :attr:`arena` of that many pages.  The engine hands down
    its ``obs`` bundle and fault plan; a bare pool gets a private
    metrics-only bundle.
    """

    def __init__(self, model, *, num_pages: int, page_size: int,
                 max_slots: int, max_len: int,
                 dtype: Optional[torch.dtype] = None,
                 prefix_cache: bool = False, host_swap_pages: int = 0,
                 obs: Optional[Obs] = None, faults=None):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is scrap)")
        self.page_size = page_size
        self.num_pages = num_pages
        self.pages_per_slot = -(-max_len // page_size)
        self.device = torch.device(model.device)
        kinds = model.kinds
        # pure recurrent-state models have no KV pages: prompts cost 0
        # pages and decode never extends a block table
        self.has_kv_pages = any(k in model.ATTN_KINDS for k in kinds)
        self.has_state = any(k in model.STATE_KINDS for k in kinds)
        self.quantized = dtype == torch.int8
        self.kv = model.init_paged_cache(num_pages, page_size, dtype,
                                         max_slots=max_slots)
        # the attention layers' page leaves (what copy-on-write and the
        # swap arena move); state rows are not pages
        self.page_layers = [layer for layer, kind in zip(self.kv,
                                                         model.kinds)
                            if kind in model.ATTN_KINDS]
        self.block_tables = np.zeros((max_slots, self.pages_per_slot),
                                     np.int32)
        self._n_pages = np.zeros((max_slots,), np.int32)
        self._free: List[int] = []
        self._ref = np.zeros((num_pages,), np.int32)
        self._tables_dev: Optional[torch.Tensor] = None
        self._dirty: set = set()          # slot rows changed since upload
        self.obs = obs if obs is not None else Obs.create(trace=False)
        self.faults = faults
        self.m = ServeMetrics(self.obs)
        self._stats_base: Dict[str, float] = {}
        # no prefix index over recurrent state: an attach skips the
        # prefill of the covered tokens, which state rows cannot skip
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self) if prefix_cache and self.has_kv_pages
            and not self.has_state else None)
        self.arena: Optional[HostArena] = (
            HostArena(self, host_swap_pages)
            if host_swap_pages > 0 and self.has_kv_pages else None)
        self.reset()

    # ----------------------------------------------------------- alloc
    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the scrap page)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def stats(self) -> Dict[str, float]:
        """The pool's counters since the last :meth:`reset`."""
        cur = self.m.snapshot()
        return {k: cur[k] - self._stats_base.get(k, 0) for k in POOL_KEYS}

    def pages_for(self, n_tokens: int) -> int:
        """Pages backing ``n_tokens`` KV entries — 0 for pure
        recurrent-state models (nothing to page)."""
        if not self.has_kv_pages:
            return 0
        return -(-n_tokens // self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages at refcount 1; None if it would overdraw
        (all-or-nothing, so a half-admitted request never holds pages).
        A short free list first evicts prefix-index leaves LRU-first."""
        if n <= 0:
            return []
        if self.faults is not None and self.faults.hit(
                "pool_alloc", self.obs.label):
            return None                     # injected exhaustion
        if self.prefix is not None:
            while n > len(self._free) and self.prefix.evict_lru():
                pass
        if n > len(self._free):
            return None
        out = self._free[-n:][::-1]
        del self._free[-n:]
        self._ref[out] = 1
        if self.quantized:
            self.m.kv_quant_pages.inc(n)
        return out

    def retain(self, page: int) -> None:
        """Add a reference to a live page (sharing it)."""
        assert page != 0, "scrap page is not shareable"
        assert self._ref[page] > 0, f"retain of free page {page}"
        self._ref[page] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; pages free at refcount 0."""
        for p in pages:
            assert p != 0, "scrap page is not allocatable"
            assert self._ref[p] > 0, f"release of free page {p}"
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def check_invariants(self) -> None:
        """Free + live pages partition the allocatable pages, the scrap
        page is never owned, no count goes negative, no double free."""
        assert self._ref[0] == 0
        assert (self._ref >= 0).all()
        free = set(self._free)
        assert len(free) == len(self._free), "double-free"
        live = {int(p) for p in np.nonzero(self._ref)[0]}
        assert free.isdisjoint(live)
        assert len(free) + len(live) == self.capacity

    # ------------------------------------------------------ block tables
    def assign(self, slot: int, pages: Sequence[int]) -> None:
        """Append ``pages`` to a slot's block table (logical order); the
        caller owns one reference per page."""
        n = int(self._n_pages[slot])
        assert n + len(pages) <= self.pages_per_slot, "slot exceeds max_len"
        self.block_tables[slot, n:n + len(pages)] = pages
        self._n_pages[slot] = n + len(pages)
        self._dirty.add(slot)

    def attach(self, slot: int, pages: Sequence[int]) -> None:
        """Map already-live pages into a slot's table read-only (prefix
        sharing): one ``retain`` per page + ``assign``."""
        for p in pages:
            self.retain(p)
        self.assign(slot, pages)

    def slot_page_count(self, slot: int) -> int:
        return int(self._n_pages[slot])

    def slot_pages(self, slot: int) -> List[int]:
        return self.block_tables[slot, :self._n_pages[slot]].tolist()

    def clear_slot(self, slot: int) -> None:
        """Release all of a slot's pages and zero its table row."""
        self.release(self.slot_pages(slot))
        self.block_tables[slot] = 0
        self._n_pages[slot] = 0
        self._dirty.add(slot)

    def reset(self) -> None:
        """Recycle every page, empty the prefix index and the arena.  The
        page tensors keep stale contents — attention masks by length, so
        stale pages are never read."""
        self.block_tables[:] = 0
        self._n_pages[:] = 0
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref[:] = 0
        self._tables_dev = None
        self._dirty.clear()
        self._stats_base = self.m.snapshot()
        if self.prefix is not None:
            self.prefix.clear()
        if self.arena is not None:
            self.arena.reset()

    def tables_device(self) -> torch.Tensor:
        """Device mirror of the block tables: uploaded whole once, then
        only the rows changed since the last call are written in place."""
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(
                self.block_tables.copy()).to(self.device)
            self._dirty.clear()
        elif self._dirty:
            rows = sorted(self._dirty)
            self._tables_dev[torch.tensor(rows, device=self.device)] = (
                torch.from_numpy(self.block_tables[rows]).to(self.device))
            self._dirty.clear()
        return self._tables_dev

    # ------------------------------------------------------ copy-on-write
    def copy_page(self, src: int, dst: int) -> None:
        """Every layer's ``dst`` page gets ``src``'s contents (int8 pages
        with their scales)."""
        for layer in self.page_layers:
            for t in layer.values():
                t[dst] = t[src]
        self.m.cow_copies.inc()
        self.obs.tracer.instant("cow_copy", track=self.obs.label,
                                args={"src": src, "dst": dst})

    def ensure_writable(self, slot: int, pos: int) -> bool:
        """Make the page backing write position ``pos`` exclusively owned
        by ``slot`` (a no-op at refcount 1).  A shared page is copied into
        a fresh one; False when the pool cannot back the copy."""
        idx = pos // self.page_size
        page = int(self.block_tables[slot, idx])
        assert idx < self._n_pages[slot] and page != 0, "unmapped write"
        if self._ref[page] == 1:
            return True
        fresh = self.alloc(1)
        if fresh is None:
            return False
        self.copy_page(page, fresh[0])
        self.release([page])
        self.block_tables[slot, idx] = fresh[0]
        self._dirty.add(slot)
        return True

    # ------------------------------------------------------------- swap
    def swap_out(self, slot: int) -> Optional["SwapRecord"]:
        """Swap preemption, evict side: copy the slot's exclusive pages
        into the arena and release them; shared pages stay on the device
        with the slot's reference moved to the returned record.  None
        (slot untouched) when there is no arena or it lacks room."""
        if self.arena is None:
            return None
        if self.faults is not None and self.faults.hit(
                "swap_error", self.obs.label):
            return None                     # injected: recompute instead
        pages = self.slot_pages(slot)
        host = [p for p in pages if self._ref[p] == 1]
        if not self.arena.has_room(len(host)):
            return None
        by_page = dict(zip(host, self.arena.gather(self.page_layers,
                                                   host)))
        entries = [("host", by_page[p]) if p in by_page else ("kept", p)
                   for p in pages]
        self.release(host)            # the bytes now live in the arena
        self.block_tables[slot] = 0   # kept refs move to the record
        self._n_pages[slot] = 0
        self._dirty.add(slot)
        self.m.swap_out_pages.inc(len(host))
        self.obs.tracer.instant("swap_out", track=self.obs.label,
                                args={"slot": slot, "pages": len(host)})
        return SwapRecord(entries=entries)

    def swap_in(self, slot: int, record: "SwapRecord") -> bool:
        """Swap preemption, resume side: fresh pages for the record's
        host part (False, nothing changed, when the pool cannot back
        them), the arena's bytes uploaded into them, and the slot's table
        rebuilt in logical order — kept pages back in place, the record's
        reference becoming the table's."""
        if self.faults is not None and self.faults.hit(
                "swap_error", self.obs.label):
            return False                    # injected: retry later
        host_slots = [s for tag, s in record.entries if tag == "host"]
        fresh = self.alloc(len(host_slots))
        if fresh is None:
            return False
        t0 = time.monotonic()
        if host_slots:
            self.arena.scatter(self.page_layers, host_slots, fresh)
        it = iter(fresh)
        self.assign(slot, [s if tag == "kept" else next(it)
                           for tag, s in record.entries])
        self.arena.free(host_slots)
        t1 = time.monotonic()
        self.m.swap_in_pages.inc(len(host_slots))
        self.m.swap_in_wall.inc(t1 - t0)
        self.obs.tracer.complete("swap_in", t0, t1, track=self.obs.label,
                                 args={"slot": slot,
                                       "pages": len(host_slots)})
        return True

    def drop_swap(self, record: "SwapRecord") -> None:
        """Abandon a swap record (its request was cancelled): free its
        arena slots and the kept pages' references."""
        self.arena.free([s for tag, s in record.entries if tag == "host"])
        self.release([p for tag, p in record.entries if tag == "kept"])


@dataclasses.dataclass
class SwapRecord:
    """A swapped-out request's pages in logical order: ``("host",
    arena_slot)`` for pages copied to the arena, ``("kept", page)`` for
    shared pages kept on the device (the record holds their reference)."""

    entries: List[Tuple[str, int]]

    @property
    def n_host(self) -> int:
        return sum(1 for tag, _ in self.entries if tag == "host")


# ----------------------------------------------------------------------
# hash-based prefix index
# ----------------------------------------------------------------------
class _Entry:
    __slots__ = ("digest", "parent", "page", "tokens", "children",
                 "last_use", "partial")

    def __init__(self, digest, parent, page, tokens, partial):
        self.digest = digest
        self.parent = parent
        self.page = page
        self.tokens = tokens
        self.children = 0
        self.last_use = 0
        self.partial = partial


class PrefixCache:
    """Chain-hash index of cached token prefixes over pool pages.

    Full pages chain: ``h_i = blake2b(h_{i-1} ‖ page-i tokens)``, so a
    lookup walks the prompt page by page.  Every entry stores its exact
    tokens and a match re-verifies them: a digest collision is a miss,
    never wrong KV.  Partial tail pages (retired requests) index under
    their parent's digest and match by longest common prefix; they
    attach by copy-on-write, full pages attach read-only.  The index
    holds one pool reference per entry page; eviction is LRU over leaf
    entries, driven by :meth:`PagedKVPool.alloc`.
    """

    _ROOT = b"root"

    def __init__(self, pool: PagedKVPool):
        # a weak reference: the pool owns the index, and a cycle would
        # keep a dropped pool's device pages until the cycle collector ran
        self.pool = weakref.proxy(pool)
        self._full: Dict[bytes, _Entry] = {}
        self._partials: Dict[bytes, List[_Entry]] = {}
        self._clock = itertools.count(1)

    def __len__(self) -> int:
        return len(self._full) + sum(len(v) for v in self._partials.values())

    def clear(self) -> None:
        """Drop every entry without releasing pages — only for
        :meth:`PagedKVPool.reset`, which recycles the whole pool."""
        self._full.clear()
        self._partials.clear()

    @staticmethod
    def _digest(parent: bytes, tokens, partial: bool) -> bytes:
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(b"P" if partial else b"F")
        h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
        return h.digest()

    # ------------------------------------------------------------ match
    def match(self, prompt) -> Tuple[List[int], Optional[int], int]:
        """Longest cached prefix of ``prompt``: ``(shared_pages, cow_src,
        n_tokens)`` — full pages to attach read-only, an optional page to
        copy-on-write, and the KV entries covered, capped at
        ``len(prompt) - 1`` (the last prompt token is always prefilled so
        that the final chunk yields token 0's logits; a fully covered
        prompt turns its last matched page into the copy source)."""
        ps = self.pool.page_size
        prompt = np.asarray(prompt, np.int32)
        n = len(prompt)
        pages: List[int] = []
        parent = self._ROOT
        covered = 0
        while covered + ps <= n:
            piece = prompt[covered:covered + ps]
            e = self._full.get(self._digest(parent, piece, False))
            if e is None or not np.array_equal(e.tokens, piece):
                break
            e.last_use = next(self._clock)
            pages.append(e.page)
            parent = e.digest
            covered += ps
        if covered >= n:               # fully covered: cap at n-1
            return pages[:-1], pages[-1], n - 1
        best, best_m = None, 0
        for e in self._partials.get(parent, ()):
            m = _lcp(e.tokens, prompt[covered:covered + len(e.tokens)])
            m = min(m, n - 1 - covered)
            if m > best_m:
                best, best_m = e, m
        if best is not None:
            best.last_use = next(self._clock)
            return pages, best.page, covered + best_m
        return pages, None, covered

    # --------------------------------------------------------- register
    def register(self, kv_tokens, pages: Sequence[int],
                 include_partial: bool = False) -> None:
        """Index a slot's written pages: ``kv_tokens`` are the tokens
        whose KV the slot holds, ``pages`` its block-table row.  Full
        pages chain-register; ``include_partial`` also registers the
        trailing partial page (at retirement only — a live request still
        writes its tail).  A known digest is a recency bump; each new
        entry retains its page."""
        ps = self.pool.page_size
        kv_tokens = np.asarray(kv_tokens, np.int32)
        parent = self._ROOT
        n_full = len(kv_tokens) // ps
        for i in range(n_full):
            piece = kv_tokens[i * ps:(i + 1) * ps]
            d = self._digest(parent, piece, False)
            e = self._full.get(d)
            if e is None:
                e = _Entry(d, parent, int(pages[i]), piece.copy(), False)
                self.pool.retain(e.page)
                self._full[d] = e
                pe = self._full.get(parent)
                if pe is not None:
                    pe.children += 1
            elif not np.array_equal(e.tokens, piece):
                return                 # digest collision: stop the chain
            e.last_use = next(self._clock)
            parent = d
        if not include_partial:
            return
        tail = kv_tokens[n_full * ps:]
        if len(tail) == 0 or n_full >= len(pages):
            return
        d = self._digest(parent, tail, True)
        sibs = self._partials.setdefault(parent, [])
        for s in sibs:
            if s.digest == d:
                s.last_use = next(self._clock)
                return
        e = _Entry(d, parent, int(pages[n_full]), tail.copy(), True)
        e.last_use = next(self._clock)
        self.pool.retain(e.page)
        sibs.append(e)
        pe = self._full.get(parent)
        if pe is not None:
            pe.children += 1

    # ---------------------------------------------------------- evict
    def evict_lru(self) -> bool:
        """Evict the least recently used leaf entry (releasing its page
        reference).  False when nothing is evictable."""
        best: Optional[_Entry] = None
        for e in self._full.values():
            if e.children == 0 and (best is None
                                    or e.last_use < best.last_use):
                best = e
        for sibs in self._partials.values():
            for e in sibs:
                if best is None or e.last_use < best.last_use:
                    best = e
        if best is None:
            return False
        if best.partial:
            sibs = self._partials[best.parent]
            sibs.remove(best)
            if not sibs:
                del self._partials[best.parent]
        else:
            del self._full[best.digest]
        pe = self._full.get(best.parent)
        if pe is not None:
            pe.children -= 1
        self.pool.release([best.page])
        self.pool.m.prefix_evictions.inc()
        return True


def _lcp(a, b) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    eq = np.asarray(a[:n]) == np.asarray(b[:n])
    if eq.all():
        return n
    return int(np.argmin(eq))


# ----------------------------------------------------------------------
# host swap tier
# ----------------------------------------------------------------------
def _runs(slots: Sequence[int]) -> List[Tuple[int, int, int]]:
    """``(first slot, index into slots, length)`` of each run of
    consecutive slots."""
    runs: List[Tuple[int, int, int]] = []
    for i, s in enumerate(slots):
        if runs and s == runs[-1][0] + runs[-1][2]:
            a, j, n = runs[-1]
            runs[-1] = (a, j, n + 1)
        else:
            runs.append((s, i, 1))
    return runs


class HostArena:
    """The swap tier below the device pool: one host tensor per page
    tensor of every layer, shaped like it with the page dim replaced by
    the arena capacity; arena slot ``i`` across all of them holds one
    logical page.  All of them are views of one preallocated byte buffer,
    pinned when the pool is on the card, so that the copies are DMA.

    ``gather`` and ``scatter`` wait for their copies before they return:
    the pages ``gather`` read are released right after and the next
    kernel may overwrite them, and the slots ``scatter`` read are freed
    right after."""

    def __init__(self, pool: PagedKVPool, capacity: int):
        self.capacity = capacity
        self.device = pool.device
        t0 = time.monotonic()
        shapes = []
        total = 0
        for layer in pool.page_layers:
            for key, t in layer.items():
                shape = (capacity, *t.shape[1:])
                n = t.dtype.itemsize * int(np.prod(shape))
                shapes.append((key, t.dtype, shape, total, n))
                total += -(-n // 256) * 256
        self.nbytes = total
        self.pinned = self.device.type == "cuda"
        blob = torch.empty(total, dtype=torch.uint8, pin_memory=self.pinned)
        self._bufs: List[Dict[str, torch.Tensor]] = []
        per_layer = len(pool.page_layers[0])
        for i, (key, dt, shape, off, n) in enumerate(shapes):
            if i % per_layer == 0:
                self._bufs.append({})
            self._bufs[-1][key] = blob[off:off + n].view(dt).view(shape)
        self.alloc_s = time.monotonic() - t0
        self._free: List[int] = []
        self.reset()

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def has_room(self, n: int) -> bool:
        return n <= len(self._free)

    def reset(self) -> None:
        self._free = list(range(self.capacity - 1, -1, -1))

    def free(self, slots: Sequence[int]) -> None:
        self._free.extend(slots)

    def gather(self, kv, pages: Sequence[int]) -> List[int]:
        """Copy the device ``pages`` into fresh arena slots, in order;
        the caller has checked :meth:`has_room`."""
        slots = sorted(self._free.pop() for _ in pages)
        if not pages:
            return slots
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        runs = _runs(slots)
        for layer, bufs in zip(kv, self._bufs):
            for key, buf in bufs.items():
                sel = layer[key].index_select(0, idx)
                for a, j, n in runs:      # in place: buf[slots] = would
                    buf.narrow(0, a, n).copy_(     # write a temporary
                        sel.narrow(0, j, n), non_blocking=True)
        _wait(self.device)
        return slots

    def scatter(self, kv, slots: Sequence[int], pages: Sequence[int]
                ) -> None:
        """Upload arena ``slots`` into the device ``pages``, in place."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        runs = _runs(slots)
        for layer, bufs in zip(kv, self._bufs):
            for key, buf in bufs.items():
                for a, j, n in runs:
                    layer[key].index_copy_(
                        0, idx[j:j + n], buf.narrow(0, a, n).to(
                            self.device, non_blocking=True))
        _wait(self.device)


# ----------------------------------------------------------------------
# recurrent-state slot rows
# ----------------------------------------------------------------------
class StatePool:
    """Slot-recycled fixed-state rows for recurrent mixers (the
    reference's ``StatePool``).

    A recurrent layer's continuous-batching cache is its dense decode
    cache with batch = ``max_slots``: slot index == row, and
    ``decode_step`` advances every live row as dense decode does.  What
    pages get from masking by length, state rows need explicitly: a
    retired request's rows would leak into the next occupant of the slot,
    so :meth:`reset_slot` overwrites them with the block's init state at
    admission — recompute preemption re-admits through the same reset,
    which is what makes the replayed prefix reproduce the stream.

    The rows live in the pool's per-layer cache list; this class knows
    which layers hold state (``model.STATE_KINDS``) and keeps one init row
    of each, the block's own (``LM.state_init``, the reference's
    ``block_cache_init(cfg, kind, 1, 0, dt)``): zeros for Mamba, and for
    the xLSTM zeros but the stabiliser ``m`` at -1e30 — a zeroed ``m``
    would move the first step's ``max(logf + m, logi)`` and with it the
    stream.  Under tensor-parallel serving the rows and the init rows
    are the rank's width (built under the engine's context); a row of
    another width than its layer's raises here, not in a copy that
    could broadcast."""

    def __init__(self, model, kv: List[Dict[str, torch.Tensor]]):
        self.entries = [layer for layer, kind in zip(kv, model.kinds)
                        if kind in model.STATE_KINDS]
        self.init_rows = [model.state_init(kind, 1, model.dtype)
                          for kind in model.kinds
                          if kind in model.STATE_KINDS]
        for layer, rows in zip(self.entries, self.init_rows):
            for key, t in layer.items():
                if t.shape[1:] != rows[key].shape[1:]:
                    raise ValueError(
                        f"state rows {key}: init row of "
                        f"{tuple(rows[key].shape[1:])} against the pool's "
                        f"{tuple(t.shape[1:])}")

    @property
    def has_state(self) -> bool:
        return bool(self.entries)

    def reset_slot(self, slot: int) -> None:
        """Overwrite slot ``slot``'s state rows with the init state, in
        place (the engine's cache tensors stay the same objects)."""
        for layer, rows in zip(self.entries, self.init_rows):
            for key, t in layer.items():
                t[slot].copy_(rows[key][0])
