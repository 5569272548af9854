"""Paged serve cache: refcounted KV pages and per-slot block tables.

The continuous-batching runtime stores every request's attention KV in
fixed-size pages drawn from one pool — per layer a (num_pages,
page_size, KV, hd) K and V tensor (``LM.init_paged_cache``).  A request
owns a block-table row mapping its logical token positions to physical
page ids.

Page ownership is refcounted: ``alloc`` hands out pages at refcount 1,
``retain``/``release`` move the count, and a page returns to the free
list when its last reference drops.  A shared page (refcount > 1) is
read-only: :meth:`PagedKVPool.ensure_writable` copies it into a fresh
page before a write lands in it.

Page 0 is the reserved scrap page: never allocated, it absorbs the
writes of padded prompt positions and idle decode slots (attention
masks by length, so scrap contents are never read).

The page tensors are updated in place by the model's paged writes (the
JAX pool is rebuilt functionally and donated instead).  The prefix
cache, the host swap arena and the recurrent-state pool are not ported
(ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


class PagedKVPool:
    """Refcounted free-list page allocator + the device page tensors.

    Allocation state (free list, refcounts, block tables, per-slot page
    counts) is host-side numpy; :meth:`tables_device` keeps a device
    mirror of the block tables, re-uploading only rows that changed.
    """

    def __init__(self, model, *, num_pages: int, page_size: int,
                 max_slots: int, max_len: int,
                 dtype: Optional[torch.dtype] = None):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is scrap)")
        self.page_size = page_size
        self.num_pages = num_pages
        self.pages_per_slot = -(-max_len // page_size)
        self.device = model.device
        self.kv = model.init_paged_cache(num_pages, page_size, dtype)
        self.block_tables = np.zeros((max_slots, self.pages_per_slot),
                                     np.int32)
        self._n_pages = np.zeros((max_slots,), np.int32)
        self._free: List[int] = []
        self._ref = np.zeros((num_pages,), np.int32)
        self._tables_dev: Optional[torch.Tensor] = None
        self._dirty: set = set()          # slot rows changed since upload
        self.reset()

    # ----------------------------------------------------------- alloc
    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the scrap page)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages at refcount 1; None if it would overdraw
        (all-or-nothing, so a half-admitted request never holds pages)."""
        if n <= 0:
            return []
        if n > len(self._free):
            return None
        out = self._free[-n:][::-1]
        del self._free[-n:]
        self._ref[out] = 1
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
        """Recycle every page.  The page tensors keep stale contents —
        attention masks by length, so stale pages are never read."""
        self.block_tables[:] = 0
        self._n_pages[:] = 0
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref[:] = 0
        self._tables_dev = None
        self._dirty.clear()

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
        """Every layer's ``dst`` page gets ``src``'s contents."""
        for layer in self.kv:
            for t in layer.values():
                t[dst] = t[src]

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
