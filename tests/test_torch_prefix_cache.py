"""The port's prefix index, copy-on-write attach and host swap on CPU,
held against the JAX package: ``PrefixCache`` (digest, match with its
n-1 cap and partial-tail longest common prefix, register with dedup and
the collision stop, LRU eviction feeding ``alloc``, the recency bump) on
pools of both packages with equal page ids and return tuples; the arena
holding the bytes; and the reference's single-device engine cases
(prefix parity and savings, greedy and sampled, swap against recompute,
the seeded refcount walk, the random walk with prefix sharing,
copy-on-write, swap preemption and cancel interleaved), with the port's
token streams and counters equal to the JAX engine's on the same
requests.
"""

import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import LM as JLM
from repro.serve import PagedKVPool as JPagedKVPool
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.kvpool import PrefixCache as JPrefixCache
from repro.ckpt.store import _flatten
from repro_torch import configs
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvpool import PagedKVPool, PrefixCache
from repro_torch.serve.scheduler import Scheduler, SeqState

COUNTERS = ("host_syncs", "prefix_hit_tokens", "prefill_tok", "cow_copies",
            "preempt_swap", "preempt_recompute", "swap_out_pages",
            "swap_in_pages", "prefix_evictions")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs several workers on the machine's
    cores, and torch's default pool of a thread a core in each of them
    oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """The smoke tiny LM in both packages with the same weights, the head
    sharpened (greedy gaps wide enough that reduction order cannot flip
    an argmax, as the reference's serve tests do)."""
    jm = JLM(j_get_smoke("paper_tiny_lm"))
    jp = jm.init(jax.random.key(0))
    jp["unembed"]["head"] = jp["unembed"]["head"] * 8.0
    tm = LM(configs.get_smoke("paper_tiny_lm"), device="cpu")
    return jm, jp, tm, tm.params_from_jax(_flatten(jp))


def _pools(pair, *, num_pages=9, page_size=4, max_slots=3, max_len=32,
           **kw):
    jm, _, tm, _ = pair
    shape = dict(num_pages=num_pages, page_size=page_size,
                 max_slots=max_slots, max_len=max_len, **kw)
    return JPagedKVPool(jm, **shape), PagedKVPool(tm, **shape)


# ======================================================================
# the prefix index against the reference's
# ======================================================================
@pytest.mark.parametrize("parent,tokens,partial", [
    (b"root", [1, 2, 3, 4], False),
    (b"root", [1, 2, 3], True),
    (bytes(range(16)), [70000, -1, 0, 5], False)])
def test_digest_matches_reference(parent, tokens, partial):
    assert (PrefixCache._digest(parent, tokens, partial)
            == JPrefixCache._digest(parent, tokens, partial))


def test_prefix_match_chain_and_cap(pair):
    for pool in _pools(pair, prefix_cache=True):
        ps = pool.page_size
        toks = np.arange(1, 1 + 3 * ps, dtype=np.int32)     # 3 full pages
        pages = pool.alloc(3)
        pool.prefix.register(toks, pages)
        pool.release(pages)                  # index refs keep them live
        assert all(pool.refcount(p) == 1 for p in pages)
        # full coverage caps at L-1: the last page is the CoW source
        assert pool.prefix.match(toks) == (pages[:2], pages[2], 3 * ps - 1)
        longer = np.concatenate([toks, [99, 98]]).astype(np.int32)
        assert pool.prefix.match(longer) == (pages, None, 3 * ps)
        div = toks.copy()
        div[ps + 1] = 77                     # diverges inside page 2
        assert pool.prefix.match(div) == (pages[:1], None, ps)
        assert pool.prefix.match(np.asarray([9, 9, 9], np.int32)) == (
            [], None, 0)


def test_prefix_partial_tail_lcp(pair):
    for pool in _pools(pair, prefix_cache=True):
        ps = pool.page_size
        kv_toks = np.asarray([*range(1, ps + 1), 50, 51, 52], np.int32)
        pages = pool.alloc(2)
        pool.prefix.register(kv_toks, pages, include_partial=True)
        pool.release(pages)
        prompt = np.asarray([*range(1, ps + 1), 50, 51, 60, 61], np.int32)
        assert pool.prefix.match(prompt) == (pages[:1], pages[1], ps + 2)
        # the LCP is capped at L-1 through the partial path too
        assert pool.prefix.match(kv_toks) == (pages[:1], pages[1], ps + 2)


def test_prefix_register_dedup_and_collision_stop(pair):
    """A known digest is a recency bump (no second reference); an entry
    whose stored tokens differ (a digest collision) stops the chain."""
    outs = []
    for pool in _pools(pair, prefix_cache=True):
        ps = pool.page_size
        toks = np.arange(1, 1 + 3 * ps, dtype=np.int32)
        pages = pool.alloc(3)
        pool.prefix.register(toks, pages, include_partial=True)
        pool.prefix.register(toks, pages, include_partial=True)
        assert len(pool.prefix) == 3
        assert [pool.refcount(p) for p in pages] == [2, 2, 2]
        # forge a collision on page 1's entry: its tokens no longer match
        e = next(e for e in pool.prefix._full.values() if e.page == pages[1])
        e.tokens = e.tokens + 1
        other = pool.alloc(3)
        longer = np.concatenate([toks, np.arange(200, 200 + ps)])
        pool.prefix.register(longer.astype(np.int32), pages + other[:1])
        assert len(pool.prefix) == 3         # the chain stopped at page 1
        assert pool.refcount(other[0]) == 1
        outs.append((pages, other, [pool.refcount(p) for p in range(9)]))
        pool.check_invariants()
    assert outs[0] == outs[1]


def test_prefix_lru_eviction_feeds_alloc(pair):
    """A short free list evicts index leaves LRU-first from inside alloc,
    never an entry another chain still hangs off."""
    outs = []
    for pool in _pools(pair, num_pages=5, prefix_cache=True):
        ps = pool.page_size
        a = np.arange(1, 1 + 2 * ps, dtype=np.int32)          # chain of 2
        pages = pool.alloc(2)
        pool.prefix.register(a, pages)
        pool.release(pages)
        assert pool.free_pages == 2 and len(pool.prefix) == 2
        got = pool.alloc(3)                  # evicts the leaf (page 2)
        assert pool.stats["prefix_evictions"] == 1
        pool.check_invariants()
        outs.append((pages, got, pool.prefix.match(a)))
    assert outs[0] == outs[1]
    pages, got, match = outs[1]
    assert pages[1] in got and pages[0] not in got
    assert match == (pages[:1], None, ps)    # the root entry survived


def test_prefix_match_bumps_recency(pair):
    for pool in _pools(pair, num_pages=6, prefix_cache=True):
        ps = pool.page_size
        a = np.arange(1, 1 + ps, dtype=np.int32)
        b = np.arange(100, 100 + ps, dtype=np.int32)
        pa = pool.alloc(1)
        pool.prefix.register(a, pa)
        pool.release(pa)
        pb = pool.alloc(1)
        pool.prefix.register(b, pb)
        pool.release(pb)
        # a is older, but matching it makes b the LRU victim
        pool.prefix.match(np.concatenate([a, [7]]).astype(np.int32))
        pool.alloc(4)                        # exactly one eviction
        assert pool.prefix.match(np.append(a, 7).astype(np.int32))[0] == pa
        assert pool.prefix.match(np.append(b, 7).astype(np.int32))[0] == []


def _cache_walk(pool, seed):
    """Admission-like traffic over the index: match, pin, alloc (which may
    evict), copy-on-write source release, register with or without the
    partial tail, and slot releases — prompts drawn from a few shared
    stems so that chains and tails match.  Returns everything observed."""
    rng = np.random.default_rng(seed)
    ps = pool.page_size
    stems = rng.integers(1, 4, (3, 3 * ps)).astype(np.int32)
    held, seen = [], []
    for _ in range(60):
        if rng.random() < 0.65 or not held:
            stem = stems[rng.integers(0, 3)]
            cut = int(rng.integers(1, len(stem) + 1))
            toks = np.concatenate([stem[:cut], rng.integers(
                1, 4, int(rng.integers(0, ps))).astype(np.int32)])
            shared, cow, n = pool.prefix.match(toks)
            pins = shared + ([cow] if cow is not None else [])
            for p in pins:
                pool.retain(p)
            fresh = pool.alloc(pool.pages_for(len(toks)) - len(shared))
            seen.append(("match", shared, cow, n, fresh))
            if fresh is None:
                pool.release(pins)
                continue
            if cow is not None:
                pool.release([cow])
            pages = shared + fresh
            pool.prefix.register(toks, pages,
                                 include_partial=bool(rng.random() < 0.5))
            held.append(pages)
        else:
            pool.release(held.pop(int(rng.integers(0, len(held)))))
        pool.check_invariants()
        seen.append(("state", pool._ref.tolist(), len(pool.prefix),
                     pool.stats["prefix_evictions"], pool.free_pages))
    return seen


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_walk_matches_reference(pair, seed):
    jpool, tpool = _pools(pair, num_pages=9, prefix_cache=True)
    want, got = _cache_walk(jpool, seed), _cache_walk(tpool, seed)
    assert got == want
    assert any(s[0] == "match" and s[3] > 0 for s in got)
    assert any(s[0] == "match" and s[2] is not None for s in got)
    assert got[-1][3] > 0                    # evictions happened


# ======================================================================
# the host arena
# ======================================================================
def _stamp(pool, page, value):
    for layer in pool.kv:
        for t in layer.values():
            t[page] = value


@pytest.mark.parametrize("dtype", [None, torch.int8])
def test_arena_holds_the_bytes(pair, dtype):
    """swap_out copies the exclusive pages (int8 scales with them) into
    the arena — the arena itself holds the bytes — and keeps the shared
    page on the device; swap_in restores them bit for bit into fresh
    pages after the old ones were overwritten."""
    tpool = PagedKVPool(pair[2], num_pages=9, page_size=4, max_slots=3,
                        max_len=32, host_swap_pages=4, dtype=dtype)
    a, b, c = tpool.alloc(3)
    for p, v in ((a, 3), (b, 5), (c, 7)):
        _stamp(tpool, p, v)
    tpool.assign(0, [a, b, c])
    tpool.retain(a)                          # a is shared: kept
    rec = tpool.swap_out(0)
    assert rec.entries == [("kept", a), ("host", 0), ("host", 1)]
    assert tpool.stats["swap_out_pages"] == 2
    assert tpool.slot_pages(0) == [] and tpool.refcount(b) == 0
    for layer, bufs in zip(tpool.kv, tpool.arena._bufs):
        assert set(bufs) == set(layer)
        for key, buf in bufs.items():
            assert (buf[0] == 5).all() and (buf[1] == 7).all(), key
    _stamp(tpool, b, 0)                      # the freed pages are reused
    _stamp(tpool, c, 0)
    assert tpool.arena.free_slots == 2
    assert tpool.swap_in(1, rec)
    pages = tpool.slot_pages(1)
    assert pages[0] == a and tpool.refcount(a) == 2
    for layer in tpool.kv:
        for t in layer.values():
            assert (t[pages[1]] == 5).all() and (t[pages[2]] == 7).all()
    assert tpool.arena.free_slots == 4 and tpool.stats["swap_in_pages"] == 2
    tpool.clear_slot(1)
    tpool.release([a])
    tpool.check_invariants()


def test_swap_needs_room_and_drop_swap_frees_everything(pair):
    _, tpool = _pools(pair, host_swap_pages=1)
    pages = tpool.alloc(3)
    tpool.assign(0, pages)
    assert tpool.swap_out(0) is None         # 3 exclusive pages, 1 slot
    assert tpool.slot_pages(0) == pages      # untouched
    tpool.retain(pages[0])
    tpool.retain(pages[1])
    rec = tpool.swap_out(0)
    assert rec.n_host == 1 and tpool.arena.free_slots == 0
    tpool.drop_swap(rec)
    assert tpool.arena.free_slots == 1
    tpool.release(pages[:2])
    assert tpool.free_pages == tpool.capacity
    tpool.check_invariants()


def test_dropped_engine_frees_its_pages_without_the_cycle_collector(pair):
    """The index refers back to its pool weakly: dropping an engine with
    the prefix cache and the arena on frees its page tensors at once."""
    import gc
    import weakref

    _, _, tm, tp = pair
    gc.disable()
    try:
        eng = ServeEngine(tm, tp, max_batch=2, max_len=32, page_size=8)
        eng.generate(_prefix_requests(Request, n=3))
        pages = weakref.ref(eng.pool.kv[0]["k"])
        del eng
        assert pages() is None
    finally:
        gc.enable()


# ======================================================================
# engine cases of the reference, port against the JAX engine
# ======================================================================
def _prefix_requests(cls, n=8, tail=2, max_new=6):
    shared = np.arange(5, 17, dtype=np.int32)      # 12-token system prefix
    return [cls(uid=i, prompt=np.concatenate(
        [shared, np.asarray([20 + i] * tail, np.int32)]),
        max_new_tokens=max_new) for i in range(n)]


def _same_results(want, got):
    assert [r.uid for r in want] == [r.uid for r in got]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.tokens, a.tokens)


def test_engine_prefix_parity_and_savings(pair):
    """Prefix sharing changes prefill work, never tokens: streams equal
    with the cache on and off, the savings in the counters, and the
    port's counters equal to the JAX engine's."""
    jm, jp, tm, tp = pair
    kw = dict(max_batch=4, max_len=64, page_size=8, num_pages=17,
              host_swap_pages=0)
    off = ServeEngine(tm, tp, prefix_cache=False, **kw)
    base = off.generate(_prefix_requests(Request))
    on = ServeEngine(tm, tp, prefix_cache=True, **kw)
    got = on.generate(_prefix_requests(Request))
    _same_results(base, got)
    assert on.stats["prefix_hit_tokens"] > 0
    assert on.stats["prefill_tok"] < off.stats["prefill_tok"]
    assert off.stats["prefix_hit_tokens"] == 0
    on.pool.check_invariants()
    jon = JServeEngine(jm, jp, prefix_cache=True, **kw)
    _same_results(jon.generate(_prefix_requests(JRequest)), got)
    for k in COUNTERS:
        assert on.stats[k] == jon.stats[k], k


def _preempt_requests(cls, n=6, vocab=256):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(1, vocab, (4, 9, 13)[i % 3]
                                           ).astype(np.int32),
                max_new_tokens=(22, 9, 26)[i % 3]) for i in range(n)]


def test_swap_preemption_bit_identical_to_recompute(pair):
    """Under a pool tight enough to preempt, swap resumes give exactly
    the streams recompute gives, and the counters say which ran."""
    jm, jp, tm, tp = pair
    kw = dict(max_batch=3, max_len=48, page_size=8, num_pages=8,
              prefix_cache=False, steps_per_sync=4)
    rec = ServeEngine(tm, tp, host_swap_pages=0, **kw)
    base = rec.generate(_preempt_requests(Request))
    swp = ServeEngine(tm, tp, host_swap_pages=None, **kw)
    got = swp.generate(_preempt_requests(Request))
    _same_results(base, got)
    assert rec.stats["preempt_recompute"] > 0
    assert rec.stats["preempt_swap"] == 0
    assert swp.stats["preempt_swap"] > 0
    assert swp.stats["preempt_recompute"] == 0
    assert swp.stats["swap_out_pages"] == swp.stats["swap_in_pages"] > 0
    assert swp.stats["prefill_tok"] < rec.stats["prefill_tok"]
    assert swp.stats["preemptions"] == swp.stats["preempt_swap"]
    assert swp.pool.arena.free_slots == swp.pool.arena.capacity
    swp.pool.check_invariants()
    jswp = JServeEngine(jm, jp, host_swap_pages=None, **kw)
    _same_results(jswp.generate(_preempt_requests(JRequest)), got)
    for k in COUNTERS:
        assert swp.stats[k] == jswp.stats[k], k


def _refcount_walk(pool, ops):
    """Interpret an op list against the pool and a shadow refcounter,
    checking the accounting after every op; returns what alloc gave."""
    shadow, allocs = {}, []
    for op in ops:
        kind, arg = op % 3, op // 3
        if kind == 0:                        # alloc 1..3 pages
            n = arg % 3 + 1
            pages = pool.alloc(n)
            allocs.append(pages)
            if len(shadow) + n <= pool.capacity:
                assert pages is not None
                for p in pages:
                    assert p not in shadow
                    shadow[p] = 1
            else:
                assert pages is None
        elif kind == 1 and shadow:           # share a live page
            p = sorted(shadow)[arg % len(shadow)]
            pool.retain(p)
            shadow[p] += 1
        elif kind == 2 and shadow:           # drop one reference
            p = sorted(shadow)[arg % len(shadow)]
            pool.release([p])
            shadow[p] -= 1
            if shadow[p] == 0:
                del shadow[p]
        pool.check_invariants()
        for p, r in shadow.items():
            assert pool.refcount(p) == r
    assert pool.free_pages == pool.capacity - len(shadow)
    return allocs


def test_refcount_state_machine_seeded(pair):
    """The reference's seeded 400-op walks over alloc/retain/release, on
    both pools: the same pages handed out."""
    for seed in range(3):
        ops = np.random.default_rng(seed).integers(0, 300, 400).tolist()
        jpool, tpool = _pools(pair, num_pages=7)
        assert _refcount_walk(tpool, ops) == _refcount_walk(jpool, ops)


def _walk_requests(vocab=256):
    rng = np.random.default_rng(42)
    shared = np.arange(5, 17, dtype=np.int32)
    reqs = []
    for i in range(10):
        if i % 2 == 0:            # shared system prefix + short tail
            prompt = np.concatenate(
                [shared, rng.integers(1, vocab, 2).astype(np.int32)])
        else:                     # unique prompt
            prompt = rng.integers(1, vocab, int(rng.integers(3, 14))
                                  ).astype(np.int32)
        reqs.append((i, prompt, int(rng.integers(1, 18))))
    return reqs


def test_engine_random_walk_invariants(pair):
    """The lifecycle interleaving — admit, prefix share, copy-on-write,
    retire, swap preemption, cancel (mid-decode and swapped out) and a
    hard deadline — driven by a seeded walk through the port's session
    and the JAX session in lockstep on a tight pool: the same events at
    every step, pool invariants after every step, the surviving streams
    equal to a roomy run's, and the same counters."""
    jm, jp, tm, tp = pair
    reqs = _walk_requests()
    base = ServeEngine(tm, tp, max_batch=4, max_len=48, page_size=8,
                       num_pages=33, prefix_cache=False, host_swap_pages=0
                       ).generate([Request(uid=u, prompt=p, max_new_tokens=m)
                                   for u, p, m in reqs])
    kw = dict(max_batch=3, max_len=48, page_size=8, num_pages=9,
              prefix_cache=True, steps_per_sync=3)
    eng, jeng = ServeEngine(tm, tp, **kw), JServeEngine(jm, jp, **kw)
    ses, jses = eng.session(), jeng.session(seed=0)
    rng = np.random.default_rng(7)
    pending = list(reqs)
    results, cancelled = {}, {"running": 0, "swapped": 0}
    past = time.monotonic() - 1.0
    while pending or ses.has_work():
        for _ in range(int(rng.integers(0, 3))):
            if pending:
                u, p, m = pending.pop(0)
                hard = u == 9             # already past its hard deadline
                ses.submit(Request(uid=u, prompt=p, max_new_tokens=m,
                                   deadline=past if hard else None,
                                   deadline_hard=hard))
                jses.submit(JRequest(uid=u, prompt=p, max_new_tokens=m,
                                     deadline=past if hard else None,
                                     deadline_hard=hard))
        evs, jevs = [], []
        swapped = [s for s in ses.sched.waiting if s.swap is not None]
        running = [s for s in ses.sched.running
                   if s.state is SeqState.RUNNING and s.tokens]
        victim = None
        if swapped and not cancelled["swapped"]:
            victim, kind = swapped[0], "swapped"
        elif running and not cancelled["running"] and len(results) > 2:
            victim, kind = running[-1], "running"
        if victim is not None:
            cancelled[kind] += 1
            evs.append(ses.cancel(victim.req.uid))
            jevs.append(jses.cancel(victim.req.uid))
            eng.pool.check_invariants()
            arena = eng.pool.arena
            held = sum(s.swap.n_host for s in ses.sched.waiting
                       if s.swap is not None)
            assert arena.free_slots == arena.capacity - held
        if ses.has_work():
            evs += ses.step()
            jevs += jses.step()
        eng.pool.check_invariants()
        assert [(e.uid, e.tokens, e.finished, e.finish_reason)
                for e in evs] == [(e.uid, e.tokens, e.finished,
                                   e.finish_reason) for e in jevs]
        for ev in evs:
            if ev.finished:
                results[ev.uid] = ev
    assert cancelled == {"running": 1, "swapped": 1}
    assert len(results) == len(reqs)
    reasons = {u: e.finish_reason for u, e in results.items()}
    assert reasons[9] == "timeout"
    assert list(reasons.values()).count("cancelled") == 2
    for r in base:
        if reasons[r.uid] in ("stop", "length"):
            np.testing.assert_array_equal(r.tokens,
                                          results[r.uid].result.tokens)
    assert eng.stats["prefix_hit_tokens"] > 0
    assert eng.stats["preempt_swap"] > 0
    assert eng.stats["cancelled"] == 2 and eng.stats["deadline_exceeded"] == 1
    assert eng.pool.arena.free_slots == eng.pool.arena.capacity
    for k in COUNTERS:
        assert eng.stats[k] == jeng.stats[k], k


def test_cancel_events_and_finish_reasons(pair):
    _, _, tm, tp = pair
    eng = ServeEngine(tm, tp, max_batch=1, max_len=32, page_size=8,
                      steps_per_sync=2)
    ses = eng.session()
    for u in range(3):
        ses.submit(Request(uid=u, prompt=np.arange(1, 6, dtype=np.int32),
                           max_new_tokens=12))
    ses.step()
    ev = ses.cancel(0)                       # slotted, mid-decode
    assert ev.finished and ev.finish_reason == "cancelled" and not ev.tokens
    assert len(ev.result.tokens) >= 1
    assert ses.cancel(2).finish_reason == "cancelled"     # waiting
    assert ses.cancel(2) is None and ses.cancel(17) is None
    evs = []
    while ses.has_work():
        evs += ses.step()
    assert [(e.uid, e.finish_reason) for e in evs if e.finished] == [
        (1, "length")]
    assert eng.stats["cancelled"] == 2
    eng.pool.check_invariants()
    # only the prefix index holds pages now
    assert eng.pool.free_pages + len(eng.pool.prefix) == eng.pool.capacity


@pytest.mark.parametrize("dtype", [None, torch.int8])
def test_prefill_after_cow_attach_mid_page(pair, dtype):
    """A prompt that shares 11 tokens of an earlier one (a full page of 8
    and 3 tokens of its partial tail) attaches the page and a copy of the
    tail page, and prefills from position 11, mid-page: its last logits
    equal an unshared prefill's."""
    _, _, tm, tp = pair
    ps = chunk = 8
    rng = np.random.default_rng(3)
    a = rng.integers(1, 256, 14).astype(np.int32)
    b = np.concatenate([a[:11], 255 - a[11:14],
                        rng.integers(1, 256, 6).astype(np.int32)])

    def prefill(pool, seq):
        row = pool.tables_device()[seq.slot:seq.slot + 1]
        prompt = seq.req.prompt
        for start in range(seq.n_prefilled, len(prompt), chunk):
            toks = np.zeros((1, chunk), np.int32)
            piece = prompt[start:start + chunk]
            toks[0, :len(piece)] = piece
            logits = tm.prefill_chunk(tp, torch.from_numpy(toks), pool.kv,
                                      start, len(prompt), row,
                                      page_size=ps)
        return logits

    out = {}
    for cache in (True, False):
        pool = PagedKVPool(tm, num_pages=12, page_size=ps, max_slots=2,
                           max_len=32, dtype=dtype, prefix_cache=cache)
        sched = Scheduler(pool, 2)
        if cache:
            sa = sched.submit(Request(uid=0, prompt=a))
            sched.admit()
            prefill(pool, sa)
            pool.prefix.register(a, pool.slot_pages(sa.slot),
                                 include_partial=True)
            sched.finish(sa)
        sb = sched.submit(Request(uid=1, prompt=b))
        sched.admit()
        assert sb.n_prefilled == (11 if cache else 0)
        out[cache] = prefill(pool, sb)
        if cache:
            assert pool.stats["cow_copies"] == 1
            assert sched.stats["prefix_hit_tokens"] == 11
            assert sched.stats["prefill_tok"] == len(a) + len(b) - 11
        pool.check_invariants()
    torch.testing.assert_close(out[True], out[False], rtol=1e-5, atol=1e-5)
    assert torch.equal(out[True].argmax(-1), out[False].argmax(-1))


def test_engine_prefix_parity_sampled(pair):
    """Sampled streams (temperature 1.0, top-k 5, seed 3) are the same
    with the prefix cache on and off: every draw is keyed per (uid,
    step), so attaching cached pages changes work, never tokens."""
    _, _, tm, tp = pair
    kw = dict(max_batch=4, max_len=64, page_size=8, num_pages=17,
              temperature=1.0, top_k=5, host_swap_pages=0)
    base = ServeEngine(tm, tp, prefix_cache=False, **kw).generate(
        _prefix_requests(Request), seed=3)
    on = ServeEngine(tm, tp, prefix_cache=True, **kw)
    got = on.generate(_prefix_requests(Request), seed=3)
    _same_results(base, got)
    assert on.stats["prefix_hit_tokens"] > 0


def test_swap_disabled_for_recurrent_state():
    """Hybrid/recurrent archs keep recompute preemption: their state
    rows live outside the page pool, so a KV-only swap would resume
    from the wrong state (kvpool.StatePool docstring)."""
    from repro_torch import random as rnd
    from repro_torch.models.base import ArchConfig

    cfg = ArchConfig(name="hyb-swap-test", family="hybrid", num_layers=4,
                     d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                     d_ff=128, vocab_size=256, period=("mamba", "attn"),
                     ssm_state=4, dtype="float32")
    model = LM(cfg, device="cpu")
    params = model.init(rnd.key(1))
    eng = ServeEngine(model, params, max_batch=2, max_len=32,
                      page_size=8, host_swap_pages=64)
    assert eng.state_pool is not None
    assert eng._swap_ok is False
    # and a tight run still completes via recompute
    reqs = [Request(uid=i, prompt=np.arange(1, 6, dtype=np.int32),
                    max_new_tokens=8) for i in range(3)]
    res = eng.generate(reqs)
    assert all(len(r.tokens) == 8 for r in res)
    assert eng.stats["preempt_swap"] == 0


def test_shared_prefix_2x4_mesh_parity():
    """The reference's acceptance pin on a real 2x4 mesh — eight ``gloo``
    ranks on the CPU (tests/torch_dist_worker.py), tensor-parallel over
    4, the schedule replicated over 2: greedy and sampled streams with
    prefix sharing and swap on equal those with both off, and equal the
    port's and the JAX engine's one-device streams."""
    import torch_dist_worker as W
    from repro.configs import get_config as j_get_config

    jm = JLM(j_get_config("paper_tiny_lm"))
    jp = jm.init(jax.random.key(0))
    jp["unembed"]["head"] = jp["unembed"]["head"] * 8.0
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    ranks = W.run_groups((8,), flat, None, timeout=600.0,
                         cases="prefix_2x4")[8]
    tm = LM(configs.get_config("paper_tiny_lm"), device="cpu")
    one = W.prefix_2x4_streams(tm, tm.params_from_jax(flat))
    reqs = [JRequest(uid=u, prompt=p, max_new_tokens=m)
            for u, p, m in W.prefix_2x4_requests()]
    for sampled in (False, True):
        kw = dict(W.PREFIX_2X4, **(dict(temperature=1.0, top_k=5)
                                   if sampled else {}))
        want = [np.asarray(r.tokens).tolist() for r in JServeEngine(
            jm, jp, prefix_cache=True, **kw).generate(reqs, seed=3)]
        assert one[sampled][1] == want and one[sampled][0] == want
        for r in ranks:
            off, on, hits = r["streams"][sampled]
            assert hits > 0
            assert off == on == want, (r["rank"], sampled)

