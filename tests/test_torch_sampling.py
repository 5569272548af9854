"""Sampled decoding and static mode in the port, against the JAX engine.

On the sharpened-head params of ``tests/test_torch_serve.py`` (greedy
gaps wide enough that CPU reduction order cannot flip an argmax; magnitude
2:4 on every linear, packed by both engines), the same requests and the
same seed give the same token streams:

* continuous mode, sampled (temperature 0.8 with top-k 40 / with top-p
  0.9, plain temperature 1.0), at ``steps_per_sync`` 1 and 8, and with
  swap and recompute preemption on a 6-page pool — the per-(uid, step)
  key contract;
* static mode, greedy and sampled, in both burst variants (``fori``: EOS
  off and one ``max_new_tokens``; ``while``: mixed ``max_new_tokens`` or
  EOS set).

The float parts of a draw (softmax and cumsum in top-p, the Gumbel
noise's ``log``) may round an ulp away from XLA's; a flip would show as
a differing stream.  Measured here: 0 flipped draws in every case, so
the streams are held equal (each case also counts its draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.fused import filter_logits as j_filter_logits
from repro.serve.fused import sample_rows as j_sample_rows
from repro_torch import random as rnd
from repro_torch.serve import fused
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_serve import _pruned_pair, _requests

BASE = dict(max_batch=4, max_len=48, page_size=8, prefill_chunk=8,
            prefix_cache=False, host_swap_pages=0)
TOP_K = dict(temperature=0.8, top_k=40)
TOP_P = dict(temperature=0.8, top_p=0.9)
SEED = 7


@pytest.fixture(autouse=True)
def partitionable():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.threefry_partitionable(True):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    with jax.threefry_partitionable(True):
        return _pruned_pair("paper_tiny_lm")


def _run(pair, knobs, reqs, seed=SEED):
    jm, jp, tm, tp = pair
    cfg = dict(BASE, **knobs)
    jeng = JServeEngine(jm, jp, **cfg)
    want = jeng.generate([JRequest(uid=u, prompt=p, max_new_tokens=m)
                          for u, p, m in reqs], seed=seed)
    eng = ServeEngine(tm, tp, **cfg)
    got = eng.generate([Request(uid=u, prompt=p, max_new_tokens=m)
                        for u, p, m in reqs], seed=seed)
    return jeng, want, eng, got


def _assert_same(want, got):
    draws = 0
    for a, b in zip(want, got):
        assert a.uid == b.uid
        np.testing.assert_array_equal(b.tokens, a.tokens)
        draws += len(a.tokens)
    assert draws > 0


# ----------------------------------------------------------------------
def test_filter_logits_matches_reference():
    """top-k keeps the k-th value's ties; top-p's exclusive cumsum keeps
    at least the first entry."""
    rows = np.random.default_rng(0).normal(size=(16, 512)).astype(np.float32)
    rows[0, :50] = rows[0, 0]                     # a 50-way tie at the top
    rows[1, :3] = [9.0, 9.0, 9.0]
    for k, p in ((40, None), (None, 0.9), (40, 0.9), (1, None),
                 (None, 1e-6), (512, 1.0)):
        want = np.asarray(jax.vmap(lambda r: j_filter_logits(r, k, p))(
            jnp.asarray(rows)))
        got = fused.filter_logits(torch.from_numpy(rows), k, p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got[~np.isinf(got)],
                                      want[~np.isinf(want)])


def test_sample_rows_matches_reference():
    """Per-(uid, step) keys: one row's draw does not depend on the other
    rows.  4,096 draws at V = 512 (none flipped when measured)."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4096, 512)).astype(np.float32) * 2.0
    uids = rng.integers(0, 1000, size=4096).astype(np.int32)
    steps = rng.integers(0, 64, size=4096).astype(np.int32)
    for knobs in (TOP_K, TOP_P, dict(temperature=1.0)):
        want = np.asarray(j_sample_rows(
            jnp.asarray(logits), jnp.asarray(uids), jnp.asarray(steps),
            jax.random.key(SEED), **{**dict(top_k=None, top_p=None),
                                     **knobs}))
        got = fused.sample_rows(
            torch.from_numpy(logits), torch.from_numpy(uids),
            torch.from_numpy(steps), rnd.key(SEED),
            **{**dict(top_k=None, top_p=None), **knobs}).numpy()
        assert int(np.sum(got != want)) <= 4, knobs
    alone = fused.sample_rows(
        torch.from_numpy(logits[5:6]), torch.from_numpy(uids[5:6]),
        torch.from_numpy(steps[5:6]), rnd.key(SEED), temperature=1.0,
        top_k=None, top_p=None)
    assert int(alone[0]) == int(got[5])


@pytest.mark.parametrize("knobs", [
    dict(TOP_K, steps_per_sync=8),
    dict(TOP_P, steps_per_sync=1),
    dict(temperature=1.0, steps_per_sync=8),
    dict(TOP_K, num_pages=6, prefix_cache=True, host_swap_pages=None),
    dict(TOP_P, num_pages=6),
], ids=["top_k", "top_p_sync1", "temperature", "swap", "recompute"])
def test_sampled_streams_match_reference(pair, knobs):
    jeng, want, eng, got = _run(pair, knobs, _requests())
    _assert_same(want, got)
    for key in ("host_syncs", "preempt_swap", "preempt_recompute",
                "prefill_tok"):
        assert eng.stats[key] == jeng.stats[key], key
    if knobs.get("num_pages") == 6:
        kind = "preempt_swap" if knobs.get("prefix_cache") else \
            "preempt_recompute"
        assert eng.stats[kind] > 0


def test_sampled_streams_do_not_depend_on_sync_or_preemption(pair):
    """The per-(uid, step) contract inside the port: steps_per_sync 1 and
    8, swap and recompute preemption give the same streams."""
    _, _, tm, tp = pair
    reqs = [Request(uid=u, prompt=p, max_new_tokens=m)
            for u, p, m in _requests()]
    streams = []
    for knobs in (dict(steps_per_sync=8), dict(steps_per_sync=1),
                  dict(num_pages=6, host_swap_pages=None),
                  dict(num_pages=6)):
        eng = ServeEngine(tm, tp, **dict(BASE, **TOP_P, **knobs))
        streams.append([r.tokens for r in eng.generate(reqs, seed=SEED)])
        if "num_pages" in knobs:
            assert eng.stats["preemptions"] > 0
    for other in streams[1:]:
        for a, b in zip(streams[0], other):
            np.testing.assert_array_equal(a, b)
    eng = ServeEngine(tm, tp, **dict(BASE, **TOP_P))
    moved = [r.tokens for r in eng.generate(reqs, seed=SEED + 1)]
    assert any(len(a) and not np.array_equal(a, b)
               for a, b in zip(streams[0], moved))      # the seed matters


@pytest.mark.parametrize("knobs,same_max_new", [
    (dict(mode="static"), False),
    (dict(mode="static", **TOP_K), True),              # fori variant
    (dict(mode="static", **TOP_P), False),             # while variant
    (dict(mode="static", temperature=1.0, eos_id=3), True),   # while
], ids=["greedy", "top_k_fori", "top_p_while", "eos_while"])
def test_static_mode_matches_reference(pair, knobs, same_max_new):
    """Buckets by prompt length (4/13/20 tokens), one host sync each."""
    reqs = _requests()
    if same_max_new:
        reqs = [(u, p, 6) for u, p, _ in reqs]
    jeng, want, eng, got = _run(pair, knobs, reqs)
    _assert_same(want, got)
    for key in ("host_syncs", "device_steps", "tokens"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["host_syncs"] == 3                 # 3 buckets
    assert [r.decode_steps for r in got] == [r.decode_steps for r in want]


def test_static_mode_refuses_sessions(pair):
    _, _, tm, tp = pair
    eng = ServeEngine(tm, tp, **dict(BASE, mode="static"))
    assert eng.pool is None
    with pytest.raises(RuntimeError, match="continuous"):
        eng.session()
