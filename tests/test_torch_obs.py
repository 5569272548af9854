"""The port's observability (``repro_torch.obs`` and the serve stack's
series) against the JAX package's.

* The registry: counters under concurrent increments, negative
  increments refused, histogram bucket edges and quantiles,
  ``exp_buckets``, gauges with ``set_fn``, the disabled registry, and
  ``merge_histograms`` — each equal to the reference's on the same
  operations; the Prometheus text exposition byte for byte.
* The tracer: the same event dicts as the reference's under one clock.
* The serve stack: on the same traffic (a 6-page pool that preempts by
  swap and recompute, a shared-prefix wave, the sharpened-head 2:4
  params of ``tests/test_torch_serve.py``) the port engine emits the
  JAX engine's request-lifecycle and preemption events in the same
  order with the same arguments; tracing on gives the streams of
  tracing off; ``engine.stats`` is re-based at each ``generate()``.

Tolerance: exact equality for tokens, bytes, counters and event lists.
"""

import threading

import numpy as np
import pytest
import torch

from repro.obs import Obs as JObs
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.obs import Obs
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serve.engine import STAT_KEYS, Request, ServeEngine
from test_torch_serve import DEFAULTS, _pruned_pair, _requests

# a 6-page pool with the reference's defaults: swap and recompute
# preemption, prefix attaches and copy-on-write on the shared wave
KNOBS = dict(max_batch=4, max_len=48, page_size=8, prefill_chunk=8,
             num_pages=6, steps_per_sync=4, prefix_cache=True,
             host_swap_pages=None)


@pytest.fixture(scope="module")
def pair():
    return _pruned_pair("paper_tiny_lm")


@pytest.fixture(scope="module")
def jax_run(pair):
    """The JAX engine's streams, stats and events on the shared traffic
    (one engine for the file: its compiles are the cost)."""
    jm, jp, _, _ = pair
    eng = JServeEngine(jm, jp, obs=JObs.create(trace=True), **KNOBS)
    res = eng.generate([JRequest(uid=u, prompt=p, max_new_tokens=m)
                        for u, p, m in _traffic()])
    return eng, res


def _traffic():
    return _requests(shared=DEFAULTS["shared"])


def _port(pair, **kw):
    _, _, tm, tp = pair
    return ServeEngine(tm, tp, **dict(KNOBS, **kw))


def _gen(eng):
    return eng.generate([Request(uid=u, prompt=p, max_new_tokens=m)
                         for u, p, m in _traffic()])


def _streams(res):
    return {r.uid: [int(t) for t in r.tokens] for r in res}


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------
def test_counter_concurrent_increments_and_negative_refused():
    reg = tmetrics.MetricsRegistry()
    c = reg.counter("x_total", "x", ("replica",)).labels(replica="r0")
    threads = [threading.Thread(target=lambda: [c.inc() for _ in
                                                range(5000)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 20000
    for mod in (tmetrics, jmetrics):
        with pytest.raises(ValueError, match="only go up"):
            mod.MetricsRegistry().counter("y_total").inc(-1)
    with pytest.raises(ValueError):          # a label-name mismatch
        reg.counter("x_total", "x", ("other",))
    with pytest.raises(ValueError):          # a kind mismatch
        reg.gauge("x_total", "x", ("replica",))


BOUNDS = (0.5, 1.0, 2.0, 4.0)
SAMPLES = (0.0, 0.5, 0.5000001, 1.0, 1.5, 2.0, 3.99, 4.0, 4.01, 100.0)


def test_histogram_edges_and_quantiles_match_reference():
    """``le`` is inclusive (0.5 lands in the 0.5 bucket, 4.01 in +Inf),
    and every quantile interpolates as the reference's."""
    hs = []
    for mod in (tmetrics, jmetrics):
        h = mod.MetricsRegistry().histogram("h_seconds", "h",
                                            buckets=BOUNDS)
        for v in SAMPLES:
            h.observe(v)
        hs.append(h.labels())
    t, j = hs
    assert t.cumulative() == j.cumulative() == [2, 4, 6, 8, 10]
    for q in (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0):
        assert t.quantile(q) == j.quantile(q), q
    assert (t.count, t.sum, t.mean) == (j.count, j.sum, j.mean)
    empty = tmetrics.MetricsRegistry().histogram("e", buckets=BOUNDS)
    assert empty.quantile(0.5) == 0.0
    with pytest.raises(ValueError):
        t.quantile(1.5)


def test_exp_buckets_match_reference():
    assert tmetrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS
    assert tmetrics.COUNT_BUCKETS == jmetrics.COUNT_BUCKETS
    assert (tmetrics.exp_buckets(0.003, 1.7, 9)
            == jmetrics.exp_buckets(0.003, 1.7, 9))
    for bad in ((0, 2, 3), (1, 1.0, 3), (1, 2, 0)):
        for mod in (tmetrics, jmetrics):
            with pytest.raises(ValueError):
                mod.exp_buckets(*bad)


def test_gauge_set_fn_and_disabled_registry():
    reg = tmetrics.MetricsRegistry()
    g = reg.gauge("depth", "d", ("replica",)).labels(replica="r0")
    g.set(3)
    g.inc(2)
    g.dec()
    assert g.value == 4.0
    box = [7]
    g.set_fn(lambda: box[0])
    box[0] = 9
    assert g.value == 9.0
    g.set_fn(lambda: 1 / 0)                  # a dead callback reads 0
    assert g.value == 0.0
    g.set(2)                                 # set drops the callback
    assert g.value == 2.0
    reg.reset()                              # plain gauges zero
    assert g.value == 0.0
    off = tmetrics.MetricsRegistry(enabled=False)
    fams = (off.counter("c_total"), off.gauge("g"), off.histogram("h"))
    for fam in fams:
        assert fam is tmetrics._NULL_FAMILY
        fam.labels(replica="r0").inc()
        fam.set(1)
        fam.observe(1.0)
        assert fam.value == 0.0 and fam.total() == 0.0
        assert fam.hist_count() == 0 and fam.hist_sum() == 0.0
    assert off.render() == "" and off.families() == []
    assert not Obs.disabled().enabled


def _drive(mod):
    """One fixed sequence of registry operations."""
    reg = mod.MetricsRegistry()
    c = reg.counter("serve_tokens_total", "Tokens", ("replica",))
    c.labels(replica="r1").inc(3)
    c.labels(replica="r0").inc(2.5)
    reg.counter("plain_total").inc()
    reg.counter("nohelp_total", labels=("a", "b")).labels(b=2, a="x").inc(7)
    g = reg.gauge("serve_free_pages", "Free pages", ("replica",))
    g.labels(replica="r0").set(12)
    g.labels(replica="r1").set_fn(lambda: 1e20)
    g.labels(replica="r2").set(-0.125)
    h = reg.histogram("serve_ttft_seconds", "TTFT", ("replica",))
    for v in (1e-4, 0.00012, 0.0031, 0.5, 3.0, 1e3):
        h.labels(replica="r0").observe(v)
    reg.histogram("burst", buckets=jmetrics.COUNT_BUCKETS).observe(5)
    return reg


def test_exposition_bytes_equal_reference():
    t, j = _drive(tmetrics), _drive(jmetrics)
    assert t.render() == j.render()
    assert "le=\"+Inf\"" in t.render()
    assert t.collect() == j.collect()
    assert [f.name for f in t.families()] == [f.name for f in j.families()]
    assert (t.get("serve_tokens_total").total()
            == j.get("serve_tokens_total").total() == 5.5)
    tf, jf = t.get("serve_ttft_seconds"), j.get("serve_ttft_seconds")
    assert tf.quantile(0.5) == jf.quantile(0.5)
    assert (tf.hist_count(), tf.hist_sum()) == (jf.hist_count(),
                                                jf.hist_sum())
    t.reset()
    j.reset()
    assert t.render() == j.render()


def test_merge_histograms_matches_reference():
    out = []
    for mod in (tmetrics, jmetrics):
        regs = [mod.MetricsRegistry() for _ in range(2)]
        for i, reg in enumerate(regs):
            h = reg.histogram("t_seconds", "t", ("replica",))
            for v in (0.001 * (i + 1), 0.02, 0.3 * (i + 1)):
                h.labels(replica=f"r{i}").observe(v)
        m = mod.merge_histograms([r.get("t_seconds") for r in regs])
        out.append((m.cumulative(), m.count, m.sum,
                    [m.quantile(q) for q in (0.1, 0.5, 0.9)]))
        assert mod.merge_histograms([]) is None
    assert out[0] == out[1]


# ----------------------------------------------------------------------
# the tracer
# ----------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _trace_ops(mod, monkeypatch, path):
    monkeypatch.setattr(mod.time, "monotonic", _Clock())
    tr = mod.Tracer()
    tr.complete("decode_burst", tr.now(), tr.now(), track="r0",
                args={"k": 8})
    with tr.span("static_bucket", track="r1", args={"batch": 2}):
        pass
    tr.instant("first_token", track="r0", args={"uid": 3})
    tr.instant("cow_copy", track="r1")
    tr.async_begin("request", 3, track="r0", args={"prompt_len": 4})
    tr.async_end("request", 3, track="r0")
    evs = tr.events()
    n = tr.export(str(path))
    tr.clear()
    kept = tr.events()
    off = mod.Tracer(enabled=False)
    off.instant("x")
    off.async_begin("request", 1)
    return evs, n, kept, off.events(), path.read_text()


def test_tracer_events_match_reference(monkeypatch, tmp_path):
    t = _trace_ops(ttrace, monkeypatch, tmp_path / "t.json")
    j = _trace_ops(jtrace, monkeypatch, tmp_path / "j.json")
    assert t == j
    evs = t[0]
    assert [e["ph"] for e in evs] == ["M", "X", "M", "X", "i", "i", "b",
                                      "e"]
    assert t[2] == [e for e in evs if e["ph"] == "M"] and t[3] == []


# ----------------------------------------------------------------------
# the serve stack's series and spans against the JAX engine
# ----------------------------------------------------------------------
def _shape(events):
    """Event order, tracks and arguments, without the clock."""
    return [(e["name"], e["ph"], e.get("id"), e.get("args"), e["tid"])
            for e in events]


def test_request_and_preemption_spans_match_jax_engine(pair, jax_run):
    """The same lifecycle: request begin / end, queue waits, prefix
    attaches, swap preemptions, swap out / in, first tokens and every burst's (k, steps, decoding, chunk)
    — in the JAX engine's order, with its arguments."""
    jeng, jres = jax_run
    eng = _port(pair, trace=True)
    res = _gen(eng)
    assert _streams(res) == _streams(jres)
    got, want = eng.obs.tracer.events(), jeng.obs.tracer.events()
    names = {e["name"] for e in got}
    assert {"request", "queue_wait", "first_token", "prefix_attach",
            "preempt_swap", "swap_out", "swap_in",
            "swap_resume", "prefill_burst", "decode_burst"} <= names
    assert _shape(got) == _shape(want)
    begins = eng.obs.tracer.events("request", ph="b")
    ends = eng.obs.tracer.events("request", ph="e")
    assert len(begins) == len(ends) == len(res)
    for k in STAT_KEYS:
        if k in jeng.stats and not k.endswith("wall_s"):
            assert eng.stats[k] == jeng.stats[k], k
    reg, jreg = eng.obs.metrics, jeng.obs.metrics
    assert ([f.name for f in reg.families()]
            == [f.name for f in jreg.families()])
    for name in ("serve_ttft_seconds", "serve_tpot_seconds",
                 "serve_queue_wait_seconds", "serve_burst_steps"):
        assert reg.get(name).hist_count() == jreg.get(name).hist_count()
    assert (reg.get("serve_burst_steps").hist_sum()
            == jreg.get("serve_burst_steps").hist_sum())


def test_tracing_on_gives_the_streams_of_tracing_off(pair, jax_run):
    on = _port(pair, trace=True)
    off = _port(pair, metrics=False)
    assert _streams(_gen(on)) == _streams(_gen(off)) == _streams(
        jax_run[1])
    assert on.obs.tracer.events("request", ph="b")
    assert off.obs.tracer.events() == []
    assert set(off.stats.values()) == {0}      # every site a no-op
    assert off.obs.metrics.render() == ""


def test_stats_view_is_rebased_per_run(pair, jax_run):
    eng = _port(pair)
    _gen(eng)
    first = dict(eng.stats)
    _gen(eng)
    second = eng.stats
    for k in STAT_KEYS:
        if not k.endswith("wall_s"):
            assert second[k] == first[k], k
    assert first["tokens"] > 0 and first["preemptions"] > 0
    assert first["decode_wall_s"] > 0.0
    snap = eng.m.snapshot()                   # the registry: both runs
    assert snap["tokens"] == 2 * first["tokens"]
    assert snap["host_syncs"] == 2 * first["host_syncs"]
    # the pool's own view re-bases at every reset (each session's start)
    assert eng.pool.stats["cow_copies"] == first["cow_copies"]
    jstats = jax_run[0].stats
    for k in ("tokens", "host_syncs", "device_steps", "prefill_chunks",
              "prefix_hit_tokens", "preempt_swap", "preempt_recompute",
              "cow_copies", "swap_out_pages", "swap_in_pages",
              "sparse_dispatch"):
        assert first[k] == jstats[k], k


def test_static_bucket_span_and_counters_match_jax(pair):
    jm, jp, tm, tp = pair
    reqs = [(u, np.arange(5 + u % 2, dtype=np.int32) * 7 % 256, 6)
            for u in range(5)]
    jeng = JServeEngine(jm, jp, mode="static", max_batch=2, max_len=32,
                        obs=JObs.create(trace=True))
    jres = jeng.generate([JRequest(uid=u, prompt=p, max_new_tokens=m)
                          for u, p, m in reqs])
    eng = ServeEngine(tm, tp, mode="static", max_batch=2, max_len=32,
                      trace=True)
    res = eng.generate([Request(uid=u, prompt=p, max_new_tokens=m)
                        for u, p, m in reqs])
    assert _streams(res) == _streams(jres)
    spans = [e["args"] for e in eng.obs.tracer.events("static_bucket")]
    assert spans == [e["args"] for e in
                     jeng.obs.tracer.events("static_bucket")]
    assert len(spans) == 3
    for k in ("requests", "tokens", "host_syncs", "device_steps",
              "slot_steps"):
        assert eng.stats[k] == getattr(jeng.m, k).value > 0, k


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
