"""The port's pipelined pruning engine (``core.pipeline``) on CPU: against
the port's serial loop, against the reference's pipelined engine, resume
on segment boundaries, calibration shards, skip, the stage trace and
counters, and the launcher.

Bounds.  Pipelined against serial is the reference's own contract
(``tests/test_pipeline.py``): the stacked capture computes each Hessian
in one update instead of a streaming mean, so near ties may flip — at
least 99.9 % of mask entries agree, per-linear sparsity is equal, the
total reconstruction error within 5 % and the perplexity within 2 %.
Against the reference's pipelined engine the bounds are the per-layer
ones of ``tests/test_torch_prune_e2e.py`` (the two frameworks' forwards
round differently): layer 0 equal, every mask ≥ 98 % equal, each
reconstruction error within 1e-2 and the perplexity within 1e-3
relative.  A resumed run is bit-identical to an uninterrupted one.
"""

import json
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten
from repro.core import PruningEngine as JEngine
from repro.core.hessian import HessianAccumulator as JAcc
from repro.data import calibration_batches
from repro.obs import Obs as JObs
from repro_torch import configs
from repro_torch.ckpt import PruneProgressStore, load_pytree
from repro_torch.core.calibration import CalibrationSet
from repro_torch.core.engine import PruningEngine, summarize
from repro_torch.core.hessian import HessianAccumulator
from repro_torch.core.pipeline import SegmentScheduler, _resolve_shards
from repro_torch.launch import prune as launch_prune
from repro_torch.models.transformer import LM
from repro_torch.obs import Obs

BLOCK = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs several workers on the machine's
    cores, and torch's default pool of a thread a core in each of them
    oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(b[k])) for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def setup(tiny_lm):
    model, params, pipe = tiny_lm
    tm = LM(configs.get_config("paper_tiny_lm"), device="cpu")
    jcalib = calibration_batches(model.cfg, n_samples=16, seq_len=64)
    evals = [_torch_batch(pipe.eval_batch(i)) for i in range(4)]
    return (model, params, jcalib, tm, tm.params_from_jax(_flatten(params)),
            [_torch_batch(b) for b in jcalib], evals)


def _leaves(tm, params):
    return [np.asarray(v, np.float32)
            for v in tm.params_to_flat(params).values()]


def _mask_flips(a, b):
    total = flips = 0
    for x, y in zip(a, b):
        agree = (x == 0) == (y == 0)
        total += agree.size
        flips += int((~agree).sum())
    return flips / total


@pytest.mark.parametrize("method", ["SM", "MM"])
def test_pipelined_matches_serial(setup, method):
    model, params, jcalib, tm, tp, calib, evals = setup
    ref, ref_reports = PruningEngine(tm, "2:4", method=method,
                                     blocksize=BLOCK, pipeline="off").run(
        tp, calib)
    eng = PruningEngine(tm, "2:4", method=method, blocksize=BLOCK)
    got, reports = eng.run(tp, calib)

    assert _mask_flips(_leaves(tm, ref), _leaves(tm, got)) < 1e-3
    assert [r.name for r in reports] == [r.name for r in ref_reports]
    assert [r.sparsity for r in reports] == [r.sparsity for r in ref_reports]
    assert summarize(reports)["total_recon_error"] == pytest.approx(
        summarize(ref_reports)["total_recon_error"], rel=0.05)
    p_ref = launch_prune.eval_ppl(tm, ref, evals)
    p_got = launch_prune.eval_ppl(tm, got, evals)
    assert abs(p_got - p_ref) / p_ref < 0.02
    s = eng.last_pipeline_stats
    assert s.segments == tm.cfg.num_layers
    assert s.batches == len(calib) and s.calib_shards == 1
    assert not s.instrumented and s.wall_s > 0


@pytest.mark.parametrize("method", ["SM", "MM"])
def test_pipelined_matches_reference_pipelined(setup, method):
    model, params, jcalib, tm, tp, calib, evals = setup
    jpr, jrep = JEngine(model, "2:4", method=method,
                        blocksize=BLOCK).run(params, jcalib)
    tpr, trep = PruningEngine(tm, "2:4", method=method,
                              blocksize=BLOCK).run(tp, calib)
    assert [r.name for r in trep] == [r.name for r in jrep]
    for tr, jr in zip(trep, jrep):
        assert tr.sparsity == pytest.approx(jr.sparsity, abs=1e-6)
        assert tr.recon_error == pytest.approx(jr.recon_error, rel=1e-2)
    jl = {k: np.asarray(v, np.float32) for k, v in _flatten(jpr).items()}
    tl = {k: np.asarray(v, np.float32)
          for k, v in tm.params_to_flat(tpr).items()}
    for k in jl:
        if not k.endswith(("wq", "wk", "wv", "wo", "wi", "wg")):
            continue
        agree = (jl[k] == 0) == (tl[k] == 0)
        assert agree[0].all(), f"{k} layer 0"
        assert agree.mean(axis=(1, 2)).min() >= 0.98, k
    pj = np.exp(np.mean([float(model.loss_fn(jpr, {
        "tokens": jnp.asarray(b["tokens"].numpy()),
        "labels": jnp.asarray(b["labels"].numpy())})[1]["ce"])
        for b in evals]))
    pt = np.exp(np.mean([float(tm.loss_fn(tpr, b)[1]["ce"]) for b in evals]))
    assert pt == pytest.approx(pj, rel=1e-3)


@pytest.mark.parametrize("pipeline", ["auto", "off"])
def test_resume_on_segment_boundary(setup, tmp_path, pipeline):
    """Interrupted after segment 2: the surviving checkpoint equals the
    uninterrupted run's state at that boundary, and the resumed run's
    final params are bit-identical to the uninterrupted run's."""
    model, params, jcalib, tm, tp, calib, evals = setup

    class Recorder:
        def __init__(self):
            self.saves = []

        def load(self):
            return None

        def save(self, next_segment, flat):
            self.saves.append((next_segment, flat))

        def finalize(self):
            pass

    class Bomb(PruneProgressStore):
        def __init__(self, root, fuse):
            super().__init__(root)
            self.fuse = fuse

        def save(self, next_segment, flat):
            super().save(next_segment, flat)
            self.fuse -= 1
            if self.fuse == 0:
                raise RuntimeError("simulated node failure")

    kw = dict(method="SM", blocksize=BLOCK, pipeline=pipeline)
    rec = Recorder()
    ref, _ = PruningEngine(tm, "2:4", progress_store=rec, **kw).run(tp, calib)
    n_layers = tm.cfg.num_layers
    assert [s for s, _ in rec.saves] == list(range(1, n_layers + 1))

    out = str(tmp_path / "prog")
    with pytest.raises(RuntimeError):
        PruningEngine(tm, "2:4", progress_store=Bomb(out, fuse=2),
                      **kw).run(tp, calib)
    seg_idx, flat = PruneProgressStore(out).load()
    assert seg_idx == 2
    want = dict(rec.saves)[2]
    assert sorted(flat) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(flat[key], want[key])

    got, reports = PruningEngine(
        tm, "2:4", progress_store=PruneProgressStore(out), **kw).run(tp, calib)
    assert len(reports) == (n_layers - seg_idx) * 7
    for a, b in zip(_leaves(tm, ref), _leaves(tm, got)):
        np.testing.assert_array_equal(a, b)
    assert PruneProgressStore(out).load() is None          # finalized


def test_resolve_shards_and_calibration_shards(setup):
    model, params, jcalib, tm, tp, calib, evals = setup
    assert (_resolve_shards("auto", None, (), 8) == 1
            and _resolve_shards(1, None, (), 8) == 1)
    assert (_resolve_shards(3, None, (), 8) == 3
            and _resolve_shards(5, None, (), 2) == 2)
    # the reference's "on" / "off" / bools / None: one shard without a mesh
    for mode in ("on", "off", True, False, None):
        assert _resolve_shards(mode, None, (), 8) == 1
    with pytest.raises(ValueError):
        _resolve_shards("definitely", None, (), 8)
    for mode in ("sideways", True, False, None):
        with pytest.raises(ValueError):
            PruningEngine(tm, "2:4", pipeline=mode)

    sched = SegmentScheduler(calib_shard=2)
    states = sched.shard_states([torch.full((2, 3), float(i))
                                 for i in range(6)])
    assert len(states) == 2 and states[0].shape == (6, 3)
    assert states[0][:, 0].tolist() == [0, 0, 2, 2, 4, 4]
    assert sched.stats.calib_shards == 2 and sched.stats.batches == 6

    # calib_shard=2 accumulates two sets and merges them with merge_all
    seg = tm.prunable_segments()[0]
    seg_params = seg.get_params(tp)
    hs = [tm.calib_init(tp, b) for b in calib]
    merged = sched.capture(seg, seg_params, sched.shard_states(hs))
    one = SegmentScheduler().capture(
        seg, seg_params, SegmentScheduler().shard_states(hs))
    for name in one.names():
        assert merged.accs[name].count == one.accs[name].count
        torch.testing.assert_close(merged.hessian(name), one.hessian(name),
                                   rtol=1e-5, atol=1e-6)
    eng = PruningEngine(tm, "2:4", method="SM", blocksize=BLOCK,
                        calib_shard=2)
    got, _ = eng.run(tp, calib)
    assert eng.last_pipeline_stats.calib_shards == 2


def test_merge_many_matches_reference():
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((16, n)).astype(np.float32) for n in (8, 24, 5)]
    jaccs, taccs = [], []
    for x in xs:
        ja = JAcc(16)
        ja.update(jnp.asarray(x))
        jaccs.append(ja)
        ta = HessianAccumulator(16)
        ta.update(torch.from_numpy(x))
        taccs.append(ta)
    want = JAcc.merge_many(jaccs)
    got = HessianAccumulator.merge_many(taccs)
    assert got.count == float(want.count)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), rtol=1e-6,
                               atol=1e-6)
    sets = []
    for ta in taccs:
        cs = CalibrationSet()
        cs.accs["a"] = ta
        sets.append(cs)
    torch.testing.assert_close(CalibrationSet.merge_all(sets).hessian("a"),
                               got.h)
    pair = sets[0].merge(sets[1]).hessian("a")
    np.testing.assert_allclose(
        pair.numpy(), np.asarray(jaccs[0].merge(jaccs[1]).h), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("pipeline", ["auto", "off"])
def test_skip_leaves_matching_linears_dense(setup, pipeline):
    model, params, jcalib, tm, tp, calib, evals = setup
    skip = ("attn.wq", "period1.")
    got, reports = PruningEngine(tm, "2:4", method="SM", blocksize=BLOCK,
                                 skip=skip, pipeline=pipeline).run(tp, calib)
    names = [r.name for r in reports]
    assert len(names) == 7 * tm.cfg.num_layers - 7 - (tm.cfg.num_layers - 1)
    assert not any(p in n for n in names for p in skip)
    for i, layer in enumerate(got["layers"]):
        assert torch.equal(layer["attn"]["wq"], tp["layers"][i]["attn"]["wq"])
    assert torch.equal(got["layers"][1]["mlp"]["wo"],
                       tp["layers"][1]["mlp"]["wo"])
    assert not torch.equal(got["layers"][0]["mlp"]["wo"],
                           tp["layers"][0]["mlp"]["wo"])


def test_stage_trace_and_counters(setup, tmp_path):
    model, params, jcalib, tm, tp, calib, evals = setup
    obs = Obs.create(metrics=True, trace=True)
    eng = PruningEngine(tm, "2:4", method="SM", blocksize=BLOCK, obs=obs)
    eng.run(tp, calib)
    n = tm.cfg.num_layers
    for stage in ("capture", "solve", "propagate"):
        spans = obs.tracer.events(f"prune_{stage}", ph="X")
        assert len(spans) == n and all(e["dur"] >= 0 for e in spans)
        assert obs.metrics.counter(
            "prune_stage_seconds_total", labels=("stage",)).labels(
            stage=stage).value == pytest.approx(
            getattr(eng.last_pipeline_stats, f"{stage}_s"))
    stages = [key for key, _ in obs.metrics.get(
        "prune_stage_seconds_total").children()]
    assert stages == [("capture",), ("propagate",), ("solve",)]
    path = tmp_path / "trace.json"
    assert obs.tracer.export(str(path)) == len(obs.tracer.events())
    names = {e["name"] for e in json.load(open(path))["traceEvents"]}
    assert {"prune_capture", "prune_solve", "prune_propagate"} <= names

    quiet = Obs.disabled()
    PruningEngine(tm, "2:4", method="SM", blocksize=BLOCK, obs=quiet).run(
        tp, calib)
    assert not quiet.enabled and quiet.tracer.events() == []
    assert quiet.metrics.get("prune_stage_seconds_total") is None


def test_counter_registry_matches_the_reference():
    mine, ref = Obs.create(), JObs.create()
    for o in (mine, ref):
        c = o.metrics.counter("prune_stage_seconds_total", "stage seconds",
                              ("stage",))
        c.labels(stage="capture").inc(1.5)
        c.labels(stage="solve").inc(2)
        c.labels(stage="capture").inc(0.25)
        assert o.metrics.counter("prune_stage_seconds_total", "again",
                                 ("stage",)) is c
        with pytest.raises(ValueError):
            c.labels(stage="capture").inc(-1)
        with pytest.raises(ValueError):
            c.labels(phase="capture")
        with pytest.raises(ValueError):
            o.metrics.counter("prune_stage_seconds_total", "x", ("phase",))
    got = [(k, ch.value) for k, ch in mine.metrics.get(
        "prune_stage_seconds_total").children()]
    want = [(k, ch.value) for k, ch in ref.metrics.get(
        "prune_stage_seconds_total").children()]
    assert got == want == [(("capture",), 1.75), (("solve",), 2.0)]
    assert mine.metrics.get("absent") is None


def test_null_registry_and_tracer_record_nothing():
    quiet = Obs.disabled()
    fam = quiet.metrics.counter("prune_stage_seconds_total", "x", ("stage",))
    fam.labels(stage="capture").inc(3)
    fam.inc()
    assert fam.value == 0.0
    assert quiet.metrics.get("prune_stage_seconds_total") is None
    quiet.tracer.complete("prune_capture", 0.0, 1.0, track="prune")
    assert quiet.tracer.events() == [] and not quiet.enabled


def test_progress_store_refuses_another_runs_progress(tmp_path):
    flat = {"a": np.arange(4, dtype=np.float32)}
    fp = {"method": "MM", "calib_shape": (16, 64)}       # tuple: JSON list
    PruneProgressStore(str(tmp_path), fp).save(1, flat)
    seg, got = PruneProgressStore(str(tmp_path), dict(fp)).load()
    assert seg == 1 and np.array_equal(got["a"], flat["a"])
    for other in ({**fp, "method": "SM"}, None):
        with pytest.raises(ValueError, match="another run"):
            PruneProgressStore(str(tmp_path), other).load()
    assert PruneProgressStore(str(tmp_path), fp).load()[0] == 1   # kept


def test_launcher_pipeline_trace_and_resume(tmp_path, capsys, monkeypatch):
    base = ["--arch", "paper_tiny_lm", "--smoke", "--device", "cpu",
            "--method", "MM", "--sparsity", "2:4", "--calib-samples", "16"]
    trace = tmp_path / "trace.json"
    launch_prune.main(base + ["--pipeline", "on", "--trace-out", str(trace),
                              "--out", str(tmp_path / "a")])
    text = capsys.readouterr().out
    assert "pipeline: 2 segments, 2 batches in 1 calib shard(s)" in text
    assert "prune_stage_seconds_total: capture " in text
    assert f"wrote 7 trace events -> {trace}" in text   # 6 spans + 1 track
    names = [e["name"] for e in json.load(open(trace))["traceEvents"]]
    assert names.count("prune_solve") == 2
    assert not (tmp_path / "a" / "prune_progress").exists()
    assert signal.getsignal(signal.SIGTERM) is not None

    # an interrupted run leaves segment 1 in --out; the rerun resumes there
    class Bomb(PruneProgressStore):
        def save(self, next_segment, flat):
            super().save(next_segment, flat)
            raise RuntimeError("simulated node failure")

    out_b = ["--out", str(tmp_path / "b"), "--no-metrics"]
    with monkeypatch.context() as m:
        m.setattr(launch_prune, "PruneProgressStore", Bomb)
        with pytest.raises(RuntimeError, match="simulated node failure"):
            launch_prune.main(base + out_b)
    assert (tmp_path / "b" / "prune_progress").exists()
    # a run with other weights or settings refuses that progress
    for other in (["--seed", "1"], ["--method", "SM"], ["--pipeline", "off"]):
        with pytest.raises(ValueError, match="another run"):
            launch_prune.main(base + out_b + other)
    capsys.readouterr()
    launch_prune.main(base + out_b)
    text = capsys.readouterr().out
    assert "pipeline: 1 segments" in text
    assert "prune_stage_seconds_total" not in text
    a, _ = load_pytree(str(tmp_path / "a" / "pruned_params"))
    b, _ = load_pytree(str(tmp_path / "b" / "pruned_params"))
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_sigterm_becomes_keyboard_interrupt():
    previous = launch_prune.install_sigterm_handler()
    try:
        handler = signal.getsignal(signal.SIGTERM)
        with pytest.raises(KeyboardInterrupt):
            handler(signal.SIGTERM, None)
    finally:
        signal.signal(signal.SIGTERM, previous)
