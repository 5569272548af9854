"""The port's serve stack and pruning pass on the xLSTM, on the CPU against
the JAX package: greedy streams of xlstm-350m's smoke config in static
and continuous mode (multi-chunk prompts; the reference's
tests/test_serve_paged.py setup), each equal to the JAX engine's static
streams; recompute preemption — forced on the pure xLSTM, which has no
pages to starve, and from a starved pool on an xLSTM/attention hybrid
(against its static streams) — reproducing them; the state rows' reset
to the reference's init rows (``m`` at -1e30); 2:4 packing with the xLSTM's linears; MS and MM 2:4
through the port's serial and pipelined engines against the reference's
serial one; and the three CLIs on ``--arch xlstm-350m --smoke``.

Tolerances: streams are compared token for token (the head is sharpened
×8, as the reference's serve tests do, so that CPU BLAS reduction order
cannot flip an argmax); the engines as tests/test_torch_prune_e2e.py
holds them — layer 0 (identical inputs) equal masks, ≥ 98 % of every
mask equal, reconstruction errors within 1e-2 and perplexity within
1e-3 relative.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten
from repro.configs import get_smoke as j_get_smoke
from repro.configs.paper_tiny_lm import MAMBA as J_MAMBA
from repro.core.engine import PruningEngine as JEngine
from repro.data import DataPipeline as JPipe
from repro.data import calibration_batches
from repro.models import LM as JLM
from repro.models.base import ArchConfig as JArchConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.kvpool import StatePool as JStatePool
from repro_torch import random as rnd
from repro_torch.core.engine import PruningEngine
from repro_torch.core.masks import validate_nm
from repro_torch.core.pruner import prune_linears
from repro_torch.data import synthetic
from repro_torch.data.synthetic import zipf_logits
from repro_torch.launch import prune as launch_prune
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import LM
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvpool import PagedKVPool, StatePool
from repro_torch.serve.sparse import (compressed_param_tree, count_packed,
                                      linear_patterns)

SMOKE = dataclasses.asdict(j_get_smoke("xlstm_350m"))
# attention between the xLSTM blocks: KV pages, so a small pool starves
HYBRID = dict(SMOKE, name="xlstm-attn-test", num_layers=4,
              period=("mlstm", "attn", "slstm", "attn"))
ARCHS = {"xlstm": SMOKE, "hybrid": HYBRID}
ENGINE = dict(max_batch=4, max_len=48)
PAGED = dict(mode="continuous", page_size=8, prefill_chunk=8)
CASES = [("xlstm", "static", {}), ("xlstm", "continuous", {}),
         ("hybrid", "starved", {"num_pages": 6})]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for the module's fixtures and tests alike (the
    suite runs several workers on one machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _requests(cls, vocab, n=8):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=(4, 7, 12)[i % 3],
                                           dtype=np.int32),
                max_new_tokens=(2, 5, 9, 14)[i % 4]) for i in range(n)]


def _keyed(fields):
    """The port's model and its threefry init (the reference's keyed init
    up to the last ulp: tests/test_torch_xlstm.py), and the JAX model with
    the same leaves — the port's carried across, which saves the
    reference's init a compile."""
    tm = LM(ArchConfig(**fields), device="cpu")
    tp = tm.init(rnd.key(0))
    return tm, tp, JLM(JArchConfig(**fields))


def _to_jax(tm, tp):
    """Port params → the reference's stacked tree (f32 leaves)."""
    tree = {}
    for path, arr in tm.params_to_flat(tp).items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(arr)
    return tree


@pytest.fixture(scope="module")
def served():
    """Per arch: the port's model and its keyed init with the (tied)
    embedding sharpened; the streams to hold them to — the JAX engine's
    static ones for the xLSTM, on the same leaves, the port's static ones
    for the hybrid (its blocks are the xLSTM's and the attention's, each
    held to the reference on its own)."""
    out = {}
    for arch, fields in ARCHS.items():
        tm, tp, jm = _keyed(fields)
        tp["embed"]["tok"] = tp["embed"]["tok"] * 8.0
        if arch == "xlstm":
            res = JServeEngine(jm, _to_jax(tm, tp), mode="static",
                               **ENGINE).generate(
                _requests(JRequest, jm.cfg.vocab_size))
        else:
            res = ServeEngine(tm, tp, mode="static", **ENGINE).generate(
                _requests(Request, tm.cfg.vocab_size))
        out[arch] = (tm, tp, [np.asarray(r.tokens) for r in res])
    return out


@pytest.mark.parametrize("arch,mode,extra", CASES,
                         ids=[f"{a}-{m}" for a, m, _ in CASES])
def test_streams_match_jax_engine(served, arch, mode, extra):
    tm, tp, streams = served[arch]
    kw = dict(mode="static") if mode == "static" else dict(PAGED, **extra)
    eng = ServeEngine(tm, tp, **ENGINE, **kw)
    assert eng.mode == kw["mode"]                   # no fallback
    res = eng.generate(_requests(Request, tm.cfg.vocab_size))
    for got, want in zip(res, streams):
        np.testing.assert_array_equal(got.tokens, want)
    if mode == "static":
        return
    # recurrent state: recompute preemption only, and no prefix index
    assert eng.state_pool is not None and not eng._swap_ok
    assert eng.pool.prefix is None and eng.stats["preempt_swap"] == 0
    assert eng.pool.has_kv_pages == (arch == "hybrid")
    if mode == "starved":
        assert eng.stats["preempt_recompute"] > 0
    eng.pool.check_invariants()


def test_forced_recompute_preemption_reproduces_static(served):
    """The pure xLSTM has no pages, so no pool starves it: preempt a
    decoding request every third step instead (the scheduler's own
    recompute path).  Its slot is re-admitted through the state rows'
    reset, and every stream equals the JAX engine's static one."""
    tm, tp, streams = served["xlstm"]
    eng = ServeEngine(tm, tp, **ENGINE, **PAGED)
    session = eng.session()
    reqs = _requests(Request, tm.cfg.vocab_size)
    for r in reqs:
        session.submit(r)
    got, steps, forced = {}, 0, 0
    while session.has_work():
        for ev in session.step():
            if ev.finished:
                got[ev.uid] = ev.result.tokens
        steps += 1
        live = [s for s in session.sched.running if len(s.tokens) > 1]
        if live and steps % 3 == 0 and forced < 4:
            session.sched.preempt(live[-1])
            forced += 1
    assert forced == 4 and eng.stats["preempt_recompute"] == 4
    for r, want in zip(reqs, streams):
        np.testing.assert_array_equal(got[r.uid], want)


@pytest.mark.parametrize("arch", ["mamba", "xlstm"])
def test_state_pool_resets_slot_rows_to_the_reference_init(arch):
    """Dirty every state row, reset slot 1: its rows equal the reference's
    ``StatePool.reset_slot`` rows — zeros for Mamba, and for the xLSTM
    zeros with the stabiliser ``m`` at -1e30 — in place, the other slots
    untouched."""
    cfg = (J_MAMBA if arch == "mamba" else JArchConfig(**SMOKE))
    fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    tm = LM(ArchConfig(**fields), device="cpu")
    pool = PagedKVPool(tm, num_pages=2, page_size=8, max_slots=3, max_len=32)
    sp = StatePool(tm, pool.kv)
    assert sp.has_state and len(sp.entries) == tm.cfg.num_layers
    jm = JLM(cfg)
    jkv = jax.tree.map(lambda x: x + 7.0,
                       jm.init_paged_cache(2, 8, max_slots=3))
    jkv = JStatePool(jm, max_slots=3).reset_slot(jkv, 1)
    ptrs = []
    for layer in sp.entries:
        for t in layer.values():
            ptrs.append(t.data_ptr())
            t.fill_(7.0)
    sp.reset_slot(1)
    n = 0
    for i, layer in enumerate(sp.entries):
        want = jkv["layers"][f"s{i % len(cfg.period)}"]
        for key, t in layer.items():
            assert t.data_ptr() == ptrs[n]               # the same tensors
            n += 1
            np.testing.assert_array_equal(
                t[1].numpy(), np.asarray(want[key][i // len(cfg.period), 1]))
            assert bool((t[[0, 2]] == 7).all())
    if arch == "xlstm":
        for i in (0, 3):                             # an mLSTM, the sLSTM
            assert bool((sp.entries[i]["m"][1] == np.float32(-1e30)).all())


def test_packing_with_the_xlstm_linears():
    """Magnitude 2:4 on ``LM.block_linears()`` and packing with their
    patterns: the 33 linears of the smoke period packed, the f32 mLSTM
    gates ``wi`` / ``wf`` dense, the default patterns packing nothing; the
    packed model's streams equal the dense pruned model's."""
    tm = LM(ArchConfig(**SMOKE), device="cpu")
    gen = torch.Generator().manual_seed(0)
    pairs = tm.block_linears()
    assert ("mlstm", "wi") not in pairs and ("slstm", "wi") in pairs
    params = prune_linears(tm.init(gen), "2:4", linears=pairs)
    params["embed"]["tok"] = params["embed"]["tok"] * 8.0
    assert count_packed(compressed_param_tree(params)) == 0
    packed = compressed_param_tree(params, linear_patterns(pairs))
    assert count_packed(packed) == 7 * 4 + 5
    for key in ("wi", "wf"):
        w = packed["layers"][0]["mlstm"][key]
        assert isinstance(w, torch.Tensor) and w.dtype == torch.float32
        assert bool((w != 0).all())
    reqs = _requests(Request, tm.cfg.vocab_size, n=4)
    dense = ServeEngine(tm, params, **ENGINE, **PAGED).generate(reqs)
    eng = ServeEngine(tm, packed, **ENGINE, **PAGED)
    assert eng.n_sparse_leaves == 33
    for got, want in zip(eng.generate(reqs), dense):
        np.testing.assert_array_equal(got.tokens, want.tokens)


# ----------------------------------------------------------------------
# pruning
# ----------------------------------------------------------------------
PRUNE = dict(SMOKE, name="xlstm-prune-test", num_layers=4,
             period=("mlstm", "slstm"))
LINEARS = (("mlstm", "wq"), ("mlstm", "wk"), ("mlstm", "wv"),
           ("mlstm", "wo"), ("slstm", "wz"), ("slstm", "wi"),
           ("slstm", "wf"), ("slstm", "wo_gate"), ("slstm", "wo"))


def _tb(b):
    return {k: torch.from_numpy(np.array(b[k])) for k in ("tokens", "labels")}


def _ppl(loss_fn, params, batches):
    tot = cnt = 0.0
    for b in batches:
        _, m = loss_fn(params, b)
        tot += float(m["ce"]) * float(m["tokens"])
        cnt += float(m["tokens"])
    return float(np.exp(tot / cnt))


@pytest.fixture(scope="module")
def pruned_ref():
    """The (mlstm, slstm) × 2 model's keyed init on both sides, the
    corpus's calibration and evaluation batches, and the reference's
    serial engine run per method (with its perplexity)."""
    tm, tp, jm = _keyed(PRUNE)
    jp = _to_jax(tm, tp)
    calib = calibration_batches(jm.cfg, n_samples=8, seq_len=32, batch=4)
    evals = [JPipe(jm.cfg, 8, 32, seed=0).eval_batch(i) for i in range(2)]
    loss = jax.jit(jm.loss_fn)
    runs = {}
    for method in ("MS", "MM"):
        jpr, jrep = JEngine(jm, "2:4", method=method, blocksize=32,
                            pipeline="off").run(jp, calib)
        runs[method] = (_flatten(jpr), jrep, _ppl(loss, jpr, evals))
    return tm, tp, calib, evals, runs


@pytest.mark.parametrize("pipeline", ["off", "auto"])
@pytest.mark.parametrize("method", ["MS", "MM"])
def test_engine_matches_reference(pruned_ref, method, pipeline):
    tm, tp, calib, evals, runs = pruned_ref
    jl, jrep, pj = runs[method]
    tpr, trep = PruningEngine(tm, "2:4", method=method, blocksize=32,
                              pipeline=pipeline).run(
        tp, [_tb(b) for b in calib])
    assert [r.name for r in trep] == [r.name for r in jrep]
    assert len(trep) == 2 * len(LINEARS)
    for tr, jr in zip(trep, jrep):
        assert tr.shape == jr.shape
        assert tr.sparsity == pytest.approx(jr.sparsity, abs=1e-6)
        assert tr.recon_error == pytest.approx(jr.recon_error, rel=1e-2,
                                               abs=1e-9)
    tl = tm.params_to_flat(tpr)
    for j, (sub, key) in ((0 if sub == "mlstm" else 1, (sub, key))
                          for sub, key in LINEARS):
        k = f"layers/s{j}/{sub}/{key}"
        a, b = np.asarray(jl[k]) == 0, tl[k] == 0
        assert (a[0] == b[0]).all(), f"{k} layer 0"
        assert (a == b).mean() >= 0.98, k
        assert validate_nm(torch.from_numpy(b[0].T.copy()), 2, 4), k
    for k in ("wi", "wf"):                            # the f32 gates
        np.testing.assert_array_equal(tl[f"layers/s0/mlstm/{k}"],
                                      np.asarray(jl[f"layers/s0/mlstm/{k}"]))
    pt = _ppl(tm.loss_fn, tpr, [_tb(b) for b in evals])
    assert np.isfinite(pt) and pt == pytest.approx(pj, rel=1e-3)


# ----------------------------------------------------------------------
# the trainer's corpus at a large vocabulary, and the CLIs
# ----------------------------------------------------------------------
def test_corpus_table_in_row_blocks_is_the_whole_draw(monkeypatch):
    """The transition table is built in place with its noise drawn in row
    blocks (xlstm-350m's 50,304² table would otherwise hold tens of GB of
    threefry temporaries): bit-equal to ``base + boost + noise`` drawn
    whole, repeated successors included, whatever the block."""
    vocab = 300
    k1, k2 = rnd.split(rnd.key(0)).unbind(0)
    succ = rnd.randint(k1, (vocab, 3), 0, vocab).long()
    assert (succ[:, :, None] == succ[:, None, :]).sum() > 3 * vocab
    boost = torch.zeros((vocab, vocab))
    boost.index_put_((torch.arange(vocab)[:, None].expand(-1, 3), succ),
                     torch.full((vocab, 3), 8.0), accumulate=True)
    want = (zipf_logits(vocab)[None, :] + boost
            + 0.5 * rnd.normal(k2, (vocab, vocab)))
    for block in (synthetic.NOISE_BLOCK, 7 * vocab + 11, 1):
        monkeypatch.setattr(synthetic, "NOISE_BLOCK", block)
        got = synthetic.MarkovCorpus(vocab, seed=0).trans_logits
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("cli", ["serve", "prune", "train"])
def test_cli_takes_xlstm(tmp_path, capsys, cli):
    common = ["--arch", "xlstm-350m", "--smoke", "--device", "cpu"]
    if cli == "serve":
        launch_serve.main(common + ["--requests", "3", "--max-new", "4",
                                    "--prefill-chunk", "4"])
        assert "12 tokens in" in capsys.readouterr().out
    elif cli == "prune":
        launch_prune.main(common + ["--method", "MS", "--sparsity", "2:4",
                                    "--calib-samples", "4", "--out",
                                    str(tmp_path / "p")])
        assert "pruned 33 linears, mean sparsity 0.500" in (
            capsys.readouterr().out)
        assert os.path.isdir(tmp_path / "p" / "pruned_params")
    else:
        info = launch_train.main(common + ["--steps", "2", "--batch", "2",
                                           "--seq", "16", "--out",
                                           str(tmp_path / "t")])
        assert info["steps"] == 2 and np.isfinite(info["last_loss"])
