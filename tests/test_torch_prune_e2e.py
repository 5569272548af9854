"""The port's pruning pass end to end on the JAX package's trained tiny LM:
``PruningEngine`` against the reference's ``PruningEngine(pipeline="off")``,
the launcher, and the checkpoint handed back to the reference.

Why masks are held per layer and not bit for bit across the whole model:
the two frameworks' forward passes round differently (the captures of
layer 0 already differ by ~1e-6 from the rmsnorm and matmul order), so
their Hessians differ at that level and a near tie in a score can flip.
Under MRP compensation a flip changes the rest of its row.  At a fixed
(w, H) the masks are equal (``test_torch_prune.py``); here

  * layer 0 (identical inputs) must give equal masks for every linear;
  * every layer fed the reference's own calibration hiddens must agree on
    ≥ 99.5 % of each linear's mask, and its rows whose masks agree must
    carry the same weights (1e-4 of the linear's scale);
  * the free-running engines must agree on ≥ 98 % of each mask, on each
    linear's reconstruction error within 1e-2 relative, and on the
    pruned perplexity within 1e-3 relative.
"""

import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointStore
from repro.ckpt.store import _flatten
from repro.ckpt.store import load_pytree as j_load_pytree
from repro.core.engine import PruningEngine as JEngine
from repro.data import calibration_batches
from repro_torch import configs
from repro_torch.ckpt import load_pytree
from repro_torch.core.engine import PruningEngine, summarize
from repro_torch.core.masks import validate_nm
from repro_torch.launch import prune as launch_prune
from repro_torch.models.transformer import LM

LINEAR_KEYS = ("wq", "wk", "wv", "wo", "wi", "wg")
CALIB_SAMPLES, SEQ, BLOCK = 16, 64, 64


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
    calib = calibration_batches(model.cfg, n_samples=CALIB_SAMPLES,
                                seq_len=SEQ)
    evals = [pipe.eval_batch(i) for i in range(4)]
    return model, params, tm, tm.params_from_jax(_flatten(params)), calib, \
        evals


def _ppl(loss_fn, params, batches):
    tot = cnt = 0.0
    for b in batches:
        _, m = loss_fn(params, b)
        tot += float(m["ce"]) * float(m["tokens"])
        cnt += float(m["tokens"])
    return float(np.exp(tot / cnt))


class _OneLayer:
    """A model of one of the port's segments whose calibration state is
    handed in directly (the reference's hiddens entering that layer)."""

    def __init__(self, seg):
        self.seg = seg

    def calib_init(self, params, h):
        return h

    def prunable_segments(self):
        return [self.seg]


def _linears(flat):
    return {k: np.asarray(v, np.float32) for k, v in flat.items()
            if k.endswith(LINEAR_KEYS)}


@pytest.mark.parametrize("method,spec", [("SM", "2:4"), ("MM", "2:4"),
                                         ("SM", "0.5")])
def test_engine_matches_reference_on_tiny_lm(setup, method, spec):
    model, params, tm, tp, calib, evals = setup
    jpr, jrep = JEngine(model, spec, method=method, blocksize=BLOCK,
                        pipeline="off").run(params, calib)

    # free-running: the port's engine on the port's own hiddens
    tpr, trep = PruningEngine(tm, spec, method=method, blocksize=BLOCK).run(
        tp, [_torch_batch(b) for b in calib])
    assert [r.name for r in trep] == [r.name for r in jrep]
    gaps = []
    for tr, jr in zip(trep, jrep):
        assert tr.shape == jr.shape and tr.sparsity == pytest.approx(
            jr.sparsity, abs=1e-6)
        assert tr.recon_error == pytest.approx(jr.recon_error, rel=1e-2)
        gaps.append(abs(tr.recon_error - jr.recon_error) / jr.recon_error)
    assert summarize(trep)["linears"] == 4 * 7
    jl, tl = _linears(_flatten(jpr)), _linears(tm.params_to_flat(tpr))
    agreements = []
    for k in jl:
        agree = (jl[k] == 0) == (tl[k] == 0)
        assert agree[0].all(), f"{k} layer 0"
        agreements.append(agree.mean(axis=(1, 2)).min())
        assert agreements[-1] >= 0.98, k
        if spec == "2:4":
            for i in range(tl[k].shape[0]):
                assert validate_nm(tl[k][i].T == 0, 2, 4)
    pj = _ppl(model.loss_fn, jpr, evals)
    pt = _ppl(tm.loss_fn, tpr, [_torch_batch(b) for b in evals])
    assert pt == pytest.approx(pj, rel=1e-3)
    # the readings beside the limits above (shown with ``pytest -s``)
    print(f"\n{method} {spec}: free-running mask agreement min "
          f"{min(agreements):.6f} (limit 0.98), recon-error gap max "
          f"{max(gaps):.3e} (limit 1e-2), ppl gap {abs(pt - pj) / pj:.3e} "
          "(limit 1e-3)")

    # teacher-forced: each port layer pruned on the reference's hiddens
    hs = [model.calib_init(params, b) for b in calib]
    tpf = tp
    for js, ts in zip(model.prunable_segments(), tm.prunable_segments()):
        tpf, _ = PruningEngine(_OneLayer(ts), spec, method=method,
                               blocksize=BLOCK).run(
            tpf, [torch.from_numpy(np.array(h)) for h in hs])
        hs = [js.apply(js.get_params(jpr), h, capture=False)[0] for h in hs]
    tl = _linears(tm.params_to_flat(tpf))
    for k in jl:
        for i in range(jl[k].shape[0]):
            a, b = jl[k][i], tl[k][i]                 # stored (in, out)
            agree = (a == 0) == (b == 0)
            assert agree.mean() >= 0.995, (k, i)
            rows = agree.all(axis=0)                  # paper rows = out cols
            assert np.abs(a[:, rows] - b[:, rows]).max() <= (
                1e-4 * np.abs(a).max()), (k, i)


# ----------------------------------------------------------------------
def test_launcher_writes_what_the_reference_and_the_server_read(
        setup, tmp_path, capsys):
    model, params, tm, tp, calib, evals = setup
    CheckpointStore(str(tmp_path / "store")).save(3, {"params": params})
    tokens = tmp_path / "tokens.npz"
    np.savez(tokens, calib=np.concatenate(
        [np.asarray(b["tokens"]) for b in calib]),
        eval=np.concatenate([np.asarray(b["tokens"]) for b in evals]))

    loaded = launch_prune.load_params(tm, str(tmp_path / "store"))
    torch.testing.assert_close(loaded["layers"][2]["mlp"]["wo"],
                               tp["layers"][2]["mlp"]["wo"], rtol=0, atol=0)
    cal, ev = launch_prune.load_tokens(str(tokens), 512, 0, 0, "cpu")
    assert len(cal) == CALIB_SAMPLES // 8 and len(ev) == len(evals)
    assert launch_prune.eval_ppl(tm, tp, ev) == pytest.approx(
        _ppl(model.loss_fn, params, evals), rel=1e-5)

    out = tmp_path / "out"
    launch_prune.main(["--arch", "paper_tiny_lm", "--ckpt",
                       str(tmp_path / "store"), "--tokens", str(tokens),
                       "--method", "MM", "--sparsity", "2:4",
                       "--out", str(out), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "dense ppl:" in text and "MM 2:4 ppl:" in text
    assert "pruned 28 linears, mean sparsity 0.500" in text

    # the reference reads what the port wrote; the forwards agree
    path = str(out / "pruned_params")
    jtree, extra = j_load_pytree(path, template=params)
    assert extra == {"method": "MM", "sparsity": "2:4"}
    flat, _ = load_pytree(path)
    tpruned = tm.params_from_jax(flat)
    toks = np.asarray(evals[0]["tokens"])[:4]
    jlogits, _ = model.forward(jtree, {"tokens": toks})
    tlogits = tm.forward(tpruned, torch.from_numpy(np.array(toks)))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    for k, v in _linears(flat).items():
        assert all(validate_nm(v[i].T == 0, 2, 4) for i in range(len(v))), k

    # and the port's server serves it packed
    from repro_torch.launch import serve

    serve.main(["--arch", "paper_tiny_lm", "--params", path, "--sparse",
                "--device", "cpu", "--requests", "2", "--max-new", "3"])
    assert "packed 28 2:4-sparse weights" in capsys.readouterr().out


def test_params_to_flat_inverts_params_from_jax_in_bf16():
    tm = LM(configs.get_smoke("qwen1_5_0_5b"), device="cpu")
    tm.dtype = torch.bfloat16
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tm.init(gen)
    flat = tm.params_to_flat(tp)
    assert flat["layers/s0/attn/wq"].shape == (2, 64, 64)
    assert flat["layers/s0/attn/wq"].dtype == np.dtype("V2")
    back = tm.params_from_jax(flat)
    for i in range(2):
        assert torch.equal(back["layers"][i]["mlp"]["wg"].view(torch.int16),
                           tp["layers"][i]["mlp"]["wg"].view(torch.int16))


def test_launch_prune_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_prune.main(["--smoke", "--out", str(tmp_path)])
