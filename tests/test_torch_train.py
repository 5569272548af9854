"""The port's data, optimizer, checkpoints and trainer against the
reference, and the gradient guard of the kernel wrappers.

Tolerances and what they cover:

* ``MarkovCorpus``: the table's noise comes through the inverse error
  function (≤ NORMAL_ATOL) and the Zipf bias through ``log``; a flipped
  draw runs on along its sequence, so the bar counts sequences touched:
  at most CORPUS_MAX_TOUCHED of them (measured: 0 of 240).
* AdamW from fixed grads: one step, f32 math in both; the global norm
  sums in another order, and the first step is ≈ lr·sign(g), so an entry
  whose gradient is ≈ 0 can move by an lr-sized amount on an ulp of
  difference.  Held by norm (ADAM_REL) and by the count of entries
  outside a tight bound (ADAM_ENTRY_ABS), not by one elementwise max;
  bf16 moments round an ulp's difference to a whole bf16 step at a
  rounding boundary, so they are held to one bf16 ulp on at most
  BF16_MOMENT_FLIPS of their entries (params as above).
* Five Trainer steps from the reference's init and the reference's
  batches: losses within LOSS_ABS, each leaf within TRAIN_REL by norm,
  with at most TRAIN_OUTLIERS entries past TRAIN_ENTRY_ABS (measured:
  losses 3e-6 apart, leaves ≤ 5.4e-6 by norm, no entry past 1e-5).
* Resume: bit-identical in the port.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import CheckpointStore as JStore
from repro.ckpt.store import _flatten
from repro.configs import get_smoke as j_get_smoke
from repro.data import DataPipeline as JPipe
from repro.data.synthetic import MarkovCorpus as JCorpus
from repro.models import LM as JLM
from repro.models import layers as j_layers
from repro.optim import AdamW as JAdamW
from repro.optim.schedules import warmup_cosine as j_cosine
from repro.optim.schedules import warmup_linear as j_linear
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch import configs
from repro_torch.ckpt import CheckpointStore
from repro_torch.data import DataPipeline, MarkovCorpus, calibration_batches
from repro_torch.kernels.ops import KERNELS
from repro_torch.launch import prune as launch_prune
from repro_torch.launch import train as launch_train
from repro_torch.models import layers
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW, tree_leaves
from repro_torch.optim.schedules import warmup_cosine, warmup_linear
from repro_torch.train import TrainConfig, Trainer, make_train_step

NORMAL_ATOL = 2e-6
CORPUS_MAX_TOUCHED = 2
ADAM_REL = 3e-5
ADAM_ENTRY_ABS = 1e-6
ADAM_OUTLIERS = 0.001
BF16_MOMENT_FLIPS = 0.01
LOSS_ABS = 1e-4
TRAIN_REL = 5e-5
TRAIN_ENTRY_ABS = 1e-5
TRAIN_OUTLIERS = 0.001
STEPS = 5


@pytest.fixture(autouse=True)
def partitionable():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.threefry_partitionable(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _f32(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _close_by_norm(got, want, rel, entry_abs, outliers, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rel, (what, err)
    far = int(np.sum(np.abs(got - want) > entry_abs))
    assert far <= outliers * got.size, (what, far)


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------
def test_corpus_tokens_match_reference():
    jc, tc = JCorpus(512, seed=0), MarkovCorpus(512, seed=0)
    np.testing.assert_allclose(tc.trans_logits.numpy(),
                               np.asarray(jc.trans_logits), rtol=0,
                               atol=4 * NORMAL_ATOL)
    touched = seqs = 0
    for stream in (0, 1, 2):
        for step in range(5):
            want = np.asarray(jc.batch_at(stream, step, 16, 64))
            got = tc.batch_at(stream, step, 16, 64).numpy()
            assert got.dtype == np.int32 and got.shape == (16, 64)
            touched += int(np.any(got != want, axis=1).sum())
            seqs += 16
    assert touched <= CORPUS_MAX_TOUCHED, f"{touched}/{seqs}"


def test_pipeline_streams_and_calibration_match_reference():
    cfg = j_get_smoke("paper_tiny_lm")
    jp, tp = JPipe(cfg, 8, 32, seed=3), DataPipeline(
        configs.get_smoke("paper_tiny_lm"), 8, 32, seed=3)
    for j, t in ((jp.batch_at(4), tp.batch_at(4)),
                 (jp.eval_batch(1), tp.eval_batch(1)),
                 (jp.calib_batch(2), tp.calib_batch(2))):
        np.testing.assert_array_equal(t["tokens"].numpy(),
                                      np.asarray(j["tokens"]))
        assert t["labels"] is t["tokens"]
    calib = calibration_batches(configs.get_smoke("paper_tiny_lm"),
                                n_samples=20, seq_len=16)
    assert len(calib) == 2 and calib[0]["tokens"].shape == (8, 16)
    # under a mesh a rank keeps its rows of the same global batch
    pipe = DataPipeline(configs.get_smoke("paper_tiny_lm"), 8, 32, seed=3,
                        mesh=_FakeMesh((2, 1), (1, 0)))
    np.testing.assert_array_equal(pipe.batch_at(4)["tokens"].numpy(),
                                  np.asarray(jp.batch_at(4)["tokens"])[4:])
    np.testing.assert_array_equal(pipe.eval_batch(1)["tokens"].numpy(),
                                  np.asarray(jp.eval_batch(1)["tokens"]))


class _FakeMesh:
    """The DeviceMesh surface the batch rules read: a rank's coordinate
    on a ("data", "model") mesh of ``shape``."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coord):
        self.shape, self._coord = tuple(shape), list(coord)

    def get_coordinate(self):
        return self._coord


# ----------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------
def test_schedules_match_reference():
    """The f32 schedule arithmetic; ``cos`` may round an ulp apart."""
    steps = jnp.arange(0, 40, dtype=jnp.int32)
    for jf, tf in ((j_cosine(1e-3, 4, 30), warmup_cosine(1e-3, 4, 30)),
                   (j_cosine(3e-4, 0, 10, 1e-5), warmup_cosine(3e-4, 0, 10,
                                                                1e-5)),
                   (j_linear(1e-3, 4, 30), warmup_linear(1e-3, 4, 30))):
        want = np.asarray(jf(steps))
        got = tf(torch.arange(0, 40, dtype=torch.int32)).numpy()
        np.testing.assert_allclose(got, want, rtol=4e-7, atol=0)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_step_matches_reference(moments):
    """One update from fixed grads over the tiny LM's params: global-norm
    clip (the grads are scaled to clip), decay on the reference's
    matrices (stacked layers make every layer leaf one rank higher, so
    the norm scales decay there), bf16 or f32 moments; then a second
    step from the first's state."""
    jm = JLM(j_get_smoke("paper_tiny_lm"))
    jparams = jm.init(jax.random.key(0))
    tm = LM(configs.get_smoke("paper_tiny_lm"), device="cpu")
    tparams = tm.params_from_jax(_flatten(jparams))
    rng = np.random.default_rng(0)
    jgrads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32) * 0.3), jparams)
    tgrads = tm.params_from_jax(_flatten(jgrads))
    jopt = JAdamW(lr=j_cosine(1e-2, 1, 10), moment_dtype=moments)
    topt = AdamW(lr=warmup_cosine(1e-2, 1, 10), moment_dtype=moments)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for _ in range(2):
        jparams, jstate, jstats = jopt.update(jgrads, jstate, jparams)
        tparams, tstate, tstats = topt.update(tgrads, tstate, tparams)
        assert float(jstats["grad_norm"]) > 1.0          # clip engaged
        np.testing.assert_allclose(float(tstats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 2
    for name, jt, tt in (("params", jparams, tparams),
                         ("mu", jstate.mu, tstate.mu),
                         ("nu", jstate.nu, tstate.nu)):
        want, got = _flatten(jt), tm.params_to_flat(tt)
        for path in want:
            if name != "params" and moments == "bfloat16":
                # a moment an ulp apart in f32 may round to the next bf16
                w, g = _f32(want[path]), _f32(got[path])
                d = np.abs(g - w)
                assert np.all(d <= np.abs(w) * 2 ** -7), (name, path)
                assert np.mean(d > 0) <= BF16_MOMENT_FLIPS, (name, path)
                continue
            _close_by_norm(got[path], want[path], ADAM_REL, ADAM_ENTRY_ABS
                           * max(1.0, np.abs(_f32(want[path])).max()),
                           ADAM_OUTLIERS, f"{name}/{path}")
    assert tstate.mu["embed"]["tok"].dtype == (
        torch.bfloat16 if moments == "bfloat16" else torch.float32)


# ----------------------------------------------------------------------
# trainer
# ----------------------------------------------------------------------
def _trainers(tmp_path, steps=STEPS):
    jcfg = j_get_smoke("paper_tiny_lm")
    tcfg = configs.get_smoke("paper_tiny_lm")
    jt = JTrainer(JLM(jcfg), JAdamW(lr=j_cosine(1e-3, 2, steps),
                                    moment_dtype="bfloat16"),
                  JPipe(jcfg, 8, 32, seed=0),
                  JTrainConfig(total_steps=steps, global_batch=8, seq_len=32,
                               ckpt_every=steps, out_dir=str(tmp_path / "j"),
                               log_every=1))
    tt = Trainer(LM(tcfg, device="cpu"),
                 AdamW(lr=warmup_cosine(1e-3, 2, steps),
                       moment_dtype="bfloat16"),
                 DataPipeline(tcfg, 8, 32, seed=0),
                 TrainConfig(total_steps=steps, global_batch=8, seq_len=32,
                             ckpt_every=steps, out_dir=str(tmp_path / "t"),
                             log_every=1))
    return jt, tt


def _losses(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def test_trainer_steps_match_reference_and_checkpoints_cross_read(tmp_path):
    """Five steps from the keyed init on the corpus: the port's own init
    and batches, held against the reference's run (both within the
    tolerances above), then each package restores the other's
    checkpoint."""
    jt, tt = _trainers(tmp_path)
    jparams, jopt, _ = jt.run()
    tparams, topt, info = tt.run()
    assert info["steps"] == STEPS and info["skipped_steps"] == 0
    np.testing.assert_allclose(_losses(tmp_path / "t"),
                               _losses(tmp_path / "j"), rtol=0,
                               atol=LOSS_ABS)
    want = _flatten(jparams)
    got = tt.model.params_to_flat(tparams)
    for path in want:
        _close_by_norm(got[path], want[path], TRAIN_REL, TRAIN_ENTRY_ABS,
                       TRAIN_OUTLIERS, path)

    # the reference restores the port's checkpoint ...
    tmpl = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        jt._state_template())
    step, tree, extra = JStore(str(tmp_path / "t")).restore(tmpl)
    assert step == STEPS and extra["step"] == STEPS
    assert int(tree["opt"][0]) == STEPS
    np.testing.assert_array_equal(
        _f32(tree["params"]["layers"]["s0"]["mlp"]["wo"]),
        _f32(got["layers/s0/mlp/wo"]))
    # ... and the port the reference's
    step, (params, opt, ef), _ = CheckpointStore(str(tmp_path / "j")).restore(
        convert=tt.from_flat)
    assert step == STEPS and int(opt.step) == STEPS
    assert opt.mu["embed"]["tok"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tt.model.params_to_flat(params)["embed/tok"], np.asarray(
            want["embed/tok"]))


def test_resume_is_bit_identical(tmp_path):
    """Stopped after 3 of 6 steps and resumed: the same params, moments
    and losses as the uninterrupted run."""
    cfg = configs.get_smoke("paper_tiny_lm")

    def trainer(out):
        return Trainer(LM(cfg, device="cpu"),
                       AdamW(lr=warmup_cosine(1e-3, 1, 6)),
                       DataPipeline(cfg, 4, 16, seed=1),
                       TrainConfig(total_steps=6, global_batch=4, seq_len=16,
                                   ckpt_every=2, out_dir=str(out),
                                   log_every=1))

    p_full, o_full, _ = trainer(tmp_path / "a").run()
    trainer(tmp_path / "b").run(max_steps=3)
    assert CheckpointStore(str(tmp_path / "b")).latest_step() == 3
    p_res, o_res, info = trainer(tmp_path / "b").run()
    assert info["steps"] == 3
    for a, b in zip(tree_leaves((p_full, o_full.mu, o_full.nu)),
                    tree_leaves((p_res, o_res.mu, o_res.nu))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _losses(tmp_path / "a")[3:] == _losses(tmp_path / "b")[3:]


def test_restore_walks_past_a_torn_checkpoint(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        store.save(step, {"x": np.full(3, step, np.float32)})
    assert store.list_steps() == [2, 3]
    with open(tmp_path / "step_00000003" / "arrays.npz", "ab") as f:
        f.write(b"torn")
    step, flat, extra = store.restore()
    assert step == 2 and extra["step"] == 2 and flat["x"][0] == 2
    os.makedirs(tmp_path / "step_00000009.tmp-1")          # a temporary
    assert store.list_steps() == [2, 3]


def test_nan_guard_skips_the_update_and_counts_it():
    cfg = configs.get_smoke("paper_tiny_lm")
    model = LM(cfg, device="cpu")
    opt = AdamW(lr=1e-3)
    params = model.init(torch.Generator().manual_seed(0))
    state = opt.init(params)
    batch = DataPipeline(cfg, 2, 8).batch_at(0)
    step = make_train_step(model, opt)
    bad = {**params, "embed": {"tok": params["embed"]["tok"] * float("nan")}}
    new, new_state, _, metrics = step(bad, state, torch.zeros(()), batch)
    assert float(metrics["skipped"]) == 1.0
    assert int(new_state.step) == 0
    assert torch.isnan(new["embed"]["tok"]).all()           # untouched
    torch.testing.assert_close(new["unembed"]["head"],
                               params["unembed"]["head"], rtol=0, atol=0)
    new, new_state, _, metrics = step(params, state, torch.zeros(()), batch)
    assert float(metrics["skipped"]) == 0.0 and int(new_state.step) == 1


def test_microbatches_average_the_gradients():
    cfg = configs.get_smoke("paper_tiny_lm")
    model = LM(cfg, device="cpu")
    opt = AdamW(lr=1e-3, clip_norm=None)
    params = model.init(torch.Generator().manual_seed(0))
    batch = DataPipeline(cfg, 4, 8).batch_at(0)
    one = make_train_step(model, opt)(params, opt.init(params), None, batch)
    two = make_train_step(model, opt, microbatches=2)(
        params, opt.init(params), None, batch)
    np.testing.assert_allclose(float(two[3]["loss"]), float(one[3]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(two[3]["grad_norm"]),
                               float(one[3]["grad_norm"]), rtol=1e-4)


def test_unported_training_knobs_are_refused(tmp_path):
    """int8 gradient compression, a data-parallel mesh with FSDP and a
    ``model`` axis > 1 for the dense decoders are ported
    (tests/test_torch_compression.py, tests/test_torch_dist.py,
    tests/test_torch_fsdp_train.py, tests/test_torch_tp_train.py); a
    ``model`` axis > 1 — tensor parallelism — is still refused for the
    recurrent, expert and frontend families."""
    cfg = configs.get_smoke("paper_tiny_lm")
    model = LM(cfg, device="cpu")
    assert callable(make_train_step(model, AdamW(), grad_compression=True))
    model.check_tp_training(2)                 # a dense decoder trains
    xlstm = LM(configs.get_smoke("xlstm_350m"), device="cpu")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        Trainer(xlstm, AdamW(), None,
                TrainConfig(out_dir=str(tmp_path / "unused")),
                mesh=_FakeMesh((1, 2), (0, 1)))


def test_train_then_prune_launchers(tmp_path, capsys):
    """``launch.train`` stopped and resumed, then ``launch.prune --ckpt``
    on its checkpoint with the corpus route (the default with --ckpt)."""
    out = str(tmp_path / "train")
    base = ["--smoke", "--steps", "6", "--batch", "4", "--seq", "16",
            "--ckpt-every", "2", "--device", "cpu", "--out", out]
    info = launch_train.main(base + ["--stop-at", "4"])
    assert info["steps"] == 4
    info = launch_train.main(base)
    assert info["steps"] == 2 and info["last_loss"] < 7.0
    assert "loss " in capsys.readouterr().out
    launch_prune.main(["--arch", "paper_tiny_lm", "--smoke", "--ckpt", out,
                       "--method", "SM", "--sparsity", "0.5",
                       "--calib-samples", "8", "--calib-seq", "16",
                       "--out", str(tmp_path / "pruned"), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "calibration/eval tokens: synthetic corpus" in text
    assert "SM 0.5 ppl:" in text


# ----------------------------------------------------------------------
# the gradient guard
# ----------------------------------------------------------------------
def _meta_inputs(name, grad):
    """Inputs on the meta device: not the CPU, so the wrapper takes its
    kernel route — and the guard must fire before the library loads."""
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta",
                           requires_grad=grad and dtype.is_floating_point)

    return {
        "flash_attn": (t(1, 8, 2, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)),
        "nm_spmm": (t(200, 16), t(8, 4), t(8, 4, dtype=torch.int8)),
        "nm_spmm_decode": (t(4, 16), t(8, 4), t(8, 4, dtype=torch.int8)),
        "paged_attn": (t(2, 1, 1, 8), t(3, 4, 1, 8), t(3, 4, 1, 8),
                       t(2, 2, dtype=torch.int32), t(2, dtype=torch.int32)),
        "hessian_accum": (t(16, 8), t(8, 8)),
        "nm_select": (t(4, 8), t(8, 8)),
    }[name]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    with pytest.raises(RuntimeError, match=f"{name}: an input requires grad"):
        KERNELS[name](*_meta_inputs(name, grad=True))
    with torch.no_grad():                   # past the guard: the card check
        with pytest.raises((RuntimeError, ValueError)) as err:
            KERNELS[name](*_meta_inputs(name, grad=True))
    assert "requires grad" not in str(err.value)


def test_differentiable_loss_gives_every_leaf_a_gradient():
    """The trainer's route: every param leaf gets a gradient, and the
    loss equals the kernel route's (attention in f32 either way)."""
    cfg = configs.get_smoke("paper_tiny_lm")
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = DataPipeline(cfg, 2, 12).batch_at(0)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = model.loss_fn(params, batch, differentiable=True)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert all(float(g.abs().sum()) > 0 for g in grads)
    with torch.no_grad():
        plain, _ = model.loss_fn(params, batch)
    np.testing.assert_allclose(float(loss.detach()), float(plain),
                               rtol=1e-6)


def test_online_softmax_training_attention_matches_reference(monkeypatch):
    """Past ONLINE_ATTN_THRESHOLD positions the differentiable route takes
    the reference's online softmax over KV chunks: held against the
    reference's ``_sdpa_online`` and the port's masked ``_sdpa`` (GQA,
    small chunks), and through the model's loss with the threshold
    lowered."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    want = np.asarray(j_layers._sdpa_online(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4, 2, chunk=16))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = layers._sdpa_online(tq, tk, tv, 4, 2, chunk=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    causal = torch.ones((64, 64), dtype=torch.bool).tril()
    np.testing.assert_allclose(got.numpy(), layers._sdpa(
        tq, tk, tv, causal, 4, 2).numpy(), rtol=0, atol=1e-5)

    cfg = configs.get_smoke("paper_tiny_lm")
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = DataPipeline(cfg, 2, 32).batch_at(0)
    with torch.no_grad():
        plain, _ = model.loss_fn(params, batch, differentiable=True)
        monkeypatch.setattr(layers, "ONLINE_ATTN_THRESHOLD", 16)
        monkeypatch.setattr(layers, "ONLINE_ATTN_CHUNK", 8)
        online, _ = model.loss_fn(params, batch, differentiable=True)
    np.testing.assert_allclose(float(online), float(plain), rtol=1e-6)
