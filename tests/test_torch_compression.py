"""The port's int8 error-feedback gradient compression
(``optim.compression``) against the reference's, on the CPU.

* ``quantize_int8`` / ``dequantize_int8`` / ``ef_quantize`` on seeded
  pytrees: bit-equal (both round half to even, both scale in f32);
* three Trainer steps of paper-tiny-lm SMOKE with ``grad_compression``
  from the keyed init on the corpus against the reference's trainer:
  tests/test_torch_train.py's tolerances (the loss of every step within
  LOSS_ABS; leaves within TRAIN_REL by norm, at most TRAIN_OUTLIERS of
  the entries past TRAIN_ENTRY_ABS) and the error-feedback residuals
  checkpointed under ``ef/``, as the reference's.

``compressed_psum`` needs a group: tests/test_torch_dist.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten
from repro.configs import get_smoke as j_get_smoke
from repro.data import DataPipeline as JPipe
from repro.models import LM as JLM
from repro.optim import AdamW as JAdamW
from repro.optim.compression import dequantize_int8 as j_dequantize
from repro.optim.compression import ef_init as j_ef_init
from repro.optim.compression import ef_quantize as j_ef_quantize
from repro.optim.compression import quantize_int8 as j_quantize
from repro.optim.schedules import warmup_cosine as j_cosine
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch import configs
from repro_torch.ckpt import CheckpointStore
from repro_torch.data import DataPipeline
from repro_torch.models.transformer import LM
from repro_torch.optim import (AdamW, dequantize_int8, ef_init, ef_quantize,
                               quantize_int8)
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import TrainConfig, Trainer

LOSS_ABS = 1e-4
TRAIN_REL = 5e-5
TRAIN_ENTRY_ABS = 1e-5
TRAIN_OUTLIERS = 0.001
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread (the trainer's threefry bit path is ~170 small
    int64 ops a draw, many times slower on a shared thread pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(seed):
    """A seeded pytree of f32 leaves with ties at .5 steps, zeros and a
    wide range."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((16, 8)).astype(np.float32) * 3.0
    w[0, :4] = [127.0, -63.5, 0.5, -0.5]          # half-way quantization
    return {"a": w, "b": {"c": rng.standard_normal(5).astype(np.float32),
                          "z": np.zeros((3, 2), np.float32)}}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def test_quantize_matches_reference_bit_for_bit():
    for seed in range(3):
        for leaf in (_tree(seed)["a"], _tree(seed)["b"]["c"]):
            jq, js = j_quantize(jnp.asarray(leaf))
            tq, ts = quantize_int8(torch.from_numpy(leaf))
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            assert tq.dtype == torch.int8
            assert ts.item() == float(js)
            np.testing.assert_array_equal(
                dequantize_int8(tq, ts).numpy(),
                np.asarray(j_dequantize(jq, js)))


def test_ef_quantize_matches_reference_bit_for_bit():
    grads = [_tree(s) for s in range(3)]
    jres = j_ef_init(_to(grads[0], jnp.asarray))
    tres = ef_init(_to(grads[0], torch.from_numpy))
    for g in grads:                     # the residual carried three steps
        jdeq, jres = j_ef_quantize(_to(g, jnp.asarray), jres)
        tdeq, tres = ef_quantize(_to(g, torch.from_numpy), tres)
        for path, want in _flatten(jdeq).items():
            got = tdeq
            for k in path.split("/"):
                got = got[k]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for path, want in _flatten(jres).items():
            got = tres
            for k in path.split("/"):
                got = got[k]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close_by_norm(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= TRAIN_REL, (what, err)
    far = int(np.sum(np.abs(got - want) > TRAIN_ENTRY_ABS))
    assert far <= TRAIN_OUTLIERS * got.size, (what, far)


def _f32(a):
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _losses(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def test_compressed_trainer_matches_reference(tmp_path):
    with jax.threefry_partitionable(True):
        jcfg = j_get_smoke("paper_tiny_lm")
        jt = JTrainer(JLM(jcfg), JAdamW(lr=j_cosine(1e-3, 2, STEPS),
                                        moment_dtype="bfloat16"),
                      JPipe(jcfg, 8, 32, seed=0),
                      JTrainConfig(total_steps=STEPS, global_batch=8,
                                   seq_len=32, ckpt_every=STEPS,
                                   out_dir=str(tmp_path / "j"), log_every=1,
                                   grad_compression=True))
        jparams, _, _ = jt.run()
    tcfg = configs.get_smoke("paper_tiny_lm")
    tt = Trainer(LM(tcfg, device="cpu"),
                 AdamW(lr=warmup_cosine(1e-3, 2, STEPS),
                       moment_dtype="bfloat16"),
                 DataPipeline(tcfg, 8, 32, seed=0),
                 TrainConfig(total_steps=STEPS, global_batch=8, seq_len=32,
                             ckpt_every=STEPS, out_dir=str(tmp_path / "t"),
                             log_every=1, grad_compression=True))
    tparams, _, info = tt.run()
    assert info["steps"] == STEPS and info["skipped_steps"] == 0
    np.testing.assert_allclose(_losses(tmp_path / "t"),
                               _losses(tmp_path / "j"), rtol=0,
                               atol=LOSS_ABS)
    want = _flatten(jparams)
    got = tt.model.params_to_flat(tparams)
    for path in want:
        _close_by_norm(_f32(got[path]), _f32(want[path]), path)
    # the residuals are checkpointed as the reference's "ef" tree, and
    # the port reads the reference's back
    step, (_, _, ef), _ = CheckpointStore(str(tmp_path / "j")).restore(
        convert=tt.from_flat)
    assert step == STEPS and isinstance(ef, dict)
    _, (_, _, tef), _ = CheckpointStore(str(tmp_path / "t")).restore(
        convert=tt.from_flat)
    jef = tt.model.params_to_flat(ef)
    for path, leaf in tt.model.params_to_flat(tef).items():
        assert leaf.dtype == np.float32 and leaf.shape == jef[path].shape
        assert np.abs(leaf).max() <= np.abs(_f32(want[path])).max() + 1.0
