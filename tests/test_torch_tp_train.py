"""Tensor-parallel training in the port, on the CPU: ``gloo`` groups of
2 ranks (mesh 1x2) and 4 ranks (2x2: FSDP over data and blocks over
model at once), spawned once for the module
(``tests/torch_train_worker.py``'s ``tp_train_cases``), held against the
port's one-device trainer and the JAX package's single-device trainer
(sharding does not change the mathematics; the reference's own mesh
trainer tests fail on this jax).

* the dense decoders' SMOKE configs — paper_tiny_lm, qwen1.5-0.5b (QKV
  biases, a tied vocab-parallel head), gemma-2b (one KV head kept whole
  on every rank), qwen3-14b (q / k-norm), gemma3-12b (5 local : 1
  global) — and a twin of paper_tiny_lm whose ranks' query heads
  straddle KV groups (6 / 3 heads): each leaf's gradient after one step,
  gathered whole, within GRAD_REL by norm of one device's, every rank's
  bit-equal, and within GRAD_REL of ``jax.grad`` of the reference's
  ``loss_fn`` on the same params and batch; 3 steps' losses within
  LOSS_ABS of the one-device trainer's (every rank's bit-equal) and
  each leaf within TRAIN_REL by norm — or, a bias that three Adam steps moved from zero, every entry
  within TRAIN_ENTRY_ABS — with at most TRAIN_OUTLIERS of its entries
  past TRAIN_ENTRY_ABS (tests/test_torch_dist.py's bounds); a rank's
  params and moments under one device's; qwen3-14b and gemma-2b also
  against the JAX single-device trainer at the same bounds;
* the recurrent, expert and frontend families under a model axis > 1
  raise, naming ROADMAP.md;
* elastic resume: paper_tiny_lm saved after step 2 of 3 on 2x1 with
  FSDP — a checkpoint in the reference's layout, which the JAX
  package's trainer restores — resumes on 1x2 and on one device equal
  to the uninterrupted run (the bounds above), and on 2x1 bit for bit
  equal to the uninterrupted 2x1 run;
* the pipeline: ranks of one data coordinate get the same rows.

``test_nccl_fsdp_tp_train_on_two_cards`` (marked ``cuda``) runs the
training CLI on 2x1 and 1x2 over NCCL, one card a rank.
"""

import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as W
import torch_train_worker as T

GRAD_REL = 5e-5
LOSS_ABS = 1e-4
TRAIN_REL = 5e-5
TRAIN_ENTRY_ABS = 1e-5
TRAIN_OUTLIERS = 0.001
WORLDS = (2, 4)
JAX_MODELS = ("qwen3_14b", "gemma_2b")
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The ranks' results, and the one-device references computed here
    while the ranks run."""
    tmp = tmp_path_factory.mktemp("tp_train")
    ranks: dict = {}

    def spawn():
        try:
            ranks.update(W.run_groups(
                WORLDS, {"out": str(tmp)}, None, timeout=600.0,
                cases="torch_train_worker:tp_train_cases"))
        except BaseException as e:          # raised below, in the fixture
            ranks["error"] = e

    spawned = threading.Thread(target=spawn)
    spawned.start()
    one = {}
    for name in T.TP_MODELS:
        cfg = T.tp_config(name)
        one[name] = dict(grads=T.one_step_grads(cfg, None, str(tmp / "g")),
                         train=T.train_run(cfg, None, str(tmp / name)))
    jax_refs = {name: T.jax_trainer_run(tmp / f"j_{name}", name)
                for name in JAX_MODELS}
    jax_grads = {name: T.jax_one_step_grads(name) for name in T.TP_MODELS}
    spawned.join()
    if "error" in ranks:
        raise ranks["error"]
    return dict(ranks=ranks, one=one, jax=jax_refs, jax_grads=jax_grads,
                tmp=tmp)


def _f32(a):
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close_by_norm(got, want, what):
    """Within TRAIN_REL by norm, or every entry within TRAIN_ENTRY_ABS
    (a bias that three Adam steps moved from zero: its norm is ≈ lr, and
    Adam gives an entry whose gradient is rounding-sized a whole step);
    at most TRAIN_OUTLIERS of the entries past TRAIN_ENTRY_ABS."""
    diff = np.abs(_f32(got) - _f32(want))
    err = _rel(got, want)
    assert err <= TRAIN_REL or diff.max() <= TRAIN_ENTRY_ABS, (what, err)
    far = int(np.sum(diff > TRAIN_ENTRY_ABS))
    assert far <= TRAIN_OUTLIERS * diff.size, (what, far)


def _same_run(run, want_flat, want_losses, what):
    np.testing.assert_allclose(run["losses"], want_losses, rtol=0,
                               atol=LOSS_ABS)
    for path, leaf in want_flat.items():
        _close_by_norm(run["flat"][path], leaf, f"{what}/{path}")


CASES = [(w, n) for w in WORLDS for n in T.TP_MODELS]
IDS = [f"{'1x2' if w == 2 else '2x2'}-{n}" for w, n in CASES]


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_tp_grads_match_one_device(tp, world, name):
    want = tp["one"][name]["grads"]
    ranks = tp["ranks"][world]
    for r in ranks:
        got = r[name]["grads"]
        assert got["loss"] == pytest.approx(want["loss"], abs=LOSS_ABS)
        for path, leaf in want["flat"].items():
            assert np.array_equal(got["flat"][path],
                                  ranks[0][name]["grads"]["flat"][path])
            err = _rel(got["flat"][path], leaf)
            assert err <= GRAD_REL, (path, err)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_tp_grads_match_reference_single_device(tp, world, name):
    """Each leaf's gathered first-step gradient against ``jax.grad`` of
    the reference's ``loss_fn`` on the same params and batch."""
    want = tp["jax_grads"][name]
    for r in tp["ranks"][world]:
        got = r[name]["grads"]
        assert got["loss"] == pytest.approx(want["loss"], abs=LOSS_ABS)
        assert sorted(got["flat"]) == sorted(want["flat"])
        for path, leaf in want["flat"].items():
            err = _rel(got["flat"][path], leaf)
            assert err <= GRAD_REL, (path, err)


@pytest.mark.parametrize("world,name", CASES, ids=IDS)
def test_tp_trainer_matches_one_device(tp, world, name):
    want = tp["one"][name]["train"]
    ranks = tp["ranks"][world]
    for r in ranks:
        run = r[name]["train"]
        assert run["losses"] == ranks[0][name]["train"]["losses"]
        _same_run(run, want["flat"], want["losses"], name)
        assert run["bytes"] < want["bytes"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", JAX_MODELS)
def test_tp_trainer_matches_reference_single_device(tp, world, name):
    want, records = tp["jax"][name]
    for r in tp["ranks"][world]:
        _same_run(r[name]["train"], want, [x["loss"] for x in records],
                  name)


@pytest.mark.parametrize("arch", T.TP_REFUSED)
def test_model_axis_refuses_other_families(tp, arch):
    for r in tp["ranks"][2]:
        msg = r["refused"][arch]
        assert msg is not None and "ROADMAP.md" in msg, (arch, msg)


@pytest.mark.parametrize("target", ["on_1x2", "on_one"])
def test_resume_across_meshes(tp, target):
    """Saved on 2x1 with FSDP after step 2, resumed for step 3 on another
    mesh: the one-device uninterrupted run's step 3 and params."""
    want = tp["one"]["paper_tiny_lm"]["train"]
    for r in tp["ranks"][2]:
        if target not in r:
            continue                       # one device: rank 0 alone
        run = r[target]
        assert len(run["losses"]) == 1
        _same_run(run, want["flat"], want["losses"][-1:], target)


def test_resume_on_the_same_mesh_is_bit_identical(tp):
    for r in tp["ranks"][2]:
        whole, resumed = r["uninterrupted"], r["on_2x1"]
        assert resumed["losses"] == whole["losses"][-1:]
        for path, leaf in whole["flat"].items():
            assert np.array_equal(resumed["flat"][path], leaf), path


def test_checkpoint_is_the_reference_layout(tp):
    """The reference's checkpoint store reads the 2x1 FSDP run's step-2
    checkpoint into its trainer's state template (the tree, shapes and
    dtypes of one device's state): whole leaves, equal to the params
    that run returned.  (The reference's ``restore_or_init`` then
    ``device_put`` s the bf16 moments, which its store hands back as
    2-byte voids, and fails on them — its own checkpoints too.)"""
    import jax

    from repro.ckpt.store import _flatten
    from repro.configs import get_smoke
    from repro.data import DataPipeline
    from repro.models import LM
    from repro.optim import AdamW
    from repro.train import TrainConfig, Trainer

    jcfg = get_smoke("paper_tiny_lm")
    with jax.threefry_partitionable(True):
        jt = Trainer(LM(jcfg), AdamW(moment_dtype="bfloat16"),
                     DataPipeline(jcfg, T.BATCH, T.SEQ),
                     TrainConfig(out_dir=str(tp["tmp"] / "saved")))
        template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                jt._state_template())
    step, tree, _ = jt.store.restore(template)
    assert step == 2
    flat = tp["ranks"][2][0]["first_part"]["flat"]
    got = {k: np.asarray(v) for k, v in _flatten(tree["params"]).items()}
    assert sorted(got) == sorted(flat)
    for path, leaf in flat.items():
        assert np.array_equal(_f32(got[path]), _f32(leaf)), path


def test_rows_follow_the_data_coordinate(tp):
    """On 2x2 the ranks of one data coordinate (model 0 and 1) hold the
    same rows; the two data coordinates' rows are the global batch."""
    from repro_torch.data import DataPipeline

    rows = [r["rows"] for r in tp["ranks"][4]]
    np.testing.assert_array_equal(rows[0], rows[1])
    np.testing.assert_array_equal(rows[2], rows[3])
    whole = DataPipeline(T.arch_config("paper_tiny_lm"), T.BATCH, T.SEQ,
                         seed=0).batch_at(0)["tokens"].numpy()
    np.testing.assert_array_equal(np.concatenate([rows[0], rows[2]]), whole)


# ----------------------------------------------------------------------
# on two cards
# ----------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli_losses(out, mesh=None, ranks=1):
    """The training CLI on qwen1.5-0.5b SMOKE (3 steps of 8 × 32, f32),
    one process a rank (one card each): rank 0's logged losses."""
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen1_5_0_5b", "--smoke", "--steps", "3", "--batch", "8",
            "--seq", "32", "--ckpt-every", "3", "--device", "cuda",
            "--out", str(out)] + (["--mesh", mesh] if mesh else [])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(ranks))
    procs = [subprocess.Popen(argv, cwd=ROOT, env=dict(
        env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(ranks)]
    for p in procs:
        text, _ = p.communicate(timeout=600)
        assert p.returncode == 0, text[-3000:]
    with open(out / "metrics.jsonl") as f:
        return [json.loads(line)["loss"] for line in f]


@pytest.mark.cuda
@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two cards: one rank of an NCCL group each")
def test_nccl_fsdp_tp_train_on_two_cards(tmp_path):
    """2x1 with FSDP (NCCL's reduce_scatter_tensor) and 1x2
    tensor-parallel, one card a rank: every step's loss within LOSS_ABS
    of one card's."""
    want = _cli_losses(tmp_path / "one")
    for mesh in ("2x1", "1x2"):
        got = _cli_losses(tmp_path / mesh, mesh, ranks=2)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ABS)
