"""The port's distribution on the CPU: ``gloo`` groups of 2 ranks (meshes
1x2 and 2x1) and of 4 ranks (2x2), spawned once for the module
(``tests/torch_dist_worker.py`` runs every case on the ranks), held
against the JAX package's single-device paths — its own mesh tests fail
on this jax (ROADMAP.md, Standing notes).

Tolerances:

* row-parallel solves against the reference's one-device
  ``prune_matrix(row_balanced=True)``: masks equal, weights within
  PRUNE_ATOL (the bound of the reference's tests/test_dist.py);
* the merged Hessian against ``HessianAccumulator.merge``: HESS_RTOL;
* ``compressed_psum`` against the reference's (8-bit on the wire, run in
  a subprocess with two virtual devices): within one int8 step of the
  output's scale (max |out| / 127);
* the pipelined engine — calibration sharded over data with one
  Hessian all-reduce a linear, solves row-parallel over model — against
  the reference's serial engine: tests/test_torch_pipeline.py's bounds
  against the reference (layer 0 equal, every mask ≥ 98 % equal, each
  reconstruction error within 1e-2 relative, sparsity equal);
* the data-parallel trainer against the one-rank trainer and the
  reference's single-device trainer, f32: tests/test_torch_train.py's
  (losses within LOSS_ABS; leaves within TRAIN_REL by norm, at most
  TRAIN_OUTLIERS of the entries past TRAIN_ENTRY_ABS);
* data-parallel MoE training (phi3.5-moe SMOKE, the global batch routed
  across the ranks): each step's loss and aux within MOE_ABS of the
  reference trainer's; the pipelined pruning engine on phi3.5-moe SMOKE
  with its calibration sharded over data (each shard routed on its own)
  and unsharded, against the reference's pipelined engine on one device
  with the same shards, at the sharded engine's bounds above.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
import threading

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from repro.ckpt.store import _flatten
from repro.configs import get_smoke as j_get_smoke
from repro.core import PruningEngine as JEngine
from repro.core.hessian import HessianAccumulator as JAcc
from repro.core.pruner import prune_matrix as j_prune_matrix
from repro.core.sparsity import SparsitySpec as JSpec
from repro.data import DataPipeline as JPipe
from repro.data import calibration_batches as j_calibration
from repro.models import LM as JLM
from repro.optim import AdamW as JAdamW
from repro.optim.schedules import warmup_cosine as j_cosine
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch import configs
from repro_torch.data import calibration_batches as t_calibration
from repro_torch.data import DataPipeline
from repro_torch.dist import DistContext, current_ctx, mesh_from_spec, use_mesh
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import TrainConfig, Trainer

PRUNE_ATOL = 2e-4
HESS_RTOL = 1e-4
MASK_AGREE = 0.98
RECON_REL = 1e-2
LOSS_ABS = 1e-4
TRAIN_REL = 5e-5
TRAIN_ENTRY_ABS = 1e-5
TRAIN_OUTLIERS = 0.001
MOE_ABS = 2e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLDS = (2, 4)

REFERENCE_PSUM = """
import sys
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.dist import shard_map
from repro.optim.compression import compressed_psum

xs = np.load(sys.argv[1])
mesh = jax.make_mesh((xs.shape[0],), ("data",))
out = jax.jit(shard_map(lambda x: compressed_psum(x[0], "data"),
                        mesh=mesh, in_specs=P("data"),
                        out_specs=P("data")))(xs)
np.save(sys.argv[2], np.asarray(out).reshape(xs.shape[0], -1))
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread (the trainer's threefry bit path is ~170 small
    int64 ops a draw, many times slower on a shared thread pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The reference's keyed init of the engine cases' model and its
    calibration batches, the 2- and 4-rank groups' results, and the
    reference's compressed_psum (its subprocess runs beside the
    groups)."""
    tmp = tmp_path_factory.mktemp("dist")
    np.save(tmp / "xs.npy", W.psum_inputs(2))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    psum = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE_PSUM),
         str(tmp / "xs.npy"), str(tmp / "psum.npy")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with jax.threefry_partitionable(True):
        jm = JLM(dataclasses.replace(j_get_smoke("paper_tiny_lm"),
                                     **W.ENGINE_CFG))
        jp = jax.jit(jm.init)(jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    with jax.threefry_partitionable(True):
        jmoe = jax.jit(JLM(j_get_smoke("phi3_5_moe_42b_a6_6b")).init)(
            jax.random.key(0))
    moe_flat = {k: np.asarray(v) for k, v in _flatten(jmoe).items()}
    jcal = j_calibration(jm.cfg, n_samples=32, seq_len=32)
    calib = [{k: np.asarray(b[k]) for k in ("tokens", "labels")}
             for b in jcal]
    # the ranks run while the reference's serial engine compiles here
    ranks: dict = {}

    def spawn():
        try:
            ranks.update(W.run_groups(WORLDS, {"tiny": flat,
                                               "moe": moe_flat}, calib))
        except BaseException as e:          # raised below, in the fixture
            ranks["error"] = e

    spawned = threading.Thread(target=spawn)
    spawned.start()
    pruned, reports = JEngine(jm, "2:4", method=W.ENGINE_METHOD,
                              blocksize=W.BLOCK, pipeline="off").run(jp, jcal)
    spawned.join()
    if "error" in ranks:
        raise ranks["error"]
    serial = ({k: np.asarray(v, np.float32)
               for k, v in _flatten(pruned).items()},
              [(r.name, r.sparsity, r.recon_error) for r in reports])
    _, err = psum.communicate(timeout=300)
    assert psum.returncode == 0, err
    return dict(ranks=ranks, serial=serial, psum=np.load(tmp / "psum.npy"),
                tmp=tmp, moe_flat=moe_flat)


@functools.lru_cache(maxsize=None)
def _reference_prune(spec: str, method: str):
    w, h = W.prune_inputs()
    res = j_prune_matrix(w, h, JSpec.parse(spec), method=method,
                         blocksize=W.BLOCK, row_balanced=True)
    return np.asarray(res.w), np.asarray(res.mask)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", W.PRUNE_CASES, ids="-".join)
def test_row_parallel_prune_matches_reference_single_device(groups, world,
                                                            case):
    want_w, want_mask = _reference_prune(*case)
    for r in groups["ranks"][world]:
        got_w, got_mask = r["prune"][case]
        np.testing.assert_array_equal(got_mask, want_mask)
        np.testing.assert_allclose(got_w, want_w, rtol=0, atol=PRUNE_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_hessian_allreduce_matches_reference_merge(groups, world):
    (h0, n0), (h1, n1) = W.hessian_inputs(2)
    want = JAcc(16, h=h0, count=np.float32(n0)).merge(
        JAcc(16, h=h1, count=np.float32(n1)))
    for r in groups["ranks"][world]:
        np.testing.assert_allclose(r["hessian"], np.asarray(want.h),
                                   rtol=HESS_RTOL, atol=1e-6)
        both_h, both_n = r["calib_merge"]["both"]
        np.testing.assert_allclose(both_h, np.asarray(want.h),
                                   rtol=HESS_RTOL, atol=1e-6)
        assert both_n == float(want.count)
        # the reference's fallback for a linear one shard lacks:
        # merge_many over the shards that hold it — here rank 0's alone
        only_h, only_n = r["calib_merge"]["only0"]
        np.testing.assert_array_equal(only_h, h0)
        assert only_n == n0


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_matches_reference(groups, world):
    want = groups["psum"]
    step = np.abs(want).max() / 127.0
    for r in groups["ranks"][world]:
        assert r["psum"].shape == want[0].shape
        assert np.abs(r["psum"] - want[0]).max() <= step
        np.testing.assert_array_equal(r["psum"], groups["ranks"][world][0][
            "psum"])
    # and the int8 mean is close to the exact one, as the reference's test
    exact = W.psum_inputs(2).mean(0)
    assert np.abs(want[0] - exact).max() < 4 * np.abs(
        W.psum_inputs(2)).max() / 127


def _engine_runs(groups, world):
    keys = (("engine_dp", "engine_tp", "engine_tp_serial") if world == 2
            else ("engine_dp",))
    return [(key, r[key]) for r in groups["ranks"][world] for key in keys]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_engine_matches_reference_serial(groups, world):
    want_flat, want_reports = groups["serial"]
    runs = _engine_runs(groups, world)
    for key, (flat, reports) in runs:
        assert [r[0] for r in reports] == [r[0] for r in want_reports]
        for (name, sp, err), (_, jsp, jerr) in zip(reports, want_reports):
            assert sp == pytest.approx(jsp, abs=1e-6), (key, name)
            assert err == pytest.approx(jerr, rel=RECON_REL), (key, name)
        for path, want in want_flat.items():
            if not path.endswith(("wq", "wk", "wv", "wo", "wi", "wg")):
                continue
            got = np.asarray(flat[path], np.float32)
            agree = float(np.mean((got == 0) == (want == 0)))
            if path.startswith("layers/s0"):      # layer 0 exactly:
                layer0 = (got[0] == 0) == (want[0] == 0)
                assert layer0.all(), (key, path)
            assert agree >= MASK_AGREE, (key, path, agree)
    # every rank of a run ends with the same params
    by_key: dict = {}
    for key, (flat, _) in runs:
        if key in by_key:
            for path in flat:
                np.testing.assert_array_equal(flat[path], by_key[key][path])
        by_key[key] = flat


def _port_trainer(out, grad_compression=False):
    cfg = configs.get_smoke("paper_tiny_lm")
    trainer = Trainer(
        LM(cfg, device="cpu"),
        AdamW(lr=warmup_cosine(1e-3, 2, W.TRAIN_STEPS),
              moment_dtype="bfloat16"),
        DataPipeline(cfg, 8, 32, seed=0),
        TrainConfig(total_steps=W.TRAIN_STEPS, global_batch=8, seq_len=32,
                    ckpt_every=W.TRAIN_STEPS, out_dir=str(out), log_every=1,
                    grad_compression=grad_compression))
    params, _, info = trainer.run()
    return (trainer.model.params_to_flat(params), info["first_loss"],
            info["last_loss"])


def _close_by_norm(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= TRAIN_REL, (what, err)
    far = int(np.sum(np.abs(got - want) > TRAIN_ENTRY_ABS))
    assert far <= TRAIN_OUTLIERS * got.size, (what, far)


def _bf16_f32(a):
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def test_data_parallel_trainer_matches_one_rank_and_reference(groups):
    tmp = groups["tmp"]
    one = _port_trainer(tmp / "one")
    with jax.threefry_partitionable(True):
        jcfg = j_get_smoke("paper_tiny_lm")
        jt = JTrainer(JLM(jcfg), JAdamW(lr=j_cosine(1e-3, 2, W.TRAIN_STEPS),
                                        moment_dtype="bfloat16"),
                      JPipe(jcfg, 8, 32, seed=0),
                      JTrainConfig(total_steps=W.TRAIN_STEPS, global_batch=8,
                                   seq_len=32, ckpt_every=W.TRAIN_STEPS,
                                   out_dir=str(tmp / "j"), log_every=1))
        jparams, _, _ = jt.run()
    want = {k: _bf16_f32(v) for k, v in _flatten(jparams).items()}
    for r in groups["ranks"][2]:
        flat, first, last = r["train"]
        for ref_first, ref_last, ref_flat in ((one[1], one[2], one[0]),
                                              (None, None, want)):
            if ref_first is not None:
                assert first == pytest.approx(ref_first, abs=LOSS_ABS)
                assert last == pytest.approx(ref_last, abs=LOSS_ABS)
            for path in ref_flat:
                _close_by_norm(_bf16_f32(flat[path]),
                               _bf16_f32(ref_flat[path]), path)
    # the reference's logged losses, step by step, against rank 0's
    import json
    with open(tmp / "j" / "metrics.jsonl") as f:
        jl = [json.loads(line)["loss"] for line in f]
    assert groups["ranks"][2][0]["train"][1] == pytest.approx(jl[0],
                                                              abs=LOSS_ABS)
    assert groups["ranks"][2][0]["train"][2] == pytest.approx(jl[-1],
                                                              abs=LOSS_ABS)


def test_data_parallel_compressed_trainer_matches_one_rank(groups):
    """int8 error feedback on the reduced gradients: two ranks step as
    one rank does (the reference's compression trainer:
    tests/test_torch_compression.py)."""
    one = _port_trainer(groups["tmp"] / "one_ef", grad_compression=True)
    for r in groups["ranks"][2]:
        flat, first, last = r["train_ef"]
        assert first == pytest.approx(one[1], abs=LOSS_ABS)
        assert last == pytest.approx(one[2], abs=LOSS_ABS)
        for path in one[0]:
            _close_by_norm(_bf16_f32(flat[path]), _bf16_f32(one[0][path]),
                           path)


def test_data_parallel_moe_trainer_matches_reference(groups):
    """Two ranks of a 2x1 mesh route the global batch of 8 × 32 as the
    reference does: capacity, top-C and the load-balance fractions over
    both ranks' tokens (per rank they part by up to 5e-3 in the loss)."""
    import json

    tmp = groups["tmp"]
    with jax.threefry_partitionable(True):
        jcfg = j_get_smoke("phi3_5_moe_42b_a6_6b")
        jt = JTrainer(JLM(jcfg), JAdamW(lr=j_cosine(1e-3, 2, W.TRAIN_STEPS),
                                        moment_dtype="bfloat16"),
                      JPipe(jcfg, 8, 32, seed=0),
                      JTrainConfig(total_steps=W.TRAIN_STEPS, global_batch=8,
                                   seq_len=32, ckpt_every=W.TRAIN_STEPS,
                                   out_dir=str(tmp / "jmoe"), log_every=1))
        jt.run()
    with open(tmp / "jmoe" / "metrics.jsonl") as f:
        want = [(r["loss"], r["aux"]) for r in map(json.loads, f)]
    assert len(want) == W.TRAIN_STEPS
    for r in groups["ranks"][2]:
        got = r["train_moe"]
        assert len(got) == W.TRAIN_STEPS
        np.testing.assert_allclose(got, want, rtol=0, atol=MOE_ABS)


def test_moe_replicated_rows_route_per_rank(groups):
    """Under a 2x1 context whose ranks hold the same rows (the CLI's eval,
    replicated calibration), a MoE layer routes its own tokens: both
    ranks give one device's output and aux, bit for bit."""
    for r in groups["ranks"][2]:
        (y, aux), (y1, aux1) = r["moe_replicated"]
        np.testing.assert_array_equal(y, y1)
        assert aux == aux1


@functools.lru_cache(maxsize=None)
def _reference_moe_engine(calib_shard):
    """The reference's pipelined engine on one device, phi3.5-moe SMOKE
    from the keyed init, two calibration batches of 8 × 32 in
    ``calib_shard`` shards; and the batches."""
    with jax.threefry_partitionable(True):
        jm = JLM(j_get_smoke("phi3_5_moe_42b_a6_6b"))
        jp = jax.jit(jm.init)(jax.random.key(0))
        jcal = j_calibration(jm.cfg, n_samples=16, seq_len=32, batch=8)
        pruned, reports = JEngine(jm, "2:4", method=W.ENGINE_METHOD,
                                  blocksize=W.BLOCK,
                                  calib_shard=calib_shard).run(jp, jcal)
    return ({k: np.asarray(v, np.float32)
             for k, v in _flatten(pruned).items()},
            [(r.name, r.sparsity, r.recon_error) for r in reports], jcal)


def _assert_engine_close(got, want, key):
    """The sharded engine's bounds: the same linears, sparsity within
    1e-6, reconstruction errors within RECON_REL, layer 0's masks equal
    and at least MASK_AGREE of every other mask."""
    flat, reports = got
    want_flat, want_reports = want
    assert [x[0] for x in reports] == [x[0] for x in want_reports]
    assert any(".moe.wi." in x[0] for x in reports)
    for (name, sp, err), (_, jsp, jerr) in zip(reports, want_reports):
        assert sp == pytest.approx(jsp, abs=1e-6), (key, name)
        assert err == pytest.approx(jerr, rel=RECON_REL), (key, name)
    for path, want_w in want_flat.items():
        if not path.endswith(("wq", "wk", "wv", "wo", "wi", "wg")):
            continue
        got_w = np.asarray(flat[path], np.float32)
        if path.startswith("layers/s0"):
            assert ((got_w[0] == 0) == (want_w[0] == 0)).all(), (key, path)
        agree = float(np.mean((got_w == 0) == (want_w == 0)))
        assert agree >= MASK_AGREE, (key, path, agree)


@pytest.mark.parametrize("key,calib_shard", [("engine_moe_dp", 2),
                                             ("engine_moe_off", "off")])
def test_moe_engine_sharded_calibration_matches_reference(groups, key,
                                                          calib_shard):
    """The pruning engine on 2x1 ranks, phi3.5-moe SMOKE: with the
    calibration sharded over data each rank calibrates its batch, routed
    on its own as the reference routes each shard's program — the
    reference's engine on one device in two shards; with sharding off
    both ranks calibrate both batches — the reference's in one shard.
    The port's one-rank engine in the same shards agrees too."""
    want_flat, want_reports, jcal = _reference_moe_engine(calib_shard)
    # both sides calibrate on the same batches
    for tb, jb in zip(t_calibration(configs.get_smoke(W.MOE_ARCH),
                                    n_samples=16, seq_len=32, batch=8),
                      jcal):
        np.testing.assert_array_equal(tb["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
    for r in groups["ranks"][2]:
        _assert_engine_close(r[key], (want_flat, want_reports), key)
    _assert_engine_close(W.moe_engine_run(groups["moe_flat"],
                                          calib_shard=calib_shard),
                         (want_flat, want_reports), "one rank")


# ----------------------------------------------------------------------
class _FakeMesh:
    """The DeviceMesh surface ``use_mesh`` reads."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)


def test_dist_api_context_rules():
    assert current_ctx() is None
    mesh = _FakeMesh((2, 3), ("data", "model"))
    with use_mesh(mesh) as ctx:
        assert current_ctx() is ctx and isinstance(ctx, DistContext)
        assert ctx.mesh is mesh and ctx.dp_axes == ("data",)
        assert ctx.dp == 2 and ctx.tp_axis == "model" and ctx.tp == 3
        inner = _FakeMesh((2, 2, 1), ("pod", "data", "model"))
        with use_mesh(inner) as ictx:
            assert current_ctx() is ictx
            assert ictx.dp_axes == ("pod", "data") and ictx.dp == 4
        assert current_ctx() is ctx
    assert current_ctx() is None
    with use_mesh(_FakeMesh((4,), ("data",))) as ctx:
        assert ctx.tp_axis is None and ctx.tp == 1
    with pytest.raises(RuntimeError):
        with use_mesh(mesh):
            raise RuntimeError("boom")
    assert current_ctx() is None


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_from_spec_every_spec(groups, world):
    assert mesh_from_spec(None) is None
    assert mesh_from_spec("") is None and mesh_from_spec("none") is None
    with pytest.raises(ValueError, match="unrecognized"):
        mesh_from_spec("2by4")
    sizes = {"host": 1, "production": 256, "production-2pod": 512,
             "3x1": 3, "1x1x3": 3}
    for r in groups["ranks"][world]:
        for spec, msg in r["spec_errors"].items():
            assert msg is not None, spec
            assert str(sizes[spec]) in msg and f"world size {world}" in msg
        assert r["shape"] == (((1, 2), (2, 1)) if world == 2
                              else ((2, 2), (2, 2)))
