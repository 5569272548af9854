"""The rank side of tests/test_torch_dist.py: one process of a ``gloo``
group on the CPU, spawned with :func:`run_groups`.  It imports only
``torch`` and the port (no jax), runs every distributed case of its
world size and sends its results back to the test process, which holds
them against the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

# (spec, method) of the row-parallel solves; MS / MM select N:M only
PRUNE_CASES = (("2:4", "SM"), ("2:4", "MM"), ("0.5", "SM"))
BLOCK = 32
TRAIN_STEPS = 3
ENGINE_METHOD = "MS"        # the 𝔐 mask: nm_select in every row shard
# the engine cases' model: paper-tiny-lm SMOKE with d_ff = d_model, so
# that every linear has one shape (the reference's serial engine, which
# the cases are held against, compiles each op once per shape)
ENGINE_CFG = dict(d_ff=64)


def prune_inputs(n: int = 32, m: int = 64):
    """The seeded (w, h) every row-parallel case solves."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((n, m)).astype(np.float32)
    x = rng.standard_normal((m, 4 * m)).astype(np.float32)
    return w, (2.0 * x @ x.T / (4 * m)).astype(np.float32)


def hessian_inputs(world: int, m: int = 16):
    """Per rank an (H, count) pair, as data shards accumulate them."""
    rng = np.random.default_rng(1)
    out = []
    for r in range(world):
        x = rng.standard_normal((m, 8 * (r + 1))).astype(np.float32)
        out.append(((2.0 * x @ x.T / x.shape[1]).astype(np.float32),
                    float(x.shape[1])))
    return out


def psum_inputs(world: int, n: int = 256):
    """Per rank a 1-D vector for compressed_psum."""
    return np.random.default_rng(2).standard_normal(
        (world, n)).astype(np.float32)


def _engine_run(model, params, calib, mesh, **kw):
    from repro_torch.core.engine import PruningEngine

    pruned, reports = PruningEngine(model, "2:4", method=ENGINE_METHOD,
                                    blocksize=BLOCK, mesh=mesh,
                                    **kw).run(params, calib)
    return (model.params_to_flat(pruned),
            [(r.name, r.sparsity, r.recon_error) for r in reports])


def _trainer_run(mesh, out: str, grad_compression: bool):
    from repro_torch import configs
    from repro_torch.data import DataPipeline
    from repro_torch.models.transformer import LM
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainConfig, Trainer

    cfg = configs.get_smoke("paper_tiny_lm")
    model = LM(cfg, device="cpu")
    trainer = Trainer(
        model, AdamW(lr=warmup_cosine(1e-3, 2, TRAIN_STEPS),
                     moment_dtype="bfloat16"),
        DataPipeline(cfg, 8, 32, seed=0, mesh=mesh),
        TrainConfig(total_steps=TRAIN_STEPS, global_batch=8, seq_len=32,
                    ckpt_every=TRAIN_STEPS, out_dir=out, log_every=1,
                    grad_compression=grad_compression),
        mesh=mesh)
    params, _, info = trainer.run()
    return model.params_to_flat(params), info["first_loss"], info[
        "last_loss"]


def _cases(rank: int, world: int, flat, calib, tmp: str) -> dict:
    import torch.distributed as dist

    from repro_torch.core.distributed import (allreduce_calibration,
                                              hessian_allreduce,
                                              prune_matrix_sharded)
    from repro_torch.core.calibration import CalibrationSet
    from repro_torch.core.hessian import HessianAccumulator
    from repro_torch.dist import comm, mesh_from_spec, use_mesh
    from repro_torch import configs
    from repro_torch.models.transformer import LM
    from repro_torch.optim.compression import compressed_psum

    res: dict = {"rank": rank}
    w, h = (torch.from_numpy(a) for a in prune_inputs())
    tp_spec = "1x2" if world == 2 else "2x2"
    dp_spec = "2x1" if world == 2 else "2x2"
    tp_mesh = mesh_from_spec(tp_spec, device="cpu")
    dp_mesh = tp_mesh if dp_spec == tp_spec else mesh_from_spec(
        dp_spec, device="cpu")

    # the mesh specs: a size other than the world's raises, naming both
    res["spec_errors"] = {}
    for spec in ("host", "production", "production-2pod", "3x1",
                 "1x1x3"):
        try:
            mesh_from_spec(spec, device="cpu")
            res["spec_errors"][spec] = None
        except ValueError as e:
            res["spec_errors"][spec] = str(e)
    res["shape"] = tuple(tp_mesh.shape), tuple(dp_mesh.shape)

    # row-parallel solves over the model axis
    res["prune"] = {}
    for spec, method in PRUNE_CASES:
        w_new, mask = prune_matrix_sharded(w, h, spec, tp_mesh,
                                           method=method, blocksize=BLOCK)
        res["prune"][(spec, method)] = (w_new.numpy(), mask.numpy())

    # the Hessian merge over the data axis: each data rank holds a shard
    data_idx = dp_mesh.get_coordinate()[0]
    h_loc, n_loc = hessian_inputs(2)[data_idx]
    res["hessian"] = hessian_allreduce(
        dp_mesh, torch.from_numpy(h_loc), n_loc, "data").numpy()
    # a linear only data rank 0 saw merges over that rank alone
    local = CalibrationSet()
    local.accs["both"] = HessianAccumulator(
        16, h=torch.from_numpy(h_loc), count=n_loc)
    if data_idx == 0:
        local.accs["only0"] = HessianAccumulator(
            16, h=torch.from_numpy(h_loc), count=n_loc)
    merged = allreduce_calibration(local, dp_mesh, "data")
    res["calib_merge"] = {k: (a.h.numpy(), float(a.count))
                          for k, a in merged.accs.items()}

    # compressed_psum over the data axis
    xs = psum_inputs(2)
    res["psum"] = compressed_psum(torch.from_numpy(xs[data_idx]),
                                  comm.group_of(dp_mesh, "data")).numpy()

    # the pipelined engine: calibration sharded over data, solves
    # row-parallel over model (2x2: both at once)
    model = LM(dataclasses.replace(configs.get_smoke("paper_tiny_lm"),
                                   **ENGINE_CFG), device="cpu")
    params = model.params_from_jax(flat)
    tcal = [{k: torch.from_numpy(v) for k, v in b.items()} for b in calib]
    with use_mesh(dp_mesh):
        res["engine_dp"] = _engine_run(model, params, tcal, None)
    if world == 2:
        res["engine_tp"] = _engine_run(model, params, tcal, tp_mesh)
        res["engine_tp_serial"] = _engine_run(model, params, tcal, tp_mesh,
                                              pipeline="off")
        res["train"] = _trainer_run(dp_mesh, os.path.join(tmp, "dp"),
                                    False)
        res["train_ef"] = _trainer_run(dp_mesh, os.path.join(tmp, "ef"),
                                       True)
    dist.barrier()
    return res


def _worker(rank: int, worlds, inits, tmp: str, queue) -> None:
    """Run the cases of each world size in turn: one group of every
    spawned process first, then one of the first ranks alone, and so on
    (one spawn serves every group)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        flat, calib = pickle.load(f)
    for world, init in zip(worlds, inits):
        if rank >= world:
            return
        try:
            dist.init_process_group("gloo", init_method=init, rank=rank,
                                    world_size=world)
            queue.put((world, _cases(rank, world, flat, calib,
                                     os.path.join(tmp, str(world)))))
        except BaseException:                   # the test reports it
            queue.put((world, {"rank": rank,
                               "error": traceback.format_exc()}))
            return
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


def run_groups(worlds, flat, calib, timeout: float = 300.0):
    """Spawn ``max(worlds)`` ranks once and run every case in a group of
    each size of ``worlds`` (largest first; a ``file://`` rendezvous in a
    temporary directory each); returns {world: results in rank order}."""
    worlds = sorted(worlds, reverse=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        # the inputs go by file: a start() blocks while its child reads
        # its arguments, which it does only after importing torch
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump((flat, calib), f)
        inits = ["file://" + os.path.join(tmp, f"rendezvous{w}")
                 for w in worlds]
        procs = [ctx.Process(target=_worker,
                             args=(r, worlds, inits, tmp, queue))
                 for r in range(worlds[0])]
        for p in procs:
            p.start()
        out: dict = {w: [] for w in worlds}
        try:
            for _ in range(sum(worlds)):
                world, res = queue.get(timeout=timeout)
                out[world].append(res)
                if "error" in res:
                    raise RuntimeError(res["error"])
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
    return {w: sorted(rs, key=lambda r: r["rank"]) for w, rs in out.items()}
