"""The rank side of tests/test_torch_fsdp_train.py and
tests/test_torch_tp_train.py: one process of a ``gloo`` group on the
CPU, spawned by ``torch_dist_worker.run_groups(..., cases=
"torch_train_worker:fsdp_cases")`` (or ``tp_train_cases``).  It imports
only ``torch`` and the port (no jax); the test process holds its results
against the port's one-device trainer and the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import torch

TRAIN_STEPS = 3
BATCH, SEQ = 8, 32
# the FSDP trainer's runs on paper_tiny_lm SMOKE: name → Trainer knobs
FSDP_RUNS = {"plain": {}, "ef": dict(grad_compression=True),
             "mb2": dict(microbatches=2), "replicated": dict(fsdp_axes=())}
MOE_ARCH = "phi3_5_moe_42b_a6_6b"
# the tensor-parallel trainer's models: name → (arch, config overrides);
# "straddle" has 6 query / 3 KV heads of 16, so that at tp 2 a rank's 3
# query heads straddle two KV groups (models.layers.attn_heads)
TP_MODELS = {
    "paper_tiny_lm": ("paper_tiny_lm", {}),
    "qwen1_5_0_5b": ("qwen1_5_0_5b", {}),
    "gemma_2b": ("gemma_2b", {}),
    "qwen3_14b": ("qwen3_14b", {}),
    "gemma3_12b": ("gemma3_12b", {}),
    "straddle": ("paper_tiny_lm",
                 dict(num_heads=6, num_kv_heads=3, head_dim=16)),
}
# families that train under a model axis of 1 only (for now)
TP_REFUSED = ("xlstm_350m", "jamba_1_5_large_398b", MOE_ARCH,
              "paligemma_3b")
# the shard / gather identity: a dense decoder and the tiny Mamba LM
# (its in_proj's x | z halves)
IDENTITY_ARCHS = ("qwen3_14b", "paper-tiny-mamba")


def arch_config(arch: str, over=None):
    """The port's SMOKE config of ``arch`` (or the tiny Mamba LM), with
    ``over`` replaced."""
    from repro_torch import configs
    from repro_torch.configs import paper_tiny_lm

    cfg = (paper_tiny_lm.MAMBA if arch == "paper-tiny-mamba"
           else configs.get_smoke(arch))
    return dataclasses.replace(cfg, **(over or {}))


def tp_config(name: str):
    arch, over = TP_MODELS[name]
    return arch_config(arch, over)


def make_trainer(cfg, mesh, out: str, *, steps: int = TRAIN_STEPS,
                 fsdp_axes=None, grad_compression: bool = False,
                 microbatches: int = 1, ckpt_every: int = TRAIN_STEPS):
    """The tests' trainer: AdamW with bf16 moments on warmup_cosine(1e-3,
    2, steps), a global batch of BATCH × SEQ, every step logged."""
    from repro_torch.data import DataPipeline
    from repro_torch.models.transformer import LM
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainConfig, Trainer

    return Trainer(
        LM(cfg, device="cpu"),
        AdamW(lr=warmup_cosine(1e-3, 2, steps), moment_dtype="bfloat16"),
        DataPipeline(cfg, BATCH, SEQ, seed=0, mesh=mesh),
        TrainConfig(total_steps=steps, global_batch=BATCH, seq_len=SEQ,
                    ckpt_every=ckpt_every, out_dir=out, log_every=1,
                    microbatches=microbatches,
                    grad_compression=grad_compression),
        mesh=mesh, fsdp_axes=fsdp_axes)


def train_run(cfg, mesh, out: str, max_steps=None, **kw) -> dict:
    """A trainer's run: its whole params (flat, the reference's leaves),
    every step's loss, the logged records (rank 0's metrics.jsonl) and
    the bytes of params and moments this rank held."""
    from repro_torch.dist import comm

    trainer = make_trainer(cfg, mesh, out, **kw)
    params, opt_state, info = trainer.run(max_steps)
    params, _, _ = trainer.gather_state(params, opt_state)
    records = None
    if comm.is_main_rank():
        with open(os.path.join(out, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    return dict(flat=trainer.model.params_to_flat(params),
                losses=info["losses"], records=records,
                bytes=info["rank_state_bytes"])


def one_step_grads(cfg, mesh, out: str) -> dict:
    """The first step's gradients as the update takes them, gathered
    whole (the reference's leaves), and the step's loss."""
    trainer = make_trainer(cfg, mesh, out)
    params, _, _ = trainer.init_state()
    with trainer._context():
        loss, _, grads = trainer._step_fn.reduced_grads(
            params, trainer.pipeline.batch_at(0))
    if trainer.layout is not None:
        grads = trainer.layout.gather(grads)
    return dict(flat=trainer.model.params_to_flat(grads), loss=float(loss))


def save_alive(cfg, mesh, out: str) -> dict:
    """The bytes of gathered leaves that a rank holds at once while the
    trainer writes a checkpoint (a leaf at a time, kept on rank 0's host
    only) and while ``gather_state`` makes the state whole on every
    rank: the most that earlier gathers (``comm.all_gather_dim``) left
    alive when one began; and the largest whole leaf."""
    import weakref

    from repro_torch.dist import comm
    from repro_torch.optim import tree_leaves

    trainer = make_trainer(cfg, mesh, out)
    params, opt_state, ef_state = trainer.init_state()
    gather, alive, most = comm.all_gather_dim, [], [0]

    def tracked(t, group, dim):
        held = [r() for r in alive]
        most[0] = max(most[0], sum(x.numel() * x.element_size()
                                   for x in held if x is not None))
        whole = gather(t, group, dim)
        alive.append(weakref.ref(whole))
        return whole

    comm.all_gather_dim = tracked
    try:
        trainer._save(0, params, opt_state, ef_state)
        saving, most[0] = most[0], 0
        alive.clear()
        whole, _, _ = trainer.gather_state(params, opt_state)
        gathering = most[0]
    finally:
        comm.all_gather_dim = gather
    return dict(saving=saving, gathering=gathering,
                leaf=max(t.numel() * t.element_size()
                         for t in tree_leaves(whole)))


def state_bytes(cfg) -> int:
    """One device's bytes of params and moments (bf16) of ``cfg``."""
    from repro_torch import random as rnd
    from repro_torch.models.transformer import LM
    from repro_torch.optim import tree_leaves

    params = LM(cfg, device="cpu").init(rnd.key(0, torch.device("cpu")))
    return sum(t.numel() * (t.element_size() + 4)
               for t in tree_leaves(params))


def _identity(mesh) -> dict:
    """shard_params (FSDP over data, blocks over model) then
    gather_params: {arch: (bit-equal, leaves split)}."""
    from repro_torch.dist.sharding import (fsdp_shard, gather_params,
                                           model_shard, param_rules,
                                           shard_params)
    from repro_torch.models.transformer import LM
    from repro_torch.optim import tree_leaves

    out = {}
    for arch in IDENTITY_ARCHS:
        cfg = arch_config(arch)
        params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        rules = param_rules(params, cfg, model_shard(mesh).count,
                            fsdp_shard(mesh, ("data",)).count)
        blocks = shard_params(params, mesh, cfg=cfg, fsdp_axes=("data",))
        back = gather_params(blocks, rules, mesh, fsdp_axes=("data",))
        pairs = list(zip(tree_leaves(params), tree_leaves(blocks),
                         tree_leaves(back)))
        out[arch] = (all(torch.equal(a, c) for a, _, c in pairs),
                     sum(a.shape != b.shape for a, b, _ in pairs))
    return out


def fsdp_cases(rank: int, world: int, args, _, tmp: str) -> dict:
    """2x1 (world 2) or 2x2 (world 4): paper_tiny_lm SMOKE's FSDP runs
    (FSDP_RUNS), the shard / gather identity, the gathered bytes a
    checkpoint holds at once (:func:`save_alive`); on 2x1 also
    phi3.5-moe SMOKE's FSDP trainer ((loss, aux) a step)."""
    import torch.distributed as dist

    from repro_torch.dist import mesh_from_spec

    spec = "2x1" if world == 2 else "2x2"
    mesh = mesh_from_spec(spec, device="cpu")
    res: dict = {"rank": rank, "spec": spec, "identity": _identity(mesh)}
    cfg = arch_config("paper_tiny_lm")
    res["save_alive"] = save_alive(cfg, mesh, os.path.join(tmp, "alive"))
    res["resolve"] = tuple(
        make_trainer(cfg, mesh, os.path.join(tmp, "resolve"),
                     **kw).fsdp_axes for kw in ({}, dict(fsdp_axes=())))
    for name, kw in FSDP_RUNS.items():
        res[name] = train_run(cfg, mesh, os.path.join(tmp, name), **kw)
    if world == 2:
        run = train_run(arch_config(MOE_ARCH), mesh, os.path.join(tmp, "moe"))
        res["moe"] = dict(
            bytes=run["bytes"], losses=run["losses"],
            records=None if run["records"] is None else
            [(r["loss"], r["aux"]) for r in run["records"]])
    dist.barrier()
    return res


def tp_train_cases(rank: int, world: int, args, _, tmp: str) -> dict:
    """1x2 (world 2) or 2x2 (world 4): each TP_MODELS config's first
    step's gradients and its TRAIN_STEPS steps; on 2x2 each rank's rows
    of a batch; on 1x2 the refusals of TP_REFUSED and the resume — a
    paper_tiny_lm run on 2x1 with FSDP saved after step 2 (into
    ``args["out"]``, kept for the test) resumed on 1x2, on 2x1 and (rank
    0) on one device."""
    import torch.distributed as dist

    from repro_torch.data import DataPipeline
    from repro_torch.dist import comm, mesh_from_spec

    spec = "1x2" if world == 2 else "2x2"
    mesh = mesh_from_spec(spec, device="cpu")
    res: dict = {"rank": rank, "spec": spec}
    for name in TP_MODELS:
        cfg = tp_config(name)
        res[name] = dict(grads=one_step_grads(cfg, mesh, tmp),
                         train=train_run(cfg, mesh,
                                         os.path.join(tmp, name)))
    if world == 4:
        pipe = DataPipeline(arch_config("paper_tiny_lm"), BATCH, SEQ,
                            seed=0, mesh=mesh)
        res["rows"] = pipe.batch_at(0)["tokens"].numpy()
        dist.barrier()
        return res
    res["refused"] = {}
    for arch in TP_REFUSED:
        try:
            make_trainer(arch_config(arch), mesh, os.path.join(tmp, "no"))
            res["refused"][arch] = None
        except ValueError as e:
            res["refused"][arch] = str(e)
    # the resume: 2x1 with FSDP, saved after step 2
    cfg = arch_config("paper_tiny_lm")
    dp = mesh_from_spec("2x1", device="cpu")
    saved = os.path.join(args["out"], "saved")
    res["uninterrupted"] = train_run(cfg, dp, os.path.join(tmp, "whole"))
    res["first_part"] = train_run(cfg, dp, saved, max_steps=2)
    if comm.is_main_rank():
        for name in ("on_1x2", "on_2x1", "on_one"):
            shutil.copytree(saved, os.path.join(args["out"], name))
    comm.barrier()
    res["on_1x2"] = train_run(cfg, mesh, os.path.join(args["out"], "on_1x2"))
    res["on_2x1"] = train_run(cfg, dp, os.path.join(args["out"], "on_2x1"))
    if comm.is_main_rank():
        res["on_one"] = train_run(cfg, None,
                                  os.path.join(args["out"], "on_one"))
    dist.barrier()
    return res


def jax_one_step_grads(name: str) -> dict:
    """The JAX package's first-step gradients of TP_MODELS' ``name`` (in
    the test process: it imports jax): ``jax.value_and_grad`` of its
    ``LM.loss_fn`` — what its single-device trainer's step differentiates
    — at the keyed init of key 0, on its pipeline's batch 0; flat (the
    checkpoint's paths), and the loss."""
    import jax
    import numpy as np

    from repro.ckpt.store import _flatten
    from repro.configs import get_smoke
    from repro.data import DataPipeline
    from repro.models import LM

    arch, over = TP_MODELS[name]
    with jax.threefry_partitionable(True):
        model = LM(dataclasses.replace(get_smoke(arch), **over))
        params = model.init(jax.random.key(0))
        batch = DataPipeline(model.cfg, BATCH, SEQ, seed=0).batch_at(0)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.loss_fn, has_aux=True))(params, batch)
    return dict(flat={k: np.asarray(v) for k, v in _flatten(grads).items()},
                loss=float(loss))


def jax_trainer_run(out, cfg_name: str = "paper_tiny_lm", over=None, **kw):
    """The JAX package's single-device trainer with :func:`make_trainer`'s
    knobs (in the test process: it imports jax): its params' leaves (the
    checkpoint's paths) and its logged records."""
    import jax
    import numpy as np

    from repro.ckpt.store import _flatten
    from repro.configs import get_smoke
    from repro.data import DataPipeline
    from repro.models import LM
    from repro.optim import AdamW
    from repro.optim.schedules import warmup_cosine
    from repro.train import TrainConfig, Trainer

    with jax.threefry_partitionable(True):
        jcfg = dataclasses.replace(get_smoke(cfg_name), **(over or {}))
        jt = Trainer(LM(jcfg), AdamW(lr=warmup_cosine(1e-3, 2, TRAIN_STEPS),
                                     moment_dtype="bfloat16"),
                     DataPipeline(jcfg, BATCH, SEQ, seed=0),
                     TrainConfig(total_steps=TRAIN_STEPS, global_batch=BATCH,
                                 seq_len=SEQ, ckpt_every=TRAIN_STEPS,
                                 out_dir=str(out), log_every=1, **kw))
        jparams, _, _ = jt.run()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return {k: np.asarray(v) for k, v in _flatten(jparams).items()}, records
