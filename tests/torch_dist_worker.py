"""The rank side of tests/test_torch_dist.py and the tensor-parallel
serving tests: one process of a ``gloo`` group on the CPU, spawned with
:func:`run_groups`.  It imports only ``torch`` and the port (no jax),
runs every distributed case of its world size — the prune / train cases
(:func:`_cases`), the tensor-parallel serving ones (:func:`_tp_cases`,
:func:`_fam_cases`, :func:`_front_cases`), the router's under a mesh
(:func:`_server_cases`) or the 2x4 shared-prefix case
(:func:`_prefix_cases`, for tests/test_torch_prefix_cache.py) — and
sends its results back to the test process, which holds them against
the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
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
    params, opt_state, info = trainer.run()
    params, _, _ = trainer.gather_state(params, opt_state)
    return model.params_to_flat(params), info["first_loss"], info[
        "last_loss"]


MOE_ARCH = "phi3.5-moe-42b-a6.6b"


def _moe_trainer_run(mesh, out: str):
    """phi3.5-moe SMOKE, TRAIN_STEPS steps of a global batch of 8 × 32,
    data-parallel over ``mesh`` (None: one rank): the logged (loss, aux)
    of every step."""
    from repro_torch import configs
    from repro_torch.data import DataPipeline
    from repro_torch.models.transformer import LM
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train import TrainConfig, Trainer

    cfg = configs.get_smoke(MOE_ARCH)
    trainer = Trainer(
        LM(cfg, device="cpu"),
        AdamW(lr=warmup_cosine(1e-3, 2, TRAIN_STEPS),
              moment_dtype="bfloat16"),
        DataPipeline(cfg, 8, 32, seed=0, mesh=mesh),
        TrainConfig(total_steps=TRAIN_STEPS, global_batch=8, seq_len=32,
                    ckpt_every=TRAIN_STEPS, out_dir=out, log_every=1),
        mesh=mesh)
    trainer.run()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [(r["loss"], r["aux"]) for r in map(json.loads, f)]


def moe_engine_run(flat, mesh=None, calib_shard="auto"):
    """phi3.5-moe SMOKE with the reference's params ``flat`` through the
    pipelined pruning engine on two calibration batches of 8 × 32, under
    ``mesh``'s context (None: one rank).  On 2x1 ``"auto"`` gives each
    rank one batch as its shard; ``"off"`` has every rank calibrate on
    both batches as one shard."""
    from repro_torch import configs
    from repro_torch.data import calibration_batches
    from repro_torch.dist import use_mesh
    from repro_torch.models.transformer import LM

    cfg = configs.get_smoke(MOE_ARCH)
    model = LM(cfg, device="cpu")
    params = model.params_from_jax(flat)
    calib = calibration_batches(cfg, n_samples=16, seq_len=32, batch=8)
    with (use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        return _engine_run(model, params, calib, None,
                           calib_shard=calib_shard)


def _moe_replicated(flat, mesh):
    """phi3.5-moe SMOKE's first MoE layer on the same 5 tokens on every
    rank (5 tokens: capacity 4, and 7 if the copies were routed as one
    batch of 10), under ``mesh``'s context and under none: (y, aux) of
    each."""
    from repro_torch import configs
    from repro_torch.dist import use_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import LM

    cfg = configs.get_smoke(MOE_ARCH)
    p = LM(cfg, device="cpu").params_from_jax(flat)["layers"][0]["moe"]
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 5, cfg.d_model)).astype(np.float32))
    with use_mesh(mesh):
        y, aux = moe.moe_apply(p, h, cfg)
    y1, aux1 = moe.moe_apply(p, h, cfg)
    return (y.numpy(), float(aux)), (y1.numpy(), float(aux1))


def _cases(rank: int, world: int, flats, calib, tmp: str) -> dict:
    """``flats``: the reference's params of the engine cases' model
    (``"tiny"``) and of phi3.5-moe SMOKE (``"moe"``)."""
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
    params = model.params_from_jax(flats["tiny"])
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
        # the trainer's MoE routes the global batch; the calibration
        # shards route each its own
        res["train_moe"] = _moe_trainer_run(dp_mesh,
                                            os.path.join(tmp, "moe"))
        res["moe_replicated"] = _moe_replicated(flats["moe"], dp_mesh)
        res["engine_moe_dp"] = moe_engine_run(flats["moe"], dp_mesh)
        res["engine_moe_off"] = moe_engine_run(flats["moe"], dp_mesh,
                                               calib_shard="off")
    dist.barrier()
    return res


# ----------------------------------------------------------------------
# tensor-parallel serving (tests/test_torch_tp_serve.py)
# ----------------------------------------------------------------------
# name → (arch, config overrides): 4 query / 2 KV heads (whole KV heads a
# rank at tp 2), 4 / 1 (the KV head kept whole), 2 / 2, and 6 / 3 — a
# rank's 3 query heads straddle two KV groups, so its attention runs on
# every head (models.layers.attn_heads)
TP_MODELS = {
    "qwen3-14b": ("qwen3-14b", {}),
    "gemma-2b": ("gemma-2b", {}),
    "paper_tiny_lm": ("paper_tiny_lm", {}),
    "straddle": ("paper_tiny_lm",
                 dict(num_heads=6, num_kv_heads=3, head_dim=16)),
}
TP_BASE = dict(max_batch=3, max_len=64, page_size=8)
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9)
# the reference's runs: its static greedy run stands for every greedy
# mode of the port (a row's greedy stream depends on neither its batch
# nor the cache: the reference's tests/test_serve_paged.py)
TP_REFS = {"greedy": dict(mode="static"),
           "greedy_int8": dict(prefill_chunk=16, kv_dtype="int8"),
           "sampled": dict(prefill_chunk=16, **SAMPLED),
           "sampled_static": dict(mode="static", max_batch=2, **SAMPLED)}
TP_MODES = {          # the port's knobs, the reference run they equal
    "continuous": (dict(prefill_chunk=8), "greedy"),     # prefix cache on
    "starved": (dict(prefill_chunk=16, num_pages=9), "greedy"),   # swap
    "int8": (dict(prefill_chunk=16, kv_dtype="int8"), "greedy_int8"),
    # two rows a bucket: split over the data axis of a 2x2 mesh
    "static": (dict(mode="static", max_batch=2), "greedy"),
    "sampled": (dict(prefill_chunk=16, **SAMPLED), "sampled"),
    "sampled_static": (TP_REFS["sampled_static"], "sampled_static"),
}
STRADDLE_MODES = ("continuous", "static")
LOGIT_TOKENS = 12          # prompt length of the logits case
DECODE_TOKENS = (3, 7)     # the token each row decodes next


def tp_config(name: str):
    from repro_torch import configs

    arch, over = TP_MODELS[name]
    return dataclasses.replace(configs.get_smoke(arch), **over)


def tp_modes(name: str):
    return STRADDLE_MODES if name == "straddle" else tuple(TP_MODES)


def tp_requests():
    """Six 29-token prompts (ragged at chunk 8 and 16); requests 0, 2, 4
    share their first 16 tokens, two full pages, which the later ones
    attach from the prefix index; 4–9 new tokens each."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 256, size=16).astype(np.int32)
    out = []
    for u, m in enumerate((6, 9, 4, 7, 5, 8)):
        p = rng.integers(0, 256, size=29).astype(np.int32)
        if u % 2 == 0:
            p[:16] = shared
        out.append((u, p, m))
    return out


def logit_prompts():
    return np.random.default_rng(9).integers(
        0, 256, size=(2, LOGIT_TOKENS)).astype(np.int32)


def _tp_logits(model, params, mesh):
    """One dense prefill of two prompts and a decode step, and one paged
    chunk of the first prompt and a paged decode step: (B, V) logits."""
    from repro_torch.dist import use_mesh
    from repro_torch.dist.sharding import shard_params
    from repro_torch.serve.sparse import compressed_param_tree

    sp = shard_params(compressed_param_tree(params), mesh, cfg=model.cfg)
    toks = torch.from_numpy(logit_prompts())
    nxt = torch.tensor(DECODE_TOKENS, dtype=torch.int32)
    with use_mesh(mesh):
        cache = model.init_cache(2, 32)
        pre = model.prefill(sp, toks, cache)
        dec = model.decode_step(sp, nxt, cache, LOGIT_TOKENS)
        kv = model.init_paged_cache(8, 8)
        bt = torch.tensor([[1, 2, 3]], dtype=torch.int32)
        chunk = torch.zeros((1, 16), dtype=torch.int32)
        chunk[0, :LOGIT_TOKENS] = toks[0]
        pre_p = model.prefill_chunk(sp, chunk, kv, 0, LOGIT_TOKENS, bt,
                                    page_size=8)
        dec_p = model.decode_step(sp, nxt[:1], kv,
                                  torch.tensor([LOGIT_TOKENS],
                                               dtype=torch.int32), bt,
                                  page_size=8)
    return {k: v.numpy() for k, v in (("prefill", pre), ("decode", dec),
                                      ("prefill_paged", pre_p),
                                      ("decode_paged", dec_p))}


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _tp_layout(mesh):
    """Qwen1.5-0.5B SMOKE, magnitude 2:4, packed, then sharded as the
    engine shards it: the rank's and the whole tree's bytes, and whether
    every split leaf is a fresh contiguous tensor."""
    from repro_torch import configs
    from repro_torch import random as rnd
    from repro_torch.core.pruner import prune_linears
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sparse import compressed_param_tree

    model = LM(configs.get_smoke("qwen1.5-0.5b"), device="cpu")
    packed = compressed_param_tree(prune_linears(model.init(rnd.key(0)),
                                                 "2:4"))
    eng = ServeEngine(model, packed, mesh=mesh, **TP_BASE)
    whole_storage = {t.untyped_storage().data_ptr()
                     for t in _leaves(packed)}
    split = [t for t, w in zip(_leaves(eng.params), _leaves(packed))
             if t.shape != w.shape]
    return {"rank_bytes": _tree_bytes(eng.params),
            "whole_bytes": _tree_bytes(packed), "split": len(split),
            "fresh": all(t.is_contiguous() and t.untyped_storage().data_ptr()
                         not in whole_storage for t in split),
            "wq": tuple(eng.params["layers"][0]["attn"]["wq"]["vals"].shape),
            "wo": tuple(eng.params["layers"][0]["mlp"]["wo"]["vals"].shape),
            "tok": tuple(eng.params["embed"]["tok"].shape)}


def _cli(argv):
    """``launch.serve.main(argv)``'s standard output (and the message of
    the SystemExit it raised, if any)."""
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            serve.main(argv)
        except SystemExit as e:
            return buf.getvalue(), str(e)
    return buf.getvalue(), None


CLI_ARGS = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
            "--magnitude-24", "--sparse", "--requests", "3", "--max-new",
            "4"]
CLI_CASES = {"qwen3-14b": CLI_ARGS,
             "xlstm-350m": ["--arch", "xlstm-350m", "--smoke", "--device",
                            "cpu", "--requests", "3", "--max-new", "4"]}


def _tp_bits(mesh):
    """An all-reduce (f32 and bf16) and an all-gather over the model axis
    of rank-dependent inputs: what each rank holds after them."""
    from repro_torch.dist import comm

    group = comm.group_of(mesh, "model")
    g = torch.Generator().manual_seed(100 + comm.rank(None))
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        t = torch.randn(1000, generator=g).to(dt)
        out[str(dt)] = comm.all_reduce_(t, group).float().numpy()
    out["gather"] = comm.all_gather_last(
        torch.randn(3, 5, generator=g), group).numpy()
    return out


def _tp_schedule(mesh, rank: int, model, params):
    """The schedule under a mesh: a hard deadline already past (rank 0's
    clock decides it for every rank) and ranks handed different prompts
    (the burst plans' digests differ: every rank raises before the
    burst's collectives)."""
    import time

    from repro_torch.serve.engine import Request, ServeEngine

    reqs = [Request(uid=u, prompt=p, max_new_tokens=m)
            for u, p, m in tp_requests()]
    reqs[1].deadline = time.monotonic() - (1.0 if rank == 0 else -60.0)
    reqs[1].deadline_hard = True
    eng = ServeEngine(model, params, mesh=mesh, **TP_BASE)
    out = {"deadline": [r.tokens.tolist() for r in eng.generate(reqs)],
           "timeouts": eng.stats["deadline_exceeded"]}
    reqs = [Request(uid=u, prompt=p[:10 + rank], max_new_tokens=m)
            for u, p, m in tp_requests()]
    try:
        eng.generate(reqs)
        out["parted"] = None
    except RuntimeError as e:
        out["parted"] = str(e)
    return out


def _tp_cases(rank: int, world: int, flats, _, tmp: str) -> dict:
    import torch.distributed as dist

    from repro_torch.dist import mesh_from_spec
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine

    mesh = mesh_from_spec("1x2" if world == 2 else "2x2", device="cpu")
    res: dict = {"rank": rank, "streams": {}, "stats": {}, "logits": {}}
    reqs = [Request(uid=u, prompt=p, max_new_tokens=m)
            for u, p, m in tp_requests()]
    for name in TP_MODELS:
        model = LM(tp_config(name), device="cpu")
        params = model.params_from_jax(flats[name])
        for mode in tp_modes(name):
            eng = ServeEngine(model, params, mesh=mesh,
                              **{**TP_BASE, **TP_MODES[mode][0]})
            got = eng.generate(reqs, seed=7)
            res["streams"][name, mode] = [r.tokens.tolist() for r in got]
            res["stats"][name, mode] = {
                k: eng.stats[k] for k in ("prefix_hit_tokens",
                                          "preempt_swap",
                                          "preempt_recompute")}
        res["logits"][name] = _tp_logits(model, params, mesh)
    res["bits"] = _tp_bits(mesh)
    if world == 2:
        res["schedule"] = _tp_schedule(mesh, rank, model, params)
        res["layout"] = _tp_layout(mesh)
        res["cli"] = {arch: _cli(argv + ["--mesh", "1x2"])
                      for arch, argv in CLI_CASES.items()}
    dist.barrier()
    return res


# ----------------------------------------------------------------------
# tensor-parallel serving of the recurrent and expert families
# (tests/test_torch_tp_serve_families.py)
# ----------------------------------------------------------------------
# name → (arch, config overrides); "mamba" is paper_tiny_lm.MAMBA, which
# is in neither registry
FAM_MODELS = {
    "mamba": ("paper-tiny-mamba", {}),
    "jamba": ("jamba-1.5-large-398b", dict(moe=None, moe_slots=())),
    "xlstm": ("xlstm-350m", {}),
    "phi": ("phi3.5-moe-42b-a6.6b", {}),
    "kimi": ("kimi-k2-1t-a32b", {}),
    "jamba_moe": ("jamba-1.5-large-398b", {}),
    # twins whose recurrent blocks do not split over a model axis of 2:
    # d_inner 63 (Mamba whole beside a split attention and MLP) and 3
    # heads (the mLSTM and the sLSTM whole, though d_model divides)
    "jamba_whole": ("jamba-1.5-large-398b",
                    dict(moe=None, moe_slots=(), d_model=63, ssm_expand=1)),
    "xlstm_whole": ("xlstm-350m",
                    dict(d_model=48, num_heads=3, num_kv_heads=3)),
}
FAM_MOE = ("phi", "kimi", "jamba_moe")
# served unpruned and dense: d_model 63 has no groups of 4 inputs
FAM_DENSE = ("jamba_whole",)
# the reference's runs: its static greedy run stands for every greedy
# mode (a row's greedy stream depends on neither its batch nor the
# cache); "greedy_rows", buckets of one row, is what a 2x2 mesh's data
# ranks route when a MoE's two-row bucket splits over data (each rank's
# rows are one token block, routed on its own)
FAM_REFS = {"greedy": dict(mode="static", max_batch=2),
            "greedy_rows": dict(mode="static", max_batch=1),
            "sampled_static": dict(mode="static", max_batch=2, **SAMPLED)}
FAM_MODES = {        # the port's knobs, the reference run they equal
    "continuous": dict(prefill_chunk=8),
    "starved": dict(prefill_chunk=8, num_pages=9),       # recompute
    "static": dict(mode="static", max_batch=2),
    "sampled_static": FAM_REFS["sampled_static"],
}
FAM_MOE_ROWS = ((3, 10), (3, 5))     # (B, T) every rank holds: 30 tokens
#                                      in two blocks of 15 on 2x2 (row 1
#                                      cut), 15 in one (odd)
FAM_MOE_SPLIT = (4, 6)               # a batch whose rows split over data


def fam_config(name: str):
    from repro_torch import configs
    from repro_torch.configs import paper_tiny_lm

    arch, over = FAM_MODELS[name]
    if name == "mamba":
        return paper_tiny_lm.MAMBA
    return dataclasses.replace(configs.get_smoke(arch), **over)


def fam_modes(name: str, world: int):
    """The modes of ``name`` on a group of ``world`` ranks: a MoE serves
    static; sampled static on phi3.5 and 1x2 only (a 2x2 mesh's data
    ranks route their rows alone, and no one-device run draws a two-row
    bucket's noise over one-row routes)."""
    if name in FAM_MOE:
        return ("static", "sampled_static") if (
            name == "phi" and world == 2) else ("static",)
    return {"mamba": ("continuous", "static"),
            "jamba": ("continuous", "starved", "static"),
            "xlstm": ("continuous", "static"),
            "jamba_whole": ("continuous",),
            "xlstm_whole": ("continuous",)}[name]


def fam_ref(name: str, mode: str, world: int) -> str:
    """The reference run a mode's streams equal."""
    if mode == "sampled_static":
        return "sampled_static"
    return "greedy_rows" if name in FAM_MOE and world == 4 else "greedy"


def fam_pack(model, params):
    """The 2:4-pruned linears packed: the attention's, the MLP's, the
    shared expert's and the recurrent blocks' (the defaults leave those
    dense)."""
    from repro_torch.serve.sparse import (DEFAULT_SPARSE_PATTERNS,
                                          compressed_param_tree,
                                          linear_patterns)

    return compressed_param_tree(params, DEFAULT_SPARSE_PATTERNS
                                 + linear_patterns(model.block_linears()))


def _fam_logits(model, params, mesh):
    """As :func:`_tp_logits`, with the rank's state rows: a dense prefill
    of two prompts and a decode step, and for a model that serves paged
    one chunk of the first prompt into slot 0 and a paged decode step."""
    from repro_torch.dist import use_mesh
    from repro_torch.dist.sharding import shard_params
    from repro_torch.serve.engine import effective_mode

    sp = shard_params(params, mesh, cfg=model.cfg)
    toks = torch.from_numpy(logit_prompts())
    nxt = torch.tensor(DECODE_TOKENS, dtype=torch.int32)
    out = {}
    with use_mesh(mesh):
        cache = model.init_cache(2, 32)
        out["prefill"] = model.prefill(sp, toks, cache)
        out["decode"] = model.decode_step(sp, nxt, cache, LOGIT_TOKENS)
        if effective_mode(model.cfg, "continuous") == "continuous":
            kv = model.init_paged_cache(8, 8, max_slots=1)
            bt = torch.tensor([[1, 2, 3]], dtype=torch.int32)
            chunk = torch.zeros((1, 16), dtype=torch.int32)
            chunk[0, :LOGIT_TOKENS] = toks[0]
            out["prefill_paged"] = model.prefill_chunk(
                sp, chunk, kv, 0, LOGIT_TOKENS, bt, page_size=8)
            out["decode_paged"] = model.decode_step(
                sp, nxt[:1], kv, torch.tensor([LOGIT_TOKENS],
                                              dtype=torch.int32), bt,
                page_size=8)
    return {k: v.numpy() for k, v in out.items()}


def _fam_widths(model, eng):
    """What a rank holds: each recurrent kind's state rows (the pool's,
    its StatePool's init rows and a dense cache's) and each MoE layer's
    expert count."""
    from repro_torch.dist import use_mesh

    out = {"state": {}, "init_rows": {}, "dense": {}, "experts": []}
    if eng.pool is not None:
        for kind, layer in zip(model.kinds, eng.pool.kv):
            if kind in model.STATE_KINDS:
                out["state"][kind] = {k: tuple(t.shape[1:])
                                      for k, t in layer.items()}
        kinds = [k for k in model.kinds if k in model.STATE_KINDS]
        for kind, rows in zip(kinds, eng.state_pool.init_rows):
            out["init_rows"][kind] = {k: tuple(t.shape[1:])
                                      for k, t in rows.items()}
    with use_mesh(eng.mesh):
        for kind, layer in zip(model.kinds, model.init_cache(1, 8)):
            if kind in model.STATE_KINDS:
                out["dense"][kind] = {k: tuple(t.shape[1:])
                                      for k, t in layer.items()}
    out["experts"] = [tuple(b["moe"]["wi"].shape) for b in eng.params[
        "layers"] if "moe" in b]
    return out


def fam_moe_inputs():
    """The MoE layer's inputs: a (B, T, D) hidden of each FAM_MOE_ROWS
    shape and of FAM_MOE_SPLIT, phi3.5 SMOKE's width.  Every token shares
    one large direction, so the router sends most tokens to the same
    experts and their capacity drops tokens — where a block routed on
    its own drops other tokens than the whole call would."""
    rng = np.random.default_rng(11)
    common = 3.0 * rng.standard_normal(64)
    return [(rng.standard_normal((b, t, 64)) + common).astype(np.float32)
            for b, t in (*FAM_MOE_ROWS, FAM_MOE_SPLIT)]


def _fam_moe_layer(model, params, mesh):
    """phi3.5 SMOKE's first MoE layer, the rank's experts, on rows every
    rank holds (FAM_MOE_ROWS) and on a batch split over data (each data
    rank its rows): the layer's output."""
    from repro_torch.dist import use_mesh
    from repro_torch.dist.sharding import batch_sharding, shard_params
    from repro_torch.models import moe

    p = shard_params(params, mesh, cfg=model.cfg)["layers"][0]["moe"]
    *rows, split = [torch.from_numpy(h) for h in fam_moe_inputs()]
    out = {}
    with use_mesh(mesh):
        for h in rows:
            out[tuple(h.shape[:2])] = moe.moe_apply(p, h, model.cfg)[0]
    mine = batch_sharding(mesh).rows(split.shape[0])
    with use_mesh(mesh, split_rows=True):
        out["split"] = moe.moe_apply(p, split[mine], model.cfg)[0]
    out["split_rows"] = (mine.start, mine.stop)
    return {k: v if isinstance(v, tuple) else v.numpy()
            for k, v in out.items()}


def _fam_serve(model, params, mesh, modes, reqs, res, name):
    from repro_torch.serve.engine import ServeEngine

    for mode in modes:
        eng = ServeEngine(model, params, mesh=mesh,
                          **{**TP_BASE, **FAM_MODES[mode]})
        got = eng.generate(reqs, seed=7)
        res["streams"][name, mode] = [r.tokens.tolist() for r in got]
        res["stats"][name, mode] = {
            k: eng.stats[k] for k in ("prefix_hit_tokens", "preempt_swap",
                                      "preempt_recompute")}
        if (name, "widths") not in res["stats"]:
            res["stats"][name, "widths"] = _fam_widths(model, eng)
    res["logits"][name] = _fam_logits(model, params, mesh)


def _fam_cases(rank: int, world: int, flats, _, tmp: str) -> dict:
    """Every family on 1x2 (world 2) or 2x2 (world 4); on 4 ranks the
    xLSTM also on 1x4 (one head a rank)."""
    import torch.distributed as dist

    from repro_torch.dist import mesh_from_spec
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request

    mesh = mesh_from_spec("1x2" if world == 2 else "2x2", device="cpu")
    res: dict = {"rank": rank, "streams": {}, "stats": {}, "logits": {}}
    reqs = [Request(uid=u, prompt=p, max_new_tokens=m)
            for u, p, m in tp_requests()]
    for name in FAM_MODELS:
        model = LM(fam_config(name), device="cpu")
        params = model.params_from_jax(flats[name])
        if name not in FAM_DENSE:
            params = fam_pack(model, params)
        _fam_serve(model, params, mesh, fam_modes(name, world), reqs, res,
                   name)
        if name == "phi":
            res["moe_layer"] = _fam_moe_layer(model, params, mesh)
    if world == 4:
        model = LM(fam_config("xlstm"), device="cpu")
        params = fam_pack(model, model.params_from_jax(flats["xlstm"]))
        _fam_serve(model, params, mesh_from_spec("1x4", device="cpu"),
                   ("continuous",), reqs, res, "xlstm_1x4")
    dist.barrier()
    return res


# ----------------------------------------------------------------------
# tensor-parallel serving of the prefix-LM and the encoder-decoder
# (tests/test_torch_tp_serve_frontend.py)
# ----------------------------------------------------------------------
FRONT_ARCHS = ("paligemma_3b", "seamless_m4t_large_v2")
# tests/test_torch_mamba_serve.py's twin with leading prefix blocks (an
# attention and a Mamba block) before its attention periods
PREFIX_TWIN = dict(name="prefix-twin", family="hybrid", num_layers=4,
                   d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                   d_ff=128, vocab_size=256, period=("attn",),
                   prefix=("attn", "mamba"), mlp_kind="swiglu",
                   ssm_mlp=True, ssm_state=4, ssm_conv=4, dtype="float32")
# one static bucket of four rows: split over the data axis of a 2x2 mesh
FRONT_BASE = dict(max_batch=4, max_len=48)
PREFIX_MODES = {"static": dict(mode="static"),
                "continuous": dict(page_size=8, prefill_chunk=8)}
FRONT_LOGIT_LEN = 16                    # dense cache positions past F


def front_requests():
    """Four 7-token prompts (one bucket), 3-6 new tokens each."""
    rng = np.random.default_rng(5)
    return [(u, rng.integers(0, 256, size=7).astype(np.int32), m)
            for u, m in enumerate((6, 4, 5, 3))]


def front_feats(cfg, b=4, seed=6):
    """(b, F, fd) stub features, f32 by numpy from a seed."""
    rng = np.random.default_rng(seed)
    return (0.25 * rng.standard_normal(
        (b, cfg.frontend_len, cfg.frontend_dim))).astype(np.float32)


def front_offset(cfg) -> int:
    """Dense cache positions ahead of the text: the prefix-LM's frontend
    positions, none for the encoder-decoder."""
    return 0 if cfg.encdec else cfg.frontend_len


def _front_logits(model, params, mesh):
    """A dense prefill of two logit prompts with their features and one
    decode step (B, V); the encoder-decoder's cached cross K / V."""
    from repro_torch.dist import use_mesh
    from repro_torch.dist.sharding import shard_params
    from repro_torch.serve.sparse import compressed_param_tree

    cfg = model.cfg
    sp = shard_params(compressed_param_tree(params), mesh, cfg=cfg)
    toks = torch.from_numpy(logit_prompts())
    feats = torch.from_numpy(front_feats(cfg, b=2, seed=9))
    nxt = torch.tensor(DECODE_TOKENS, dtype=torch.int32)
    off = front_offset(cfg)
    with use_mesh(mesh):
        cache = model.init_cache(2, off + FRONT_LOGIT_LEN)
        out = {"prefill": model.prefill(sp, toks, cache,
                                        frontend_feats=feats),
               "decode": model.decode_step(sp, nxt, cache,
                                           off + LOGIT_TOKENS)}
    if cfg.encdec:
        out["xk"] = cache[0]["xk"]
    return {k: v.numpy() for k, v in out.items()}


def _front_cases(rank: int, world: int, flats, _, tmp: str) -> dict:
    """Both frontend models on 1x2 (world 2) or 2x2 (world 4): static
    streams with a feature row each, the logits; on 1x2 a rank's bytes
    and the prefix-block twin continuous and static."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.dist import mesh_from_spec
    from repro_torch.models.base import ArchConfig
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.sparse import compressed_param_tree

    mesh = mesh_from_spec("1x2" if world == 2 else "2x2", device="cpu")
    res: dict = {"rank": rank, "streams": {}, "logits": {}, "layout": {}}
    reqs = [Request(uid=u, prompt=p, max_new_tokens=m)
            for u, p, m in front_requests()]
    for arch in FRONT_ARCHS:
        model = LM(configs.get_smoke(arch), device="cpu")
        params = model.params_from_jax(flats[arch])
        feats = torch.from_numpy(front_feats(model.cfg))
        eng = ServeEngine(model, params, mesh=mesh,
                          extra_batch={"frontend_feats": feats},
                          **FRONT_BASE)
        res["streams"][arch] = [r.tokens.tolist()
                                for r in eng.generate(reqs)]
        res["logits"][arch] = _front_logits(model, params, mesh)
        if world == 2:
            whole = compressed_param_tree(params)
            res["layout"][arch] = {
                "rank_bytes": _tree_bytes(eng.params),
                "whole_bytes": _tree_bytes(whole),
                "frontend_proj": tuple(
                    eng.params["embed"]["frontend_proj"].shape)}
    if world == 2:
        model = LM(ArchConfig(**PREFIX_TWIN), device="cpu")
        params = model.params_from_jax(flats["prefix"])
        for mode, kw in PREFIX_MODES.items():
            eng = ServeEngine(model, params, mesh=mesh, **FRONT_BASE, **kw)
            res["streams"]["prefix", mode] = [r.tokens.tolist()
                                              for r in eng.generate(reqs)]
    dist.barrier()
    return res


# ----------------------------------------------------------------------
# the router, its replicas and the server under a mesh
# (tests/test_torch_tp_server.py)
# ----------------------------------------------------------------------
# the serve CLI's model: qwen3-14b SMOKE (4 query / 2 KV heads), seed-0
# weights, magnitude 2:4, packed; bursts of two steps, four slots
SERVER_ARGS = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
               "--magnitude-24", "--sparse", "--steps-per-sync", "2",
               "--max-batch", "4"]
SERVER_TIMEOUT_S = 3.0                 # the replicas' group timeout
DRAIN_MAX_NEW = 120                    # a request, each burst slowed,
DRAIN_TIMEOUT_S = 0.2                  # far longer than the drain waits


def server_requests(n=6, max_new=10):
    """``n`` six-token prompts, ``max_new`` greedy tokens each."""
    return [(u, [1 + u, 2, 3, 4 + u, 5, 6], max_new) for u in range(n)]


def one_device_streams(reqs, argv=SERVER_ARGS):
    """The CLI's model served on one device (no mesh, no router): the
    greedy streams of ``reqs`` ((uid, prompt, max new) triples)."""
    from repro_torch.launch import serve
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import Request, ServeEngine

    args = serve.build_parser().parse_args(argv)
    _, model, params = serve.load_model(args)
    eng = ServeEngine(model, params, ServeConfig.from_args(args))
    return [r.tokens.tolist() for r in eng.generate(
        [Request(uid=u, prompt=np.asarray(p, np.int32), max_new_tokens=m)
         for u, p, m in reqs])]


def _worker_death_mid_stream(mesh, rank: int) -> dict:
    """Two replicas under ``mesh``, the supervisor polling: eight
    requests through the router; once r0 has streamed a token of a
    request it still holds, a ``replica_worker`` death is armed on r0 —
    its next pass raises with requests in flight, the supervisor
    restarts it (mirrored to the followers as a restart op) and fails
    them over.  Rank 0: the streams and the recovery counters; the other
    ranks: their followers' steps."""
    import dataclasses as dc
    import threading
    import time

    from repro_torch.dist import use_mesh
    from repro_torch.launch import serve
    from repro_torch.obs import Obs
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.faults import FaultPlan, FaultSpec
    from repro_torch.serve.frontend import (CompletionRequest, Supervisor,
                                            follow)

    args = serve.build_parser().parse_args(SERVER_ARGS)
    _, model, params = serve.load_model(args)
    plan = FaultPlan()
    config = dc.replace(ServeConfig.from_args(args), replicas=2,
                        faults=plan)
    reqs = server_requests(8, 16)
    with use_mesh(mesh):
        if rank != 0:
            obs = Obs.create(metrics=True, trace=False)
            return {"steps": [f.steps for f in follow(serve.make_engines(
                model, params, config, obs, SERVER_TIMEOUT_S))]}
        router = serve.make_router(model, params, config,
                                   group_timeout=SERVER_TIMEOUT_S)
        sup = Supervisor(router, poll_s=0.05)
        sup.start()
        toks = {u: [] for u, _, _ in reqs}
        finished, done = [], threading.Event()

        def on_event(uid):
            def cb(ev):                    # a replica's worker thread
                toks[uid].extend(ev.tokens)
                if ev.finished:
                    finished.append(uid)
                    if len(finished) == len(reqs):
                        done.set()
            return cb

        placed = {u: router.submit(CompletionRequest(
            prompt=p, max_tokens=m, uid=u), on_event(u), uid=u).name
            for u, p, m in reqs}
        mine = [u for u, name in placed.items() if name == "r0"]
        r0 = router.replicas[0]
        deadline = time.monotonic() + 60
        while not (r0.load and any(0 < len(toks[u]) < 16 for u in mine)):
            if time.monotonic() > deadline:
                raise RuntimeError("r0 never streamed a token")
            time.sleep(0.001)
        with plan._lock:                       # armed: r0's next pass
            plan.specs.append(FaultSpec("replica_worker", after=0,
                                        count=1, replica="r0"))
        done.wait(timeout=120)
        router.drain(timeout=30)
        sup.stop()
        out = {"streams": [toks[u] for u, _, _ in reqs], "placed": placed,
               "fired": dict(plan.fired),
               "restarts": r0.engine.m.snapshot()["replica_restarts"],
               "failed_over": sum(r.engine.m.snapshot()["failed_over"]
                                  for r in router.replicas)}
    out["one_device"] = one_device_streams(reqs)
    return out


def _drain_timeout(mesh, rank: int) -> dict:
    """One replica under ``mesh`` with a long request in flight (every
    burst slowed by 20 ms), drained with a timeout far shorter than the
    request: the drain gives up, the replica closes, and its worker's
    stop record ends the follower (which would otherwise time out in its
    broadcast and end its process).
    Rank 0: what the drain returned, the tokens streamed and whether the
    worker is gone; the other ranks: their follower's steps."""
    import dataclasses as dc
    import time

    from repro_torch.dist import use_mesh
    from repro_torch.launch import serve
    from repro_torch.obs import Obs
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.frontend import CompletionRequest, follow

    args = serve.build_parser().parse_args(SERVER_ARGS)
    _, model, params = serve.load_model(args)
    config = dc.replace(ServeConfig.from_args(args), faults=FaultPlan.parse(
        [f"slow_burst:delay_s=0.02,count={DRAIN_MAX_NEW}"]))
    with use_mesh(mesh):
        if rank != 0:
            obs = Obs.create(metrics=True, trace=False)
            return {"steps": [f.steps for f in follow(serve.make_engines(
                model, params, config, obs, SERVER_TIMEOUT_S))]}
        router = serve.make_router(model, params, config,
                                   group_timeout=SERVER_TIMEOUT_S)
        toks = []
        router.submit(CompletionRequest(prompt=[1, 2, 3, 4, 5, 6],
                                        max_tokens=DRAIN_MAX_NEW, uid=0),
                      lambda ev: toks.extend(ev.tokens), uid=0)
        deadline = time.monotonic() + 60
        while not toks:
            if time.monotonic() > deadline:
                raise RuntimeError("the request never streamed a token")
            time.sleep(0.001)
        drained = router.drain(timeout=DRAIN_TIMEOUT_S)
        return {"drained": drained, "tokens": len(toks),
                "worker_alive": router.replicas[0]._thread.is_alive()}


def _server_cases(rank: int, world: int, _, __, tmp: str) -> dict:
    """On 1x2: the batch CLI with two replicas (continuous through the
    router and its followers; static on one engine a rank), a replica
    worker's death mid-stream and a drain that times out."""
    import torch.distributed as dist

    from repro_torch.dist import mesh_from_spec

    mesh = mesh_from_spec("1x2", device="cpu")
    cli = SERVER_ARGS + ["--requests", "4", "--max-new", "6", "--mesh",
                         "1x2", "--replicas", "2"]
    res = {"rank": rank,
           "cli": {"continuous": _cli(cli),
                   "static": _cli(cli + ["--serve-mode", "static"])},
           "death": _worker_death_mid_stream(mesh, rank),
           "drain": _drain_timeout(mesh, rank)}
    dist.barrier()
    return res


# the reference's tests/test_prefix_cache.py::test_shared_prefix_2x4_mesh_parity
PREFIX_2X4 = dict(max_batch=4, max_len=64, page_size=8, num_pages=17,
                  steps_per_sync=4)


def prefix_2x4_requests():
    """(uid, prompt, max new) of eight requests sharing 12 tokens."""
    shared = np.arange(5, 17, dtype=np.int32)
    return [(i, np.concatenate([shared, np.asarray([20 + i, 21 + i],
                                                   np.int32)]), 6)
            for i in range(8)]


def prefix_2x4_streams(model, params, mesh=None):
    """Eight requests sharing a 12-token prefix, greedy and sampled
    (temperature 1, top-k 5), with the prefix cache and swap off and on:
    {sampled: (streams off, streams on, prefix hit tokens on)}."""
    from repro_torch.serve.engine import Request, ServeEngine

    reqs = [Request(uid=u, prompt=p, max_new_tokens=m)
            for u, p, m in prefix_2x4_requests()]
    out = {}
    for sampled in (False, True):
        kw = dict(PREFIX_2X4, **(dict(temperature=1.0, top_k=5)
                                 if sampled else {}))
        off = ServeEngine(model, params, mesh=mesh, prefix_cache=False,
                          host_swap_pages=0, **kw).generate(reqs, seed=3)
        on = ServeEngine(model, params, mesh=mesh, prefix_cache=True, **kw)
        got = on.generate(reqs, seed=3)
        out[sampled] = ([r.tokens.tolist() for r in off],
                        [r.tokens.tolist() for r in got],
                        on.stats["prefix_hit_tokens"])
    return out


def _prefix_cases(rank: int, world: int, flat, _, tmp: str) -> dict:
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.dist import mesh_from_spec
    from repro_torch.models.transformer import LM

    mesh = mesh_from_spec("2x4", device="cpu")
    model = LM(configs.get_config("paper_tiny_lm"), device="cpu")
    res = {"rank": rank, "streams": prefix_2x4_streams(
        model, model.params_from_jax(flat), mesh)}
    dist.barrier()
    return res


CASES = {"dist": _cases, "tp": _tp_cases, "tp_families": _fam_cases,
         "tp_frontend": _front_cases, "tp_server": _server_cases,
         "prefix_2x4": _prefix_cases}


def _cases_of(cases: str):
    """A key of :data:`CASES`, or ``"module:function"`` of another test
    helper module (imported in the rank)."""
    if ":" not in cases:
        return CASES[cases]
    import importlib

    module, name = cases.split(":")
    return getattr(importlib.import_module(module), name)


def _worker(rank: int, worlds, inits, tmp: str, queue,
            cases: str = "dist") -> None:
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
            queue.put((world, _cases_of(cases)(
                rank, world, flat, calib, os.path.join(tmp, str(world)))))
        except BaseException:                   # the test reports it
            queue.put((world, {"rank": rank,
                               "error": traceback.format_exc()}))
            return
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


def run_groups(worlds, flat, calib, timeout: float = 300.0,
               cases: str = "dist"):
    """Spawn ``max(worlds)`` ranks once and run every case of ``cases``
    (a key of :data:`CASES`, or ``"module:function"``) in a group of
    each size of ``worlds``
    (largest first; a ``file://`` rendezvous in a temporary directory
    each); returns {world: results in rank order}."""
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
                             args=(r, worlds, inits, tmp, queue, cases))
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
