"""Pruning launcher: the paper's Algorithm 1 over a whole model, on one
device or over a mesh of ranks (the port of ``repro.launch.prune``).

  # a checkpoint the trainer wrote (this package's or the reference's),
  # calibrated and evaluated on the synthetic corpus it was trained on
  python -m repro_torch.launch.prune --arch paper-tiny-lm \\
      --ckpt runs/train --sparsity 2:4 --method SM --out runs/pruned

  # the same with calibration/eval tokens from a file, on the CPU
  python -m repro_torch.launch.prune --arch paper-tiny-lm \\
      --ckpt runs/train --tokens tokens.npz --sparsity 2:4 \\
      --method SM --out runs/pruned --device cpu

  # random weights and random tokens from --seed, on the card
  python -m repro_torch.launch.prune --arch qwen1.5-0.5b \\
      --sparsity 2:4 --method MM --calib-samples 128 --calib-seq 2048 \\
      --out runs/qwen-mm24

Weights come from ``--ckpt`` (a trainer's ``CheckpointStore`` directory:
the newest checkpoint that loads, past torn writes) or from a random
init seeded by ``--seed``.  Calibration and evaluation tokens:

  * with ``--tokens file.npz``: int32 ``calib`` (N, T) and ``eval``
    (M, T), split into batches of 8 and 16;
  * else, with ``--ckpt``: the synthetic corpus the trainer learns, as
    the reference's launcher takes it — ``calibration_batches(cfg,
    --calib-samples, --calib-seq)`` and 8 ``DataPipeline(cfg, 16,
    --calib-seq).eval_batch`` batches, seed 0;
  * else (random weights): token ids from a ``torch.Generator`` seeded
    by ``--seed`` — random weights learned no corpus, and at a large
    vocabulary the corpus's (V, V) table cannot be built (92 GB at
    Qwen1.5-0.5B's).

A modality-frontend model (paligemma-3b, seamless-m4t-large-v2) gets
its stubbed frontend's ``frontend_feats`` beside the tokens: from the
corpus's ``DataPipeline`` with the corpus, else normals from the same
generator scaled by 0.25 and cast to bf16, as the reference draws them;
the prefix-LM's text is ``--calib-seq`` minus its frontend_len positions
on both routes (an ``.npz`` gives its own).

The launcher prints dense and pruned perplexity and the engine's
summary, and writes ``<out>/pruned_params`` in the reference's layout,
which ``repro_torch.launch.serve --params`` serves.

By default (``--pipeline auto``) the engine runs the pipelined scheduler
(``core.pipeline``: stacked calibration batches, no host sync
mid-segment); ``--pipeline off`` runs the paper's serial loop.  Either
way it is resumable: progress is checkpointed per segment in
``<out>/prune_progress``, and a rerun of the same command continues at
the interrupted block (a rerun with other weights, tokens or pruning
settings refuses that progress: ``run_fingerprint``).  SIGTERM lands on the same path as Ctrl-C: the
checkpointed progress survives, and the stage trace (``--trace-out``,
Chrome-trace JSON of the capture/solve/propagate spans) is still
written on the way out.

``--mesh`` (``none`` | ``host`` | ``AxB`` | ...; ``dist.mesh``) runs the
engine over a DeviceMesh, one process a rank, started by ``torchrun``:

  torchrun --nproc-per-node 2 -m repro_torch.launch.prune --device cpu \
      --mesh 1x2 --arch paper-tiny-lm --smoke --out runs/tp2

The calibration shards over the ``data`` axis (``--calib-shard auto``)
with one Hessian all-reduce per linear, and the layer solves run
row-parallel over ``model`` (Remark 4.2).  Only rank 0 prints and
writes ``pruned_params`` and the progress.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.ckpt import (CheckpointStore, PruneProgressStore,
                              save_pytree)
from repro_torch.core.clock import no_clock
from repro_torch.core.engine import PruningEngine, summarize
from repro_torch.data import DataPipeline, calibration_batches
from repro_torch.dist import add_mesh_argument, mesh_context, rank_device
from repro_torch.dist.comm import is_main_rank
from repro_torch.models.transformer import LM
from repro_torch.obs import Obs

CALIB_BATCH = 8          # calibration_batches' batch
EVAL_BATCH = 16          # the reference launcher's DataPipeline batch
EVAL_BATCHES = 8         # the reference launcher's eval_ppl(n=8)

Batch = Dict[str, torch.Tensor]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_tiny_lm")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="a trainer's checkpoint dir, this package's or "
                         "the reference's (default: random init from "
                         "--seed)")
    ap.add_argument("--tokens", default=None,
                    help=".npz with int32 'calib' (N, T) and 'eval' (M, T) "
                         "(default: the synthetic corpus with --ckpt, "
                         "random ids from --seed without: random weights "
                         "learned no corpus, and a large vocabulary's "
                         "(V, V) corpus table may not fit)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sparsity", default="2:4",
                    help='"0.5" unstructured or "N:M"')
    ap.add_argument("--method", default="SM",
                    choices=("magnitude", "wanda", "SS", "SM", "MS", "MM"))
    ap.add_argument("--blocksize", type=int, default=64)
    ap.add_argument("--gamma", type=float, default=0.01)
    ap.add_argument("--calib-samples", type=int, default=32)
    ap.add_argument("--calib-seq", type=int, default=64)
    ap.add_argument("--pipeline", default="auto",
                    choices=("auto", "on", "off"),
                    help="batched calibration/solve scheduler "
                         "(core.pipeline); 'off' = the paper's serial loop")
    ap.add_argument("--calib-shard", default="auto", type=_calib_shard,
                    help="auto (one shard per data rank of --mesh, when "
                         "the batches allow), on, off, or an int: "
                         "accumulate that many calibration shards and "
                         "merge their Hessians")
    ap.add_argument("--out", required=True,
                    help="writes pruned_params/ here, and prune_progress/ "
                         "while the run is in flight")
    ap.add_argument("--metrics", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="prune stage seconds in the obs registry "
                         "(prune_stage_seconds_total{stage})")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write Chrome-trace JSON of the pipelined "
                         "capture/solve/propagate stage spans here")
    ap.add_argument("--device", default="cuda")
    add_mesh_argument(ap)
    return ap


def _calib_shard(value: str):
    if value in ("auto", "on", "off"):
        return value
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--calib-shard {value!r}: auto, on, off or an int") from None


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (pass --device cpu to run "
                           "the plain versions on the CPU)")
    return device


def load_params(model: LM, ckpt: Optional[str], seed: int = 0):
    """Params from the newest valid step of a ``CheckpointStore``
    directory (either package's trainer), or a random init drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    if ckpt is None:
        gen = torch.Generator(device=model.device)
        gen.manual_seed(seed)
        return model.init(gen)
    restored = CheckpointStore(ckpt).restore(
        convert=lambda flat: model.params_from_jax(
            {k[len("params/"):]: v for k, v in flat.items()
             if k.startswith("params/")}))
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt}")
    return restored[1]


def run_fingerprint(args, calib: List[Batch]) -> dict:
    """What decides the pruned params, for ``PruneProgressStore``: a
    progress checkpoint resumes only under the same values."""
    if args.ckpt is None:
        weights = {"seed": args.seed}
    else:
        step = CheckpointStore(args.ckpt).latest_step()
        with open(os.path.join(args.ckpt, f"step_{step:08d}",
                               "manifest.json")) as f:
            weights = {"ckpt_sha256": json.load(f)["sha256"]}
    tokens = hashlib.sha256()
    for b in calib:
        tokens.update(b["tokens"].cpu().numpy().tobytes())
    return dict(arch=args.arch, smoke=args.smoke, weights=weights,
                calib_shape=[sum(len(b["tokens"]) for b in calib),
                             calib[0]["tokens"].shape[1]],
                calib_sha256=tokens.hexdigest(), sparsity=args.sparsity,
                method=args.method, blocksize=args.blocksize,
                gamma=args.gamma, pipelined=args.pipeline != "off",
                calib_shard=args.calib_shard, device=args.device,
                mesh=args.mesh)


def _batches(tokens: torch.Tensor, size: int,
             feats: Optional[torch.Tensor] = None) -> List[Batch]:
    out = [{"tokens": t, "labels": t} for t in torch.split(tokens, size)]
    if feats is not None:
        for b, f in zip(out, torch.split(feats, size)):
            b["frontend_feats"] = f
    return out


def corpus_tokens(cfg, calib_samples: int, seq: int, device
                  ) -> Tuple[List[Batch], List[Batch]]:
    """The reference launcher's calibration and evaluation batches from
    the synthetic corpus: ``calibration_batches`` and the first
    EVAL_BATCHES ``eval_batch``es of a batch-16 pipeline, seed 0."""
    calib = calibration_batches(cfg, n_samples=calib_samples, seq_len=seq,
                                device=device)
    pipe = DataPipeline(cfg, EVAL_BATCH, seq, seed=0, device=device)
    return calib, [pipe.eval_batch(i) for i in range(EVAL_BATCHES)]


def load_tokens(path: Optional[str], vocab: int, calib_samples: int,
                seq: int, device, seed: int = 0, cfg=None
                ) -> Tuple[List[Batch], List[Batch]]:
    """(calibration batches of 8, evaluation batches of 16) on ``device``
    from an ``.npz``, or random ids from ``seed``.  A frontend ``cfg``'s
    batches also take ``frontend_feats``: 0.25 × normals from the
    generator (after the ids), cast to bf16; a prefix-LM's random text is
    ``seq`` minus its frontend_len positions."""
    frontend = cfg is not None and cfg.frontend is not None
    if frontend and not cfg.encdec:
        seq -= cfg.frontend_len
    gen = torch.Generator()
    gen.manual_seed(seed + 1)
    if path is not None:
        with np.load(path) as z:
            calib = torch.from_numpy(np.asarray(z["calib"], np.int32))
            ev = torch.from_numpy(np.asarray(z["eval"], np.int32))
    else:
        calib = torch.randint(0, vocab, (calib_samples, seq), generator=gen,
                              dtype=torch.int32)
        ev = torch.randint(0, vocab, (EVAL_BATCHES * EVAL_BATCH, seq),
                           generator=gen, dtype=torch.int32)
    feats = [None, None]
    if frontend:
        feats = [(0.25 * torch.randn((len(t), cfg.frontend_len,
                                      cfg.frontend_dim), generator=gen)
                  ).to(torch.bfloat16).to(device) for t in (calib, ev)]
    return (_batches(calib.to(device), CALIB_BATCH, feats[0]),
            _batches(ev.to(device), EVAL_BATCH, feats[1]))


@torch.no_grad()
def eval_ppl(model: LM, params, batches: List[Batch]) -> float:
    tot = cnt = 0.0
    for b in batches:
        _, m = model.loss_fn(params, b)
        tot += float(m["ce"]) * float(m["tokens"])
        cnt += float(m["tokens"])
    return float(np.exp(tot / cnt))


@torch.no_grad()
def prune(model: LM, params, calib: List[Batch], sparsity: str,
          method: str, blocksize: int = 64, gamma: float = 0.01,
          row_chunk: Optional[int] = None, clock=no_clock,
          **engine_kw):
    """Algorithm 1 over the model: (pruned params, LinearReports).
    ``engine_kw`` go to ``PruningEngine`` (``pipeline``, ``calib_shard``,
    ``skip``, ``progress_store``, ``obs``); the default is the pipelined
    scheduler."""
    engine = PruningEngine(model, sparsity, method=method,
                           blocksize=blocksize, gamma=gamma,
                           row_chunk=row_chunk, clock=clock, **engine_kw)
    return engine.run(params, calib)


def install_sigterm_handler():
    """SIGTERM → KeyboardInterrupt: the progress store has checkpointed
    every segment solved so far (a rerun resumes), and ``main``'s
    ``finally`` still exports the stage trace.  Returns the previous
    handler (None off the main thread, where nothing is installed)."""

    def _raise(signum, frame):
        raise KeyboardInterrupt

    try:
        return signal.signal(signal.SIGTERM, _raise)
    except ValueError:
        return None   # not the main thread


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = (cfglib.get_smoke(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    # built up front so that an interrupted run still exports its spans
    obs = Obs.create(metrics=args.metrics, trace=args.trace_out is not None)
    previous = install_sigterm_handler()
    try:
        with mesh_context(args.mesh, device) as ctx:
            _run(args, cfg, device if ctx is None else rank_device(device),
                 obs)
    finally:
        if args.trace_out:
            n = obs.tracer.export(args.trace_out)
            print(f"wrote {n} trace events -> {args.trace_out}")
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


def _say(*a) -> None:
    if is_main_rank():
        print(*a)


def _run(args, cfg, device, obs: Obs) -> None:
    model = LM(cfg, device=device)
    params = load_params(model, args.ckpt, args.seed)
    corpus = args.tokens is None and args.ckpt is not None
    if corpus:
        calib, ev = corpus_tokens(cfg, args.calib_samples, args.calib_seq,
                                  device)
    else:
        calib, ev = load_tokens(args.tokens, cfg.vocab_size,
                                args.calib_samples, args.calib_seq, device,
                                args.seed, cfg=cfg)
    _say("calibration/eval tokens: "
          + ("--tokens" if args.tokens else "synthetic corpus" if corpus
             else f"random ids from --seed {args.seed}"))
    _say(f"dense ppl: {eval_ppl(model, params, ev):.4f}")
    engine = PruningEngine(model, args.sparsity, method=args.method,
                           blocksize=args.blocksize, gamma=args.gamma,
                           pipeline=args.pipeline,
                           calib_shard=args.calib_shard,
                           progress_store=PruneProgressStore(
                               args.out, run_fingerprint(args, calib)),
                           obs=obs)
    with torch.no_grad():
        pruned, reports = engine.run(params, calib)
    s = summarize(reports)
    _say(f"pruned {s['linears']} linears, mean sparsity "
          f"{s['mean_sparsity']:.3f}, total recon error "
          f"{s['total_recon_error']:.4f}")
    ps = engine.last_pipeline_stats
    if ps is not None:
        _say(f"pipeline: {ps.segments} segments, {ps.batches} batches in "
              f"{ps.calib_shards} calib shard(s), wall {ps.wall_s:.2f}s")
    stage_s = obs.metrics.get("prune_stage_seconds_total")
    if stage_s is not None:
        _say("prune_stage_seconds_total: " + ", ".join(
            f"{stage} {c.value:.3f}" for (stage,), c in stage_s.children()))
    _say(f"{args.method} {args.sparsity} ppl: "
         f"{eval_ppl(model, pruned, ev):.4f}")
    out = os.path.join(args.out, "pruned_params")
    if is_main_rank():
        save_pytree(out, model.params_to_flat(pruned),
                    extra={"method": args.method, "sparsity": args.sparsity})
    _say(f"saved to {out}")


if __name__ == "__main__":
    main()
