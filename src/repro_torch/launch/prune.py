"""Pruning launcher: the paper's Algorithm 1 over a whole model, on one
device (the port of ``repro.launch.prune``).

  # a checkpoint the reference trained, with its calibration/eval tokens
  python -m repro_torch.launch.prune --arch paper-tiny-lm \\
      --ckpt /tmp/repro_train --tokens tokens.npz --sparsity 2:4 \\
      --method SM --out /tmp/pruned --device cpu

  # random weights and random tokens from --seed, on the card
  python -m repro_torch.launch.prune --arch qwen1.5-0.5b \\
      --sparsity 2:4 --method MM --calib-samples 128 --calib-seq 2048

Weights come from ``--ckpt`` (the reference trainer's ``CheckpointStore``
directory) or from a random init seeded by ``--seed``.  Calibration and evaluation tokens come
from ``--tokens file.npz`` — int32 ``calib`` (N, T) and ``eval`` (M, T),
as the reference's ``calibration_batches`` and ``DataPipeline.eval_batch``
make them, split here into batches of 8 and 16 — or, without it, from a
``torch.Generator`` seeded by ``--seed``.  (The reference's synthetic
Markov corpus needs JAX's threefry bit for bit: ROADMAP.md.)

The launcher prints dense and pruned perplexity and the engine's
summary, and writes ``<out>/pruned_params`` in the reference's layout,
which ``repro_torch.launch.serve --params`` serves.  The reference's
pipelined scheduler, mesh flags, resume store and stage trace are not
ported.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.ckpt import load_pytree, save_pytree
from repro_torch.core.clock import no_clock
from repro_torch.core.engine import PruningEngine, summarize
from repro_torch.models.transformer import LM

CALIB_BATCH = 8          # calibration_batches' batch
EVAL_BATCH = 16          # the reference launcher's DataPipeline batch
EVAL_BATCHES = 8         # the reference launcher's eval_ppl(n=8)

Batch = Dict[str, torch.Tensor]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_tiny_lm")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt", default=None,
                    help="reference checkpoint dir (default: random init "
                         "from --seed)")
    ap.add_argument("--tokens", default=None,
                    help=".npz with int32 'calib' (N, T) and 'eval' (M, T) "
                         "(default: random tokens from --seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sparsity", default="2:4",
                    help='"0.5" unstructured or "N:M"')
    ap.add_argument("--method", default="SM",
                    choices=("magnitude", "wanda", "SS", "SM", "MS", "MM"))
    ap.add_argument("--blocksize", type=int, default=64)
    ap.add_argument("--gamma", type=float, default=0.01)
    ap.add_argument("--calib-samples", type=int, default=32)
    ap.add_argument("--calib-seq", type=int, default=64)
    ap.add_argument("--out", default="/tmp/repro_torch_pruned")
    ap.add_argument("--device", default="cuda")
    return ap


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (pass --device cpu to run "
                           "the plain versions on the CPU)")
    return device


def load_params(model: LM, ckpt: Optional[str], seed: int = 0):
    """Params from the newest step of a reference ``CheckpointStore``
    directory, or a random init drawn from a ``torch.Generator`` seeded
    with ``seed``."""
    if ckpt is None:
        gen = torch.Generator(device=model.device)
        gen.manual_seed(seed)
        return model.init(gen)
    with open(os.path.join(ckpt, "LATEST")) as f:
        flat, _ = load_pytree(os.path.join(ckpt, f.read().strip()))
    return model.params_from_jax({k[len("params/"):]: v
                                  for k, v in flat.items()
                                  if k.startswith("params/")})


def _batches(tokens: torch.Tensor, size: int) -> List[Batch]:
    return [{"tokens": t, "labels": t} for t in torch.split(tokens, size)]


def load_tokens(path: Optional[str], vocab: int, calib_samples: int,
                seq: int, device, seed: int = 0
                ) -> Tuple[List[Batch], List[Batch]]:
    """(calibration batches of 8, evaluation batches of 16) on ``device``."""
    if path is not None:
        with np.load(path) as z:
            calib = torch.from_numpy(np.asarray(z["calib"], np.int32))
            ev = torch.from_numpy(np.asarray(z["eval"], np.int32))
    else:
        gen = torch.Generator()
        gen.manual_seed(seed + 1)
        calib = torch.randint(0, vocab, (calib_samples, seq), generator=gen,
                              dtype=torch.int32)
        ev = torch.randint(0, vocab, (EVAL_BATCHES * EVAL_BATCH, seq),
                           generator=gen, dtype=torch.int32)
    return (_batches(calib.to(device), CALIB_BATCH),
            _batches(ev.to(device), EVAL_BATCH))


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
          row_chunk: Optional[int] = None, clock=no_clock):
    """Algorithm 1 over the model: (pruned params, LinearReports)."""
    engine = PruningEngine(model, sparsity, method=method,
                           blocksize=blocksize, gamma=gamma,
                           row_chunk=row_chunk, clock=clock)
    return engine.run(params, calib)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = (cfglib.get_smoke(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    model = LM(cfg, device=device)
    params = load_params(model, args.ckpt, args.seed)
    calib, ev = load_tokens(args.tokens, cfg.vocab_size, args.calib_samples,
                            args.calib_seq, device, args.seed)
    print(f"dense ppl: {eval_ppl(model, params, ev):.4f}")
    pruned, reports = prune(model, params, calib, args.sparsity, args.method,
                            args.blocksize, args.gamma)
    s = summarize(reports)
    print(f"pruned {s['linears']} linears, mean sparsity "
          f"{s['mean_sparsity']:.3f}, total recon error "
          f"{s['total_recon_error']:.4f}")
    print(f"{args.method} {args.sparsity} ppl: "
          f"{eval_ppl(model, pruned, ev):.4f}")
    out = os.path.join(args.out, "pruned_params")
    save_pytree(out, model.params_to_flat(pruned),
                extra={"method": args.method, "sparsity": args.sparsity})
    print(f"saved to {out}")


if __name__ == "__main__":
    main()
