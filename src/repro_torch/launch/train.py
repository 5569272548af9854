"""Training launcher: ``python -m repro_torch.launch.train`` (the port of
``repro.launch.train``).

  # the reference's defaults: paper_tiny_lm, 300 steps, batch 16, seq 64,
  # lr 1e-3 on warmup_cosine(lr, steps // 10, steps), a checkpoint every
  # 50 steps — on the card
  python -m repro_torch.launch.train --out runs/tiny

  # on the CPU, smoke size
  python -m repro_torch.launch.train --smoke --steps 20 --device cpu \\
      --out runs/tiny-smoke

Builds the model (threefry-keyed init, the reference's ``LM.init``), the
synthetic-corpus pipeline, AdamW and the fault-tolerant Trainer; the run
resumes from ``--out`` when it holds checkpoints (kill and rerun to
continue).  ``--stop-at N`` ends this invocation after step N, as a kill
would.  The checkpoints are in the reference's layout: both packages'
prune launchers read them.

The run is under ``torch.use_deterministic_algorithms`` (with
``CUBLAS_WORKSPACE_CONFIG`` set, as cuBLAS requires), so that a resumed
run is bit-identical to an uninterrupted one on the card.

``--mesh DxM`` trains over D x M ranks, one process each, started by
``torchrun``: each rank takes its rows of the global batch over the D
data ranks, with FSDP over them by default (a rank holds its blocks of
the params, the AdamW moments and the error-feedback residuals; a step
all-gathers the params and reduce-scatters the gradients' mean), as the
reference's CLI gets it through its Trainer; with M > 1 the dense
decoders train tensor-parallel over the M model ranks as well (the
other families raise: ROADMAP.md).  ``--grad-compression`` applies
int8 error feedback to the reduced gradients, each scale the whole
tensor's.  The checkpoints hold whole leaves, so a run resumes on
another mesh:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
      --mesh 2x1 --smoke --steps 20 --out runs/dp2
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
      --mesh 2x2 --arch qwen3-14b --smoke --steps 20 --out runs/dp2tp2
"""

from __future__ import annotations

import argparse
import os
import statistics
from typing import Optional

import torch

from repro_torch import configs as cfglib
from repro_torch.data import DataPipeline
from repro_torch.dist import add_mesh_argument, mesh_context, rank_device
from repro_torch.dist.comm import is_main_rank
from repro_torch.launch.prune import resolve_device
from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import TrainConfig, Trainer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_tiny_lm")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8 error-feedback compression of the reduced "
                         "gradients")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--out", default="runs/train")
    ap.add_argument("--seed", type=int, default=0,
                    help="the data pipeline's seed (the init is key(0), "
                         "as the reference's Trainer)")
    ap.add_argument("--stop-at", type=int, default=None,
                    help="end this run after that step (resume later)")
    ap.add_argument("--device", default="cuda")
    add_mesh_argument(ap)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    with mesh_context(args.mesh, device) as ctx:
        return _run(args, device if ctx is None else rank_device(device))


def _run(args, device) -> dict:
    cfg = (cfglib.get_smoke(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    model = LM(cfg, device=device)
    pipe = DataPipeline(cfg, args.batch, args.seq, seed=args.seed,
                        device=device)
    opt = AdamW(lr=warmup_cosine(args.lr, args.steps // 10, args.steps))
    tc = TrainConfig(
        total_steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_every=args.ckpt_every, out_dir=args.out,
        microbatches=args.microbatches,
        grad_compression=args.grad_compression)
    trainer = Trainer(model, opt, pipe, tc)
    max_steps: Optional[int] = None
    if args.stop_at is not None:
        max_steps = args.stop_at - (trainer.store.latest_step() or 0)
        if max_steps <= 0:
            raise SystemExit(f"--stop-at {args.stop_at}: {args.out} is "
                             "already past that step")
    was = torch.are_deterministic_algorithms_enabled()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        _, _, info = trainer.run(max_steps)
    finally:
        torch.use_deterministic_algorithms(was)
    secs = info["step_seconds"]
    if not is_main_rank():
        return info
    print(f"trained {info['steps']} steps "
          f"(stragglers: {info['straggler_events']}, skipped: "
          f"{info['skipped_steps']}); checkpoints in {args.out}")
    if trainer.layout is not None:
        print(f"mesh {'x'.join(map(str, trainer.mesh.shape))}: FSDP over "
              f"{trainer.fsdp_axes or 'no axis'}; rank 0 held "
              f"{info['rank_state_bytes'] / 2**20:.1f} MiB of params and "
              "moments")
    if secs:
        hbm = (f"; HBM held {torch.cuda.max_memory_allocated() / 2**20:.1f}"
               " MiB" if device.type == "cuda" else "")
        print(f"loss {info['first_loss']:.4f} -> {info['last_loss']:.4f}; "
              f"{statistics.median(secs) * 1e3:.2f} ms a step (median) on "
              f"{device}{hbm}")
    return info


if __name__ == "__main__":
    main()
