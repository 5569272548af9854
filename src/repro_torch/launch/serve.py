"""Serving launcher (batch CLI): continuous batching (or static buckets)
off a (2:4-pruned) model on one device, greedy or sampled.

  # 8 random-prompt requests through the engine on the card
  python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --magnitude-24 --sparse --requests 8 --max-new 32

  # a checkpoint either pruner wrote (its 2:4 leaves pack at --sparse),
  # sampled: temperature 0.8, top-p 0.9, keyed per (uid, step)
  python -m repro_torch.launch.serve --arch paper-tiny-lm \\
      --params runs/pruned/pruned_params --sparse \\
      --sampling top-p --temperature 0.8

  # static mode: prompt-length buckets over a dense cache
  python -m repro_torch.launch.serve --arch paper-tiny-lm \\
      --serve-mode static --device cpu

The flags are the reference's for the knobs the port has, plus
``--device`` and ``--magnitude-24`` (magnitude 2:4 pruning of random or
loaded weights before packing: the paper's own pruning pass is the next
slice).  The router and the HTTP front end are not ported: the CLI calls
``ServeEngine.generate`` directly.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.ckpt import load_pytree
from repro_torch.core.pruner import prune_linears
from repro_torch.models.transformer import LM
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Request, ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_tiny_lm")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--params", default=None,
                    help="checkpoint dir written by the reference "
                         "(default: random init, seed 0)")
    ap.add_argument("--sparse", action="store_true",
                    help="pack 2:4 weights → nm_spmm kernel path")
    ap.add_argument("--magnitude-24", action="store_true",
                    help="magnitude-prune every linear to 2:4 first")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--sampling", default="greedy",
                    choices=("greedy", "temperature", "top-k", "top-p"),
                    help="greedy argmax, plain temperature, or top-k / "
                         "top-p (nucleus) filtering — keyed per (uid, "
                         "step) in continuous mode, so preemption replays "
                         "identical tokens; a zero temperature becomes 1.0 "
                         "for the sampled modes")
    ap.add_argument("--top-k", type=int, default=40,
                    help="k for --sampling top-k")
    ap.add_argument("--top-p", type=float, default=0.9,
                    help="nucleus mass for --sampling top-p")
    ap.add_argument("--serve-mode", default="continuous",
                    choices=("continuous", "static"),
                    help="continuous batching (paged KV) or static "
                         "prompt-length buckets (dense cache)")

    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--steps-per-sync", type=int, default=8)
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="hash-based prefix reuse over refcounted KV "
                         "pages: cached prompt pages attach shared "
                         "without prefill, copy-on-write on divergence "
                         "(token streams are bit-identical either way)")
    ap.add_argument("--host-swap-pages", type=int, default=None,
                    help="host-memory swap arena capacity in pages: "
                         "preemption evicts a victim's exclusive pages "
                         "to the host tier and streams them back on "
                         "resume instead of recomputing (default: "
                         "pool-sized; 0 disables → recompute-only)")
    ap.add_argument("--kv-dtype", default="fp32", choices=("fp32", "int8"))
    ap.add_argument("--device", default="cuda")
    return ap


def load_model(args):
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (pass --device cpu to run "
                           "the plain versions on the CPU)")
    cfg = (cfglib.get_smoke(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    model = LM(cfg, device=device)
    if args.params:
        flat, extra = load_pytree(args.params)
        params = model.params_from_jax(flat)
        print(f"loaded params ({extra})")
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = model.init(gen)
    if args.magnitude_24:
        params = prune_linears(params, "2:4")
    return cfg, model, params


def sampling_knobs(args) -> dict:
    """``--sampling`` → (temperature, top_k, top_p), as the reference's
    ``ServeConfig.from_args``."""
    temperature = args.temperature
    top_k = args.top_k if args.sampling == "top-k" else None
    top_p = args.top_p if args.sampling == "top-p" else None
    if args.sampling != "greedy" and temperature <= 0.0:
        temperature = 1.0
    return dict(temperature=temperature, top_k=top_k, top_p=top_p)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg, model, params = load_model(args)
    config = ServeConfig(
        mode=args.serve_mode, **sampling_knobs(args),
        max_batch=args.max_batch, max_len=args.max_len,
        page_size=args.page_size, num_pages=args.num_pages,
        prefill_chunk=args.prefill_chunk,
        steps_per_sync=args.steps_per_sync, kv_dtype=args.kv_dtype,
        prefix_cache=args.prefix_cache,
        host_swap_pages=args.host_swap_pages,
        sparse_weights="auto" if args.sparse else "off").validate()
    eng = ServeEngine(model, params, config)
    if args.sparse:
        print(f"packed {eng.n_sparse_leaves} 2:4-sparse weights "
              "(nm_spmm path)")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=8,
                                               dtype=np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.monotonic()
    results = eng.generate(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.monotonic() - t0
    for r in results[:4]:
        print(f"req {r.uid}: {r.tokens.tolist()}")
    toks = sum(len(r.tokens) for r in results)
    st = eng.stats
    print(f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s on "
          f"{model.device}) [{eng.mode}] host-syncs/token "
          f"{st['host_syncs'] / max(1, toks):.2f} "
          f"burst {st['device_steps'] / max(1, st['host_syncs']):.1f}"
          + (f" preemptions {st['preemptions']}" if st["preemptions"]
             else ""))
    if eng.pool is None:
        return                                      # static: no pool
    arena = eng.pool.arena
    print(f"prefix cache {'on' if eng.pool.prefix else 'off'}: hit tokens "
          f"{st['prefix_hit_tokens']} prefilled {st['prefill_tok']} "
          f"cow copies {st['cow_copies']} evictions "
          f"{st['prefix_evictions']}; swap arena "
          + (f"{arena.capacity} pages ({arena.nbytes / 2**20:.1f} MiB): "
             f"preempt swap {st['preempt_swap']} recompute "
             f"{st['preempt_recompute']} pages out {st['swap_out_pages']} "
             f"in {st['swap_in_pages']}" if arena is not None else "off"))


if __name__ == "__main__":
    main()
