"""Serving launcher: continuous batching (or static buckets) off a
(2:4-pruned) model on one device — a batch CLI or a streaming HTTP
server.

  # batch: 8 random-prompt requests through the router, on the card
  python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --magnitude-24 --sparse --requests 8 --max-new 32

  # server: OpenAI-style /v1/completions with SSE streaming, two replicas
  python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --magnitude-24 --sparse --server --port 8000 --replicas 2

  # a checkpoint either pruner wrote (its 2:4 leaves pack at --sparse),
  # sampled: temperature 0.8, top-p 0.9, keyed per (uid, step)
  python -m repro_torch.launch.serve --arch paper-tiny-lm \\
      --params runs/pruned/pruned_params --sparse \\
      --sampling top-p --temperature 0.8

As the reference's launcher, both paths go through the front end's
request and response objects: continuous batch mode builds
``CompletionRequest``s and calls ``Router.complete`` over
``--replicas`` engines on one shared ``Obs`` registry — a client of the
server's own code path.  ``--serve-mode static`` lowers the same wire
objects onto ``ServeEngine.generate``.  Every knob goes through one
``ServeConfig.from_args``.  The flags are the reference's, plus
``--device`` and ``--magnitude-24`` (magnitude 2:4 pruning of random or
loaded weights before packing).  SIGTERM drains like Ctrl-C wherever a
router serves (the continuous batch and the server): "draining...", the
in-flight requests finish, the trace is written and the process exits 0.
The batch takes it as the KeyboardInterrupt of
``install_sigterm_handler``, the server in its event loop
(``_serve_until_sigterm``); a static-mode batch has nothing to drain and
stops where it is.

``--mesh`` takes any spec whose size is the world's, one process a
rank started by ``torchrun`` (``none``: one device; ``host``: a 1×1 mesh
over this process).  A model axis > 1 serves tensor-parallel — every
family: the dense decoders, Mamba, the hybrid, the xLSTM, the MoE
decoders, the prefix-LM and the encoder-decoder, their 2:4-packed
linears split column- and row-parallel, the pool split by KV heads and
the state rows by d_inner or whole heads, a MoE's experts by E
(``serve.engine``); the data axis replicates continuous mode and splits
a static bucket's rows:

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --arch qwen1.5-0.5b --magnitude-24 --sparse --mesh 1x2
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
      --arch qwen1.5-0.5b --magnitude-24 --sparse --mesh 1x2 \\
      --server --port 8000 --replicas 2

Under a mesh of several ranks the router, its replicas, the supervisor
and the HTTP server run on rank 0, which alone binds the port; every
other rank runs one follower a replica, stepped in lockstep with rank
0's replica on the records it broadcasts, one replica's step at a time
(``serve.frontend.lockstep``; each replica's engine on a channel of its
own, whose collectives time out after ``--group-timeout`` seconds —
rank 0 sends a keep-alive well inside it while idle).  SIGTERM on every
rank (as ``torchrun`` sends it): rank 0 drains and stops the followers,
and every rank exits 0 after "draining..."; a rank that dies fails the
others' next collective, and they exit non-zero.  Static mode runs
``generate`` on one engine a rank, and rank 0 prints.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.ckpt import load_pytree
from repro_torch.core.pruner import prune_linears
from repro_torch.dist import (add_mesh_argument, comm, current_ctx,
                              mesh_context)
from repro_torch.models.transformer import LM
from repro_torch.obs import Obs
from repro_torch.obs.metrics import merge_histograms
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import ServeEngine, effective_mode
from repro_torch.serve.frontend import (CompletionRequest,
                                        CompletionResponse, Replica, Router,
                                        Supervisor, follow, run_server,
                                        to_engine_request)
from repro_torch.serve.frontend.lockstep import die, locksteps
from repro_torch.serve.frontend.router import ReplicaFailed


def install_sigterm_handler():
    """SIGTERM takes Ctrl-C's path (a KeyboardInterrupt in the main
    thread): the batch drains first, then the trace export.  Returns the
    handler it replaced (None off the main thread)."""

    def _raise(signum, frame):
        raise KeyboardInterrupt

    try:
        return signal.signal(signal.SIGTERM, _raise)
    except ValueError:
        return None                # not the main thread


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
    ap.add_argument("--max-batch", type=int, default=8,
                    help="serve slots per engine replica")
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
    add_mesh_argument(ap)
    # ------------------------------------------------- server front end
    ap.add_argument("--server", action="store_true",
                    help="run the streaming HTTP front end instead of a "
                         "one-shot batch")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 picks a free port (printed)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind the "
                         "least-loaded router (--server / batch "
                         "continuous mode)")
    ap.add_argument("--group-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="under a mesh of several ranks: the timeout of "
                         "each replica's collectives (default: the "
                         "backend's); an idle replica sends a keep-alive "
                         "well inside it")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="per-replica wait-queue cap; a full queue "
                         "answers 429 instead of buffering unboundedly")
    # ------------------------------------------------- observability
    ap.add_argument("--metrics", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="the metrics registry behind /metrics, /stats "
                         "and the end-of-run report; --no-metrics makes "
                         "every instrumentation point a no-op")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record request-lifecycle spans and write "
                         "Chrome-trace JSON here on exit (token streams "
                         "are the same with tracing on or off)")
    # ------------------------------------------------- fault injection
    ap.add_argument("--inject-fault", action="append", default=None,
                    metavar="SITE[:K=V,...]",
                    help="deterministic fault injection (repeatable): "
                         "SITE is one of engine_step|replica_worker|"
                         "pool_alloc|slow_burst|swap_error; keys "
                         "after=N, count=N, delay_s=S, replica=rK — e.g. "
                         "--inject-fault engine_step:after=2,replica=r0")
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


def make_engine(model, params, config: ServeConfig,
                obs: Obs = None, **kw) -> ServeEngine:
    return ServeEngine(model, params, config, obs=obs, **kw)


def make_engines(model, params, config: ServeConfig, obs: Obs,
                 group_timeout: Optional[float] = None
                 ) -> List[ServeEngine]:
    """``config.replicas`` engines on one ``obs`` registry, each under
    its ``r{i}`` label.  The first engine packs the 2:4 weights (and
    shards them under a model axis > 1); the others serve that packed
    copy.  Under a mesh of several ranks each engine takes a channel of
    its own (``dist.comm.open_channel``, ``group_timeout`` seconds),
    opened on every rank in replica order."""
    ctx = current_ctx()
    engines: List[ServeEngine] = []
    for i in range(config.replicas):
        kw = {}
        if ctx is not None and ctx.mesh.mesh.numel() > 1:
            kw["channel"] = comm.open_channel(ctx.mesh, group_timeout)
        engines.append(make_engine(model, params, config,
                                   obs=obs.labelled(f"r{i}"), **kw))
        params = engines[0].params
    return engines


def make_router(model, params, config: ServeConfig,
                obs: Obs = None, group_timeout: Optional[float] = None
                ) -> Router:
    """``config.replicas`` engines (:func:`make_engines`) behind a
    least-loaded router.  Every replica has the same seed (a request's
    stream does not depend on which replica serves it: per-(uid, step)
    keys) and writes its ``replica``-labelled series into the one
    ``obs`` registry."""
    if obs is None:
        obs = Obs.create(metrics=config.metrics, trace=config.trace)
    engines = make_engines(model, params, config, obs, group_timeout)
    return Router([Replica(e, name=f"r{i}", lockstep=ls) for i, (e, ls)
                   in enumerate(zip(engines, locksteps(engines)))])


def _random_requests(cfg, args):
    rng = np.random.default_rng(0)
    return [CompletionRequest(
        uid=i, prompt=rng.integers(0, cfg.vocab_size, size=8,
                                   dtype=np.int32).tolist(),
        max_tokens=args.max_new) for i in range(args.requests)]


def _mesh_ranks() -> int:
    """Ranks of the active mesh (1 without one)."""
    ctx = current_ctx()
    return 1 if ctx is None else ctx.mesh.mesh.numel()


def run_batch(cfg, model, params, args, config: ServeConfig,
              obs: Obs) -> None:
    creqs = _random_requests(cfg, args)
    mode = effective_mode(model.cfg, config.mode)
    ranks = _mesh_ranks()
    main_rank = comm.is_main_rank()
    if mode == "continuous":
        if not main_rank:                      # a follower a replica
            follow(make_engines(model, params, config, obs,
                                args.group_timeout))
            return
        router = make_router(model, params, config, obs=obs,
                             group_timeout=args.group_timeout)
        engines = [r.engine for r in router.replicas]
        _print_packed(args, engines[0])
        t0 = time.monotonic()
        try:
            results = router.complete(creqs)
        except KeyboardInterrupt:              # Ctrl-C or SIGTERM
            print("draining...", flush=True)
            router.drain(timeout=30)
            return
        except ReplicaFailed as e:             # a rank is gone
            die(str(e))
        dt = time.monotonic() - t0
        router.drain(timeout=30)
        _print_mesh(ranks, engines[0])
        _summary(results, engines, dt)
        return
    # static buckets (every rank steps its engine itself under a mesh):
    # the same wire objects, lowered onto generate()
    if mode != config.mode:
        print(f"note: {config.mode} unsupported for {cfg.name} — "
              f"fell back to {mode}")
    eng = make_engine(model, params, config, obs=obs.labelled("r0"))
    if main_rank:
        _print_packed(args, eng)
    t0 = time.monotonic()
    raw = eng.generate([to_engine_request(c, c.uid) for c in creqs])
    dt = time.monotonic() - t0
    if main_rank:
        _print_mesh(ranks, eng)
        _summary([CompletionResponse.from_result(r) for r in raw], [eng], dt)


def _print_mesh(ranks: int, eng) -> None:
    if ranks > 1:
        mesh = current_ctx().mesh
        shape = "x".join(str(n) for n in mesh.shape)
        print(f"mesh {shape} {tuple(mesh.mesh_dim_names)}: {ranks} ranks, "
              f"model axis {eng.tp}")


def _print_packed(args, eng) -> None:
    if args.sparse:
        print(f"packed {eng.n_sparse_leaves} 2:4-sparse weights "
              "(nm_spmm path)")


def _registries(engines):
    regs = []
    for e in engines:
        reg = e.obs.metrics
        if reg.enabled and all(reg is not x for x in regs):
            regs.append(reg)
    return regs


def _summary(results, engines, dt) -> None:
    """The end-of-run report, read from the registry (the source
    ``/metrics`` reads too)."""
    toks = sum(len(r.tokens) for r in results)
    for r in results[:4]:
        print(f"req {r.uid}: {list(r.tokens)}"
              + (f"  [{r.replica}]" if r.replica else ""))
    preempts = sum(r.preemptions for r in results)
    regs = _registries(engines)

    def total(name: str) -> int:
        return int(sum(f.total() for f in (reg.get(name) for reg in regs)
                       if f is not None))

    syncs = total("serve_host_syncs_total")
    burst = total("serve_device_steps_total") / syncs if syncs else 0.0
    slot_steps = total("serve_slot_steps_total")
    util = total("serve_tokens_total") / slot_steps if slot_steps else 0.0
    eng = engines[0]
    print(f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s on "
          f"{eng.model.device}) [{eng.mode}] host-syncs/token "
          f"{syncs / max(1, toks):.2f} burst {burst:.1f} util {util:.2f}"
          + (f" preemptions {preempts}" if preempts else ""))
    ttft = merge_histograms(
        [f for f in (reg.get("serve_ttft_seconds") for reg in regs)
         if f is not None])
    if ttft is not None and ttft.count:
        print(f"ttft p50 {ttft.quantile(0.5) * 1e3:.1f}ms "
              f"p95 {ttft.quantile(0.95) * 1e3:.1f}ms (n={ttft.count})")
    if eng.pool is None:
        return                                      # static: no pool
    arena = eng.pool.arena
    print(f"prefix cache {'on' if eng.pool.prefix else 'off'}: hit tokens "
          f"{total('serve_prefix_hit_tokens_total')} prefilled "
          f"{total('serve_prefill_tokens_total')} cow copies "
          f"{total('serve_cow_copies_total')} evictions "
          f"{total('serve_prefix_evictions_total')}; swap arena "
          + (f"{arena.capacity} pages ({arena.nbytes / 2**20:.1f} MiB) a "
             f"replica: preempt swap {total('serve_preempt_swap_total')} "
             f"recompute {total('serve_preempt_recompute_total')} pages "
             f"out {total('serve_swap_out_pages_total')} in "
             f"{total('serve_swap_in_pages_total')}"
             if arena is not None else "off"))


def _export_trace(obs: Obs, path) -> None:
    if path and obs.tracer.enabled and comm.is_main_rank():
        n = obs.tracer.export(path)
        print(f"wrote {n} trace events -> {path}")


async def _serve_until_sigterm(router: Router, host: str, port: int) -> None:
    """``run_server`` with SIGTERM taken inside the event loop: the signal
    cancels the server task at its await, and its shutdown drains.  (A
    KeyboardInterrupt raised from a plain signal handler can land inside a
    transport's close callback; the connection then never detaches, and
    the server's ``wait_closed`` waits for ever.)  A replica's fatal
    failure (a lockstep replica whose collective failed) ends the
    process at once, exit code 1 (``lockstep.die``)."""
    task = asyncio.ensure_future(run_server(router, host, port))

    def stop() -> None:
        print("draining...", flush=True)
        task.cancel()

    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop)
    while not task.done():
        await asyncio.wait([task], timeout=0.25)
        try:
            router.raise_fatal()
        except ReplicaFailed as e:       # a rank is gone: nothing to
            die(str(e))                  # drain, no one to serve with
    await task


def run_frontend(cfg, model, params, args, config: ServeConfig,
                 obs: Obs) -> None:
    if config.mode != "continuous":
        raise SystemExit("--server needs the continuous runtime "
                         "(streaming sessions); drop --serve-mode static")
    if effective_mode(model.cfg, config.mode) != "continuous":
        raise SystemExit(f"--server unsupported for {cfg.name}: the arch "
                         "falls back to the static bucketed engine")
    if not comm.is_main_rank():                # a follower a replica
        follow(make_engines(model, params, config, obs, args.group_timeout))
        return
    router = make_router(model, params, config, obs=obs,
                         group_timeout=args.group_timeout)
    _print_packed(args, router.replicas[0].engine)
    # supervision: restart crashed or stalled workers and fail their
    # in-flight requests over
    sup = Supervisor(router)
    sup.start()
    try:
        asyncio.run(_serve_until_sigterm(router, args.host, args.port))
    except KeyboardInterrupt:                  # Ctrl-C
        print("draining...", flush=True)
        sup.stop()
        router.drain(timeout=30)
    finally:
        sup.stop()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    # the server takes SIGTERM in its event loop (_serve_until_sigterm)
    previous = None if args.server else install_sigterm_handler()
    config = ServeConfig.from_args(args)       # the one knob intake point
    # one obs bundle for the process: every replica labels its series
    # into this registry and tracer
    obs = Obs.create(metrics=config.metrics, trace=config.trace)
    owns_group = not torch.distributed.is_initialized()
    try:
        with mesh_context(args.mesh, args.device):
            cfg, model, params = load_model(args)
            if args.server:
                run_frontend(cfg, model, params, args, config, obs)
            else:
                run_batch(cfg, model, params, args, config, obs)
        if owns_group and torch.distributed.is_initialized():
            _close_process_group()
    finally:
        _export_trace(obs, args.trace_out)
        if previous is not None:       # a caller's own handler comes back
            signal.signal(signal.SIGTERM, previous)


def _close_process_group() -> None:
    """End the process group this launcher started once every rank is
    done (a barrier), instead of leaving its groups to the interpreter's
    exit, where a follower rank of the server has aborted in gloo
    ("terminate called without an active exception")."""
    comm.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
