"""Fault-tolerant training loop, on one device or data-parallel over a
mesh (the reference's ``repro.train.loop``).

  - step-indexed deterministic data (resume = continue the counter);
  - atomic checkpoints every ``ckpt_every`` steps in the reference's
    layout (ckpt.CheckpointStore), resume from the newest valid one
    (hash-verified; walks past torn writes);
  - straggler watchdog: each step's wall clock against the running
    median; slow steps are logged and counted, and after
    ``straggler_abort`` in a row the loop checkpoints and raises;
  - microbatch gradient accumulation, with optional int8 error-feedback
    compression (``optim.compression.ef_quantize``) of the accumulated
    gradients, where the reference applies it;
  - NaN guard: a step with a non-finite loss leaves params and optimizer
    state untouched and is counted (``metrics["skipped"]``).

The forward is the model's differentiable route
(``loss_fn(..., differentiable=True)``): the reference's training math
in torch ops, differentiated by autograd — the kernels have no backward
and refuse inputs that require grad.  A MoE model's loss carries
``router_aux_coef`` × its load-balance loss, logged as ``aux``; the
routing and the expert products are torch ops, so the gradient reaches
the router and every expert.

Under a mesh (``mesh=``, or the active ``dist.use_mesh`` context) the
trainer is data-parallel over the mesh's data (+pod) axes, one process a
rank: the pipeline (``DataPipeline`` under the same mesh) hands each
rank its rows of the global batch, each rank takes the gradients of its
rows, and an f32 ``all_reduce`` (in buckets of 2**24 elements) takes
their mean — the global batch's gradient when every rank's rows weigh
the same tokens.  The steps run under the mesh's context, so a MoE
layer routes the global batch as the reference does (capacity, top-C
and the load-balance fractions over every rank's tokens:
``models.moe``), and the mean of the ranks' aux losses is the
reference's aux.  The loss and
metrics are reduced the same way, so every rank's NaN guard decides
alike, and the straggler watchdog reads the slowest rank's step time.
Parameters stay replicated: the reference's FSDP sharding and a
``model`` axis > 1 in training (tensor parallelism, which serving has:
``serve.engine``) are not ported (ROADMAP.md, Queue 1), and the latter
is refused.  Only rank 0 writes checkpoints and
``metrics.jsonl``; every rank reads them back on resume.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import contextlib
import os
import statistics
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.ckpt import CheckpointStore
from repro_torch.dist import comm
from repro_torch.dist.api import axis_size, current_ctx, use_mesh
from repro_torch.optim import AdamW, OptState, tree_leaves, tree_map
from repro_torch.optim.compression import ef_init, ef_quantize

log = logging.getLogger("repro_torch.train")

BUCKET = 1 << 24        # f32 elements a gradient all_reduce moves at once


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    ckpt_every: int = 20
    keep_ckpts: int = 3
    out_dir: str = "runs/train"
    microbatches: int = 1            # grad-accumulation chunks
    grad_compression: bool = False   # int8 EF on accumulated grads
    straggler_factor: float = 5.0    # step > factor × median ⇒ straggler
    straggler_abort: int = 3         # consecutive stragglers ⇒ abort
    log_every: int = 10


def allreduce_mean(tensors, group):
    """The mean of each tensor over ``group`` (f32, in buckets of
    BUCKET elements), cast back to its dtype."""
    n = comm.size(group)
    out, bucket = [], []

    def flush():
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in bucket])
        comm.all_reduce_(flat, group)
        flat /= n
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            out.append(part.view(t.shape).to(t.dtype))
        bucket.clear()

    for t in tensors:
        if bucket and sum(b.numel() for b in bucket) + t.numel() > BUCKET:
            flush()
        bucket.append(t)
    if bucket:
        flush()
    return out


def make_train_step(model, opt: AdamW, microbatches: int = 1,
                    grad_compression: bool = False,
                    group=None) -> Callable:
    """(params, opt_state, ef_state, batch) → (params, opt_state,
    ef_state, metrics), with no host sync inside.  With a process
    ``group`` the batch is this rank's rows: the gradients, the loss and
    the metrics are averaged over the group before the update (the
    ``tokens`` metric summed)."""

    def grads_of(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(live, batch, differentiable=True)
            grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_map(lambda _: next(grads), live)

    def step(params, opt_state: OptState, ef_state, batch):
        if microbatches > 1:
            gsum = lsum = metrics = None
            for mb in range(microbatches):
                part = {k: v.chunk(microbatches)[mb] for k, v in batch.items()}
                loss, metrics, grads = grads_of(params, part)
                g32 = tree_map(lambda g: g.float(), grads)
                gsum = g32 if gsum is None else tree_map(torch.add, gsum, g32)
                lsum = loss if lsum is None else lsum + loss
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
        else:
            loss, metrics, grads = grads_of(params, batch)
        if group is not None:
            leaves = tree_leaves(grads)
            keys = sorted(metrics)
            reduced = allreduce_mean(
                [*leaves, loss, *(metrics[k] for k in keys)], group)
            it = iter(reduced[:len(leaves)])
            grads = tree_map(lambda _: next(it), grads)
            loss = reduced[len(leaves)]
            metrics = dict(zip(keys, reduced[len(leaves) + 1:]))
            metrics["tokens"] = metrics["tokens"] * comm.size(group)
        if grad_compression:
            grads, ef_state = ef_quantize(grads, ef_state,
                                          period=len(model.cfg.period))
        # NaN guard: a non-finite loss leaves everything as it was
        ok = torch.isfinite(loss)
        new_params, new_opt, stats = opt.update(grads, opt_state, params)
        new_params = tree_map(lambda n, o: torch.where(ok, n, o),
                              new_params, params)
        new_opt = OptState(*(tree_map(lambda n, o: torch.where(ok, n, o),
                                      n, o)
                             for n, o in zip(new_opt, opt_state)))
        metrics = {**metrics, **stats, "loss": loss,
                   "skipped": (~ok).to(torch.float32)}
        return new_params, new_opt, ef_state, metrics

    return step


class StragglerError(RuntimeError):
    pass


class Trainer:
    def __init__(self, model, opt: AdamW, pipeline, cfg: TrainConfig,
                 mesh=None, dp_axes=None):
        if mesh is None:
            ctx = current_ctx()
            if ctx is not None:
                mesh = ctx.mesh
                if dp_axes is None:
                    dp_axes = ctx.dp_axes
        self.model = model
        self.opt = opt
        self.pipeline = pipeline
        self.cfg = cfg
        self.mesh = mesh
        self.group = None
        if mesh is not None:
            if ("model" in mesh.mesh_dim_names
                    and axis_size(mesh, "model") > 1):
                raise ValueError(
                    "Trainer: a model axis > 1 (tensor parallelism) is not "
                    "ported (ROADMAP.md); train on a data-parallel mesh "
                    "(Dx1)")
            if dp_axes is None:
                from repro_torch.dist.mesh import dp_axes_of
                dp_axes = dp_axes_of(mesh)
            self.group = comm.group_of(mesh, tuple(dp_axes))
        self.dp_axes = dp_axes
        self.store = CheckpointStore(cfg.out_dir, keep=cfg.keep_ckpts)
        self.metrics_path = os.path.join(cfg.out_dir, "metrics.jsonl")
        self.straggler_events = 0
        self.skipped_steps = 0
        self._step_fn = make_train_step(model, opt, cfg.microbatches,
                                        cfg.grad_compression, self.group)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """(params, opt_state, ef_state) from the reference's keyed init:
        ``LM.init(key(seed))``."""
        params = self.model.init(rnd.key(seed, self.model.device))
        ef = (ef_init(params) if self.cfg.grad_compression else
              torch.zeros((), dtype=torch.float32, device=self.model.device))
        return params, self.opt.init(params), ef

    def to_flat(self, params, opt_state: OptState,
                ef_state) -> Dict[str, np.ndarray]:
        """The state as the reference's checkpoint leaves."""
        flat = {f"params/{k}": v
                for k, v in self.model.params_to_flat(params).items()}
        flat["opt/.step"] = opt_state.step.cpu().numpy()
        for name, tree in (("mu", opt_state.mu), ("nu", opt_state.nu)):
            flat.update({f"opt/.{name}/{k}": v for k, v in
                         self.model.params_to_flat(tree).items()})
        if isinstance(ef_state, torch.Tensor):
            flat["ef"] = ef_state.cpu().numpy()
        else:                      # the error-feedback residuals' tree
            flat.update({f"ef/{k}": v for k, v in
                         self.model.params_to_flat(ef_state).items()})
        return flat

    def from_flat(self, flat: Dict[str, np.ndarray]):
        """(params, opt_state, ef_state) from checkpoint leaves — either
        package's."""
        def sub(prefix):
            return self.model.params_from_jax(
                {k[len(prefix):]: v for k, v in flat.items()
                 if k.startswith(prefix)})

        dev = self.model.device
        params = sub("params/")
        opt = OptState(
            step=torch.as_tensor(np.asarray(flat["opt/.step"], np.int32),
                                 device=dev),
            mu=sub("opt/.mu/"), nu=sub("opt/.nu/"))
        if "ef" in flat:
            ef = torch.as_tensor(np.asarray(flat["ef"], np.float32),
                                 device=dev)
        else:
            ef = sub("ef/")
        return params, opt, ef

    def restore_or_init(self):
        """(start_step, params, opt_state, ef_state)."""
        restored = self.store.restore(convert=self.from_flat)
        if restored is None:
            return (0, *self.init_state())
        step, (params, opt_state, ef_state), _ = restored
        log.info("restored checkpoint at step %d", step)
        return step, params, opt_state, ef_state

    def _save(self, step, params, opt_state, ef_state) -> None:
        if comm.is_main_rank():
            self.store.save(step, self.to_flat(params, opt_state, ef_state))
        if self.group is not None:
            comm.barrier()        # the checkpoint is whole before going on

    def _log_metrics(self, step: int, metrics: Dict[str, Any],
                     seconds: float) -> None:
        if not comm.is_main_rank():
            return
        rec = {"step": step, "seconds": seconds}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _context(self):
        """The mesh's context around a step (a MoE layer routes the global
        batch under it), whichever thread runs the loop."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_mesh(self.mesh, self.dp_axes, split_rows=True)

    def _slowest(self, dt: float) -> float:
        """The slowest rank's step seconds, so that every rank's
        straggler watchdog decides alike (the step time alone without a
        mesh)."""
        if self.group is None:
            return dt
        t = torch.tensor([dt], dtype=torch.float64,
                         device=self.model.device)
        comm.all_reduce_(t, None, op=comm.MAX)
        return float(t)

    # ------------------------------------------------------------------
    def run(self, max_steps: Optional[int] = None):
        """Train until ``cfg.total_steps`` (resuming automatically).
        Returns (params, opt_state, info); ``info`` has the steps run,
        straggler events, skipped steps, the first and last loss of this
        run and its step seconds."""
        cfg = self.cfg
        start, params, opt_state, ef_state = self.restore_or_init()
        end = min(cfg.total_steps, start + (max_steps or cfg.total_steps))
        durations: list = []
        losses: list = []
        consecutive_stragglers = 0
        cuda = self.model.device.type == "cuda"

        step = start
        while step < end:
            batch = self.pipeline.batch_at(step)
            t0 = time.monotonic()
            with self._context():
                params, opt_state, ef_state, metrics = self._step_fn(
                    params, opt_state, ef_state, batch)
            loss = float(metrics["loss"])          # the step's one sync
            if cuda:
                torch.cuda.synchronize()
            dt = self._slowest(time.monotonic() - t0)
            losses.append(loss)
            self.skipped_steps += int(metrics["skipped"])

            # straggler watchdog
            if len(durations) >= 5:
                med = statistics.median(durations[-20:])
                if dt > cfg.straggler_factor * med:
                    self.straggler_events += 1
                    consecutive_stragglers += 1
                    log.warning("straggler step %d: %.3fs vs median %.3fs",
                                step, dt, med)
                    if consecutive_stragglers >= cfg.straggler_abort:
                        self._save(step + 1, params, opt_state, ef_state)
                        raise StragglerError(
                            f"{consecutive_stragglers} consecutive "
                            f"straggler steps at step {step}")
                else:
                    consecutive_stragglers = 0
            durations.append(dt)

            step += 1
            if step % cfg.log_every == 0 or step == end:
                self._log_metrics(step, metrics, dt)
            if step % cfg.ckpt_every == 0 or step == end:
                self._save(step, params, opt_state, ef_state)

        return params, opt_state, {
            "steps": step - start,
            "straggler_events": self.straggler_events,
            "skipped_steps": self.skipped_steps,
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "step_seconds": durations,
        }
