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
trainer runs one process a rank, as the reference's pjit'd step lays it
out:

  - the pipeline (``DataPipeline`` under the same mesh) hands each rank
    its rows of the global batch over the data (+pod) axes; ranks that
    differ only in their model coordinate get the same rows;
  - FSDP by default: params, AdamW moments and error-feedback residuals
    are held as a rank's blocks over ``fsdp_axes`` (None: the data axes;
    ``()`` turns it off and replicates them), by the reference's rule
    (``dist.sharding.param_rule``), and under a ``model`` axis > 1 as
    its tensor-parallel blocks too — the dense decoders only
    (``LM.check_tp_training``; the other families raise, ROADMAP.md);
  - a step all-gathers the FSDP blocks (the whole tree at once), runs
    forward and backward on the differentiable route (its collectives
    over the model group: ``models.layers``), sums over the model group
    the gradients of the whole leaves a rank applies to its heads only
    (``dist.sharding.grad_sums``), takes the mean over the data group —
    a reduce-scatter to each rank's block for an FSDP leaf, an f32
    all-reduce (in buckets of 2**24 elements) for a whole one — and
    steps AdamW on the blocks, its global norm summed over the ranks
    (``optim.adamw``) and int8 error feedback scaled by each whole
    tensor's amax (``optim.compression``).

The mean over ranks is the global batch's gradient when every rank's
rows weigh the same tokens.  The steps run under the mesh's context, so
a MoE layer routes the global batch as the reference does (capacity,
top-C and the load-balance fractions over every rank's tokens:
``models.moe``), and the mean of the ranks' aux losses is the
reference's aux.  The loss and metrics are reduced the same way, so
every rank's NaN guard decides alike, and the straggler watchdog reads
the slowest rank's step time.  Checkpoints hold whole leaves in the
reference's layout: every rank joins the gather
(``dist.sharding.gather_params``), a leaf at a time, each whole leaf
copied to the host on rank 0 only and freed on the device before the
next (a rank holds its blocks and at most one whole leaf), and rank 0
writes them and ``metrics.jsonl``; on resume every rank reads them and
takes its blocks under the mesh it runs on now — a run saved on one
mesh resumes on another (the reference's elastic restore).
:meth:`Trainer.run` returns a rank's blocks, which
:meth:`Trainer.gather_state` makes whole.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import logging
import os
import statistics
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.ckpt import CheckpointStore
from repro_torch.dist import comm
from repro_torch.dist.api import current_ctx, use_mesh
from repro_torch.dist.mesh import dp_axes_of
from repro_torch.dist.sharding import (fsdp_shard, gather_params, grad_sums,
                                       model_shard, param_rules,
                                       shard_params)
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


@dataclasses.dataclass
class Layout:
    """How a rank holds the training state under a mesh: ``rules`` (the
    whole params' ``dist.sharding.param_rules``; FSDP over
    ``fsdp_axes``, the batch axes or none), ``sums`` (the leaves whose
    gradients are summed over the model group,
    ``dist.sharding.grad_sums``), ``counted`` (the leaves this rank adds
    to the global norm), and the groups over the batch axes (``data``)
    and over ``model`` (each None at one rank: nothing to reduce)."""

    mesh: Any
    fsdp_axes: tuple
    rules: Any
    sums: Any
    counted: Any
    data: Any
    model: Any

    def shard(self, tree, cfg):
        """A rank's blocks of a whole tree shaped like the params."""
        return shard_params(tree, self.mesh, cfg=cfg,
                            fsdp_axes=self.fsdp_axes)

    def gather(self, tree, to_host: bool = False):
        """The whole tree from every rank's blocks (a collective); with
        ``to_host`` a leaf at a time, on the host of rank 0 alone (None
        elsewhere)."""
        return gather_params(tree, self.rules, self.mesh,
                             fsdp_axes=self.fsdp_axes, to_host=to_host)

    def gather_fsdp(self, tree):
        """Each FSDP block all-gathered to the rank's model block."""
        return tree_map(lambda t, r: t if r.fsdp is None else
                        comm.all_gather_dim(t, self.data, r.fsdp),
                        tree, self.rules)

    def reduce(self, grads):
        """The model-group fix-up, then the mean over the data group: an
        FSDP leaf reduce-scattered to this rank's block, a whole one
        all-reduced (the f32 sums, cast back to each gradient's
        dtype)."""
        leaves, rules = tree_leaves(grads), tree_leaves(self.rules)
        if self.model is not None:
            sums = tree_leaves(self.sums)
            fixed = [g.float() for g, s in zip(leaves, sums) if s]
            if fixed:
                flat = torch.cat([g.reshape(-1) for g in fixed])
                comm.all_reduce_(flat, self.model)
                it = iter(flat.split([g.numel() for g in fixed]))
                leaves = [next(it).view(g.shape).to(g.dtype) if s else g
                          for g, s in zip(leaves, sums)]
        if self.data is not None:
            n = comm.size(self.data)
            whole = [i for i, r in enumerate(rules) if r.fsdp is None]
            means = iter(allreduce_mean([leaves[i] for i in whole],
                                        self.data))
            leaves = [next(means) if r.fsdp is None else
                      (comm.reduce_scatter_(g.float(), self.data, r.fsdp)
                       / n).to(g.dtype) for g, r in zip(leaves, rules)]
        it = iter(leaves)
        return tree_map(lambda _: next(it), grads)


def make_layout(model, params, mesh, dp_axes: Sequence[str],
                fsdp_axes: Sequence[str]) -> Layout:
    """The :class:`Layout` of the whole ``params`` on ``mesh``; FSDP over
    ``fsdp_axes``: the batch axes ``dp_axes``, or none."""
    names = mesh.mesh_dim_names
    dp_axes = tuple(a for a in dp_axes if a in names)
    fsdp_axes = tuple(a for a in fsdp_axes if a in names)
    if fsdp_axes not in ((), dp_axes):
        raise ValueError(f"Trainer: fsdp_axes {fsdp_axes} must be the batch "
                         f"axes {dp_axes} or ()")
    tp = model_shard(mesh).count
    dp = fsdp_shard(mesh, dp_axes).count
    rules = param_rules(params, model.cfg, tp,
                        fsdp_shard(mesh, fsdp_axes).count)
    coord = dict(zip(names, mesh.get_coordinate()))

    def counted(r):
        split = (fsdp_axes if r.fsdp is not None else ()) + (
            ("model",) if r.tp is not None else ())
        return all(coord[a] == 0 for a in names if a not in split)

    return Layout(
        mesh=mesh, fsdp_axes=fsdp_axes, rules=rules, sums=grad_sums(rules),
        counted=tree_map(counted, rules),
        data=comm.group_of(mesh, dp_axes) if dp > 1 else None,
        model=comm.group_of(mesh, "model") if tp > 1 else None)


def make_train_step(model, opt: AdamW, microbatches: int = 1,
                    grad_compression: bool = False,
                    layout: Optional[Layout] = None) -> Callable:
    """(params, opt_state, ef_state, batch) → (params, opt_state,
    ef_state, metrics), with no host sync inside.  With a ``layout``
    the state is a rank's blocks and the batch its rows: the step
    gathers the FSDP blocks, reduces the gradients to the rank's blocks
    (:meth:`Layout.reduce`), and averages the loss and the metrics over
    the data group (the ``tokens`` metric summed).  The step's
    ``reduced_grads(params, batch)`` gives (loss, metrics, gradients) as
    the update takes them."""
    group = None if layout is None else layout.data
    world = None if layout is None else torch.distributed.group.WORLD

    def grads_of(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(live, batch, differentiable=True)
            grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_map(lambda _: next(grads), live)

    def reduced_grads(params, batch):
        """(loss, metrics, gradients) of a step, reduced as the update
        takes them: over the group, to this rank's blocks."""
        full = params if layout is None else layout.gather_fsdp(params)
        if microbatches > 1:
            gsum = lsum = metrics = None
            for mb in range(microbatches):
                part = {k: v.chunk(microbatches)[mb] for k, v in batch.items()}
                loss, metrics, grads = grads_of(full, part)
                g32 = tree_map(lambda g: g.float(), grads)
                gsum = g32 if gsum is None else tree_map(torch.add, gsum, g32)
                lsum = loss if lsum is None else lsum + loss
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
        else:
            loss, metrics, grads = grads_of(full, batch)
        del full
        if layout is not None:
            grads = layout.reduce(grads)
        if group is not None:
            keys = sorted(metrics)
            reduced = allreduce_mean([loss, *(metrics[k] for k in keys)],
                                     group)
            loss = reduced[0]
            metrics = dict(zip(keys, reduced[1:]))
            metrics["tokens"] = metrics["tokens"] * comm.size(group)
        return loss, metrics, grads

    def step(params, opt_state: OptState, ef_state, batch):
        loss, metrics, grads = reduced_grads(params, batch)
        if grad_compression:
            grads, ef_state = ef_quantize(
                grads, ef_state, period=len(model.cfg.period),
                group=None if layout is None else world)
        # NaN guard: a non-finite loss leaves everything as it was
        ok = torch.isfinite(loss)
        new_params, new_opt, stats = opt.update(
            grads, opt_state, params,
            counted=None if layout is None else layout.counted, group=world)
        new_params = tree_map(lambda n, o: torch.where(ok, n, o),
                              new_params, params)
        new_opt = OptState(*(tree_map(lambda n, o: torch.where(ok, n, o),
                                      n, o)
                             for n, o in zip(new_opt, opt_state)))
        metrics = {**metrics, **stats, "loss": loss,
                   "skipped": (~ok).to(torch.float32)}
        return new_params, new_opt, ef_state, metrics

    step.reduced_grads = reduced_grads
    return step


class StragglerError(RuntimeError):
    pass


def _residuals(ef_state) -> bool:
    """Whether ``ef_state`` is the error-feedback residuals' tree (not
    the 0-dim placeholder of a run without compression)."""
    return not isinstance(ef_state, torch.Tensor) or ef_state.dim() > 0


class Trainer:
    def __init__(self, model, opt: AdamW, pipeline, cfg: TrainConfig,
                 mesh=None, dp_axes=None,
                 fsdp_axes: Optional[Sequence[str]] = None):
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
            model.check_tp_training(model_shard(mesh).count)
            if dp_axes is None:
                dp_axes = dp_axes_of(mesh)
            # None: FSDP over the batch axes; () replicates
            if fsdp_axes is None:
                fsdp_axes = dp_axes
            self.group = comm.group_of(mesh, tuple(dp_axes))
        self.dp_axes = dp_axes
        self.fsdp_axes = tuple(fsdp_axes or ())
        self.layout: Optional[Layout] = None
        self.store = CheckpointStore(cfg.out_dir, keep=cfg.keep_ckpts)
        self.metrics_path = os.path.join(cfg.out_dir, "metrics.jsonl")
        self.straggler_events = 0
        self.skipped_steps = 0
        self._step_fn = make_train_step(model, opt, cfg.microbatches,
                                        cfg.grad_compression)

    # ------------------------------------------------------------------
    def _place(self, params, opt_state: OptState, ef_state):
        """A rank's blocks of a whole state under the mesh (the state
        itself without one); sets the step's :class:`Layout`."""
        if self.mesh is None:
            return params, opt_state, ef_state
        self.layout = make_layout(self.model, params, self.mesh,
                                  self.dp_axes, self.fsdp_axes)
        self._step_fn = make_train_step(
            self.model, self.opt, self.cfg.microbatches,
            self.cfg.grad_compression, layout=self.layout)
        shard = functools.partial(self.layout.shard, cfg=self.model.cfg)
        if _residuals(ef_state):
            ef_state = shard(ef_state)
        return shard(params), OptState(opt_state.step, shard(opt_state.mu),
                                       shard(opt_state.nu)), ef_state

    def gather_state(self, params, opt_state: OptState, ef_state=None,
                     to_host: bool = False):
        """The whole state from a rank's blocks (a collective under a
        mesh; the state itself without one); ``ef_state`` None is left
        out.  ``to_host``: gathered a leaf at a time onto rank 0's host,
        None on the other ranks (a checkpoint's gather)."""
        if self.layout is None:
            return params, opt_state, ef_state
        g = functools.partial(self.layout.gather, to_host=to_host)
        if ef_state is not None and _residuals(ef_state):
            ef_state = g(ef_state)
        return g(params), OptState(opt_state.step, g(opt_state.mu),
                                   g(opt_state.nu)), ef_state

    def init_state(self, seed: int = 0):
        """(params, opt_state, ef_state) from the reference's keyed init:
        ``LM.init(key(seed))`` of the whole tree, then a rank's blocks of
        it under a mesh."""
        params = self.model.init(rnd.key(seed, self.model.device))
        ef = (ef_init(params) if self.cfg.grad_compression else
              torch.zeros((), dtype=torch.float32, device=self.model.device))
        return self._place(params, self.opt.init(params), ef)

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
        """(start_step, params, opt_state, ef_state): the newest
        checkpoint's whole leaves, as a rank's blocks under the mesh the
        trainer runs on (whatever mesh wrote them), or the init."""
        restored = self.store.restore(convert=self.from_flat)
        if restored is None:
            return (0, *self.init_state())
        step, state, _ = restored
        log.info("restored checkpoint at step %d", step)
        return (step, *self._place(*state))

    def _save(self, step, params, opt_state, ef_state) -> None:
        whole = self.gather_state(params, opt_state, ef_state, to_host=True)
        if comm.is_main_rank():
            self.store.save(step, self.to_flat(*whole))
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
        Returns (params, opt_state, info): under a mesh a rank's blocks
        of the params and optimizer state (:meth:`gather_state` makes
        them whole); ``info`` has the steps run, straggler events,
        skipped steps, the first and last loss of this run and every
        step's, its step seconds and the bytes of params and moments
        this rank held (``rank_state_bytes``)."""
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

        held = sum(t.numel() * t.element_size() for t in tree_leaves(
            [params, opt_state.mu, opt_state.nu]))
        return params, opt_state, {
            "rank_state_bytes": held,
            "steps": step - start,
            "straggler_events": self.straggler_events,
            "skipped_steps": self.skipped_steps,
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "losses": losses,
            "step_seconds": durations,
        }
