"""Pipelined calibration/solve scheduler — the pruning engine's default
path (a port of ``repro.core.pipeline``).

Algorithm 1 is serial over segments, but within a segment there are
three stages whose only dependencies are tensor values:

  capture(i)    calibration hiddens through segment i (dense weights),
                accumulating the per-linear Hessians
  solve(i)      per-linear layer solves from those Hessians
  propagate(i)  segment i re-run with the *pruned* weights → the inputs
                of segment i+1

The serial engine (``PruningEngine(pipeline="off")``) runs capture and
propagate once per calibration batch and reads every solve's loss back
as it goes.  The scheduler here instead

  - stacks the calibration batches into one batched hidden state per
    calibration shard: one capture and one propagate apply per segment
    and shard instead of one per batch — each linear's Hessian is one
    ``hessian_accum`` launch over every calibration token, and each
    attention one ``flash_attn`` launch;
  - never blocks the host mid-segment: the solves leave their losses on
    the device (``pruner.prune_matrix(sync=False)``), and report scalars
    (sparsity, reconstruction error) are read back once, when the run
    ends;
  - frees each shard's input state as soon as its propagated output
    exists (the reference donates the buffers to ``jit``), so peak
    activation memory stays about one segment;
  - under a mesh with data (+pod) axes, shards the calibration batches
    over them (``calib_shard``): each rank embeds, captures and
    propagates only its own shard — batch i goes to the rank of index
    i mod dp, the reference's round robin — and each linear's Hessian
    merges across the ranks in one ``all_reduce``
    (``core.distributed.allreduce_calibration``).  When the shards do
    not map one to a rank, every rank accumulates all of them and
    merges them locally (``CalibrationSet.merge_all``), as the reference
    falls back.

What the reference has and this port does not: ``jit`` (PyTorch runs
eagerly, so there is no compile count and no
``prune_compiles_total``), and ``strict_collective_sync``, which works
around XLA CPU deadlocks between concurrent collective programs: a rank
here issues its collectives in program order.  On one card the stages
cannot overlap on separate streams: capture(i+1) consumes propagate(i),
which needs every solve of segment i.

``progress_store`` checkpoints land on segment boundaries, the only
host syncs of the run besides those inside the solves.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import (Any, Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.core.calibration import CalibrationSet
from repro_torch.dist.api import axis_size
from repro_torch.dist.mesh import dp_axes_of
from repro_torch.dist.sharding import batch_sharding
from repro_torch.obs import Obs

# a calibration state: the hidden, or the encoder-decoder's {"h", "enc"}
State = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _stack(states: Sequence[State]) -> State:
    if isinstance(states[0], dict):
        return {k: torch.cat([st[k] for st in states]) for k in states[0]}
    return torch.cat(list(states))


@dataclasses.dataclass
class PipelineStats:
    """Per-run scheduler accounting (``engine.last_pipeline_stats``).

    By default the per-stage seconds are host time up to the stage's last
    enqueue (the card drains its queue concurrently); with
    ``instrument=True`` every stage synchronises the device at its end,
    so the seconds are the stages' true costs."""

    segments: int = 0
    calib_shards: int = 1
    batches: int = 0
    capture_s: float = 0.0
    solve_s: float = 0.0
    propagate_s: float = 0.0
    wall_s: float = 0.0
    instrumented: bool = False


def _resolve_shards(calib_shard, mesh, dp_axes, n_batches: int) -> int:
    """How many calibration shards to accumulate separately (the
    reference's rule): ``"auto"`` takes one shard per data (+pod) rank
    when the batch count allows it; ``"off"``/None/1 one shard; ``"on"``
    one per data rank, at most one per batch; an int forces a count."""
    if isinstance(calib_shard, bool):        # before int tests: True == 1
        calib_shard = "on" if calib_shard else "off"
    if calib_shard in ("off", None, 1):
        return 1
    dp = 1
    if mesh is not None:
        for a in dp_axes:
            if a in mesh.mesh_dim_names:
                dp *= axis_size(mesh, a)
    if isinstance(calib_shard, int):
        return max(1, min(calib_shard, n_batches))
    if calib_shard == "auto":
        return dp if (dp > 1 and n_batches >= dp) else 1
    if calib_shard == "on":
        if dp <= 1:
            return 1
        return min(dp, n_batches)
    raise ValueError(f"calib_shard={calib_shard!r} not in "
                     "('auto', 'on', 'off') or int")


class SegmentScheduler:
    """Batched, optionally sharded capture/propagate over segments."""

    def __init__(self, calib_shard="auto", instrument: bool = False,
                 obs: Optional[Obs] = None, device="cpu", mesh=None):
        self.calib_shard = calib_shard
        self.mesh = mesh
        self.dp_axes = dp_axes_of(mesh) if mesh is not None else ()
        # set by shard_batches: whether each rank holds one shard of the
        # data (+pod) ranks' (then capture all-reduces the Hessians)
        self.rank_sharded = False
        self.device = torch.device(device)
        self.stats = PipelineStats(instrumented=instrument)
        self._instrument = instrument
        # stage seconds and spans go through the caller's obs bundle:
        # prune_stage_seconds_total{stage} mirrors stats.<stage>_s
        self.obs = obs if obs is not None else Obs.disabled()
        reg = self.obs.metrics
        self._stage_s = reg.counter(
            "prune_stage_seconds_total",
            "Pipelined prune wall seconds by stage "
            "(capture/solve/propagate)", ("stage",))

    @contextlib.contextmanager
    def timed(self, stage: str) -> Iterator[None]:
        """Accrue host time into ``stats.<stage>_s``, the registry and
        the trace; with instrumentation on, synchronise the device first
        so that the time is the stage's device cost too."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            if self._instrument and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.monotonic()
            setattr(self.stats, f"{stage}_s",
                    getattr(self.stats, f"{stage}_s") + t1 - t0)
            self._stage_s.labels(stage=stage).inc(t1 - t0)
            self.obs.tracer.complete(f"prune_{stage}", t0, t1, track="prune")

    def shard_batches(self, batches: Sequence[Any]) -> List[List[Any]]:
        """The calibration batches grouped into this rank's shards,
        round-robin (batch i goes to shard i mod n): every shard without
        a mesh, or when the shards do not map one to a data (+pod) rank;
        else the one shard of this rank's index."""
        batches = list(batches)
        self.stats.batches = len(batches)
        n = _resolve_shards(self.calib_shard, self.mesh, self.dp_axes,
                            len(batches))
        self.stats.calib_shards = n
        groups = [batches[i::n] for i in range(n)]
        shard = (batch_sharding(self.mesh, self.dp_axes)
                 if self.mesh is not None else None)
        self.rank_sharded = shard is not None and n > 1 and n == shard.count
        return [groups[shard.index]] if self.rank_sharded else groups

    @staticmethod
    def stack_states(groups: Sequence[Sequence[State]]) -> List[State]:
        """Per-shard lists of per-batch states → one batched state per
        shard.  A state is a tensor or a dict of them (the
        encoder-decoder's ``{"h", "enc"}``), stacked leaf by leaf along
        the batch dim."""
        return [_stack(g) if len(g) > 1 else g[0] for g in groups]

    def shard_states(self, per_batch_states: Sequence[State]
                     ) -> List[State]:
        """:meth:`shard_batches` then :meth:`stack_states` of states
        already computed."""
        return self.stack_states(self.shard_batches(per_batch_states))

    def capture(self, seg, seg_params, shard_states: List[State]
                ) -> CalibrationSet:
        """Run the calibration through ``seg`` in capture mode, one
        batched apply per shard, and merge the per-shard Hessians: across
        the data (+pod) ranks when each holds one shard, else locally."""
        with self.timed("capture"):
            sets = []
            for st in shard_states:
                _, caps = seg.apply(seg_params, st, capture=True)
                sets.append(CalibrationSet.from_captures(caps))
                del caps
            if self.rank_sharded:
                from repro_torch.core.distributed import (
                    allreduce_calibration)

                return allreduce_calibration(sets[0], self.mesh,
                                             self.dp_axes)
            return CalibrationSet.merge_all(sets)

    def propagate(self, seg, seg_params, shard_states: List[State]
                  ) -> List[State]:
        """Re-run ``seg`` (pruned weights) over every shard; returns the
        next segment's inputs.  Consumes ``shard_states``: the list is
        emptied as it goes, so each input is freed once its output
        exists."""
        out: List[State] = []
        with self.timed("propagate"):
            while shard_states:
                st = shard_states.pop(0)
                out.append(seg.apply(seg_params, st, capture=False)[0])
                del st
        return out


def run_pipelined(engine, params: Any, calib_batches: Sequence[Any],
                  instrument: bool = False) -> Tuple[Any, List]:
    """Drive Algorithm 1 with the pipelined scheduler.

    Semantics match the serial engine: the same segment order, the same
    skip, resume and checkpoint behaviour (``progress_store`` saves land
    on segment boundaries) and the same reports — only the batching and
    the host syncs differ."""
    from repro_torch.core.engine import LinearReport

    model = engine.model
    segments = model.prunable_segments()
    start_seg, params = engine._resume(params)

    sched = SegmentScheduler(calib_shard=engine.calib_shard,
                             instrument=instrument, obs=engine.obs,
                             device=getattr(model, "device", "cpu"),
                             mesh=engine.mesh)
    t_wall = time.monotonic()
    # a rank embeds only the batches of its own shards
    states = sched.stack_states([[model.calib_init(params, b) for b in g]
                                 for g in sched.shard_batches(calib_batches)])
    # fast-forward through already-pruned segments (resume): the same
    # propagate recomputes their pruned outputs bit for bit
    for seg in segments[:start_seg]:
        states = sched.propagate(seg, seg.get_params(params), states)

    # (name, sparsity, loss, seconds, shape): sparsity and loss stay 0-dim
    # device tensors until the run ends
    pending: List[Tuple[str, torch.Tensor, Any, float, Tuple[int, ...]]] = []
    for si in range(start_seg, len(segments)):
        seg = segments[si]
        seg_params = seg.get_params(params)
        calib = sched.capture(seg, seg_params, states)

        with sched.timed("solve"):
            for lin in seg.linears:
                name = f"{seg.name}.{lin.name}"
                if engine._should_skip(name):
                    continue
                if lin.name not in calib.accs:
                    raise KeyError(
                        f"segment {seg.name}: no capture for linear "
                        f"{lin.name!r} (captures: {sorted(calib.names())})")
                w = lin.get(seg_params)
                t0 = time.monotonic()
                res = engine._prune_one(w, calib.hessian(lin.name),
                                        sync=False)
                seg_params = lin.set(seg_params, res.w)
                pending.append((name, res.mask.float().mean(), res.loss,
                                time.monotonic() - t0, tuple(w.shape)))
        del calib

        params = seg.set_params(params, seg_params)
        states = sched.propagate(seg, seg_params, states)
        sched.stats.segments += 1
        engine._checkpoint(si + 1, params)

    engine._finish()
    # the report scalars come back in one transfer
    scalars = (torch.stack([torch.stack([sp, loss.float()])
                            for _, sp, loss, _, _ in pending]).tolist()
               if pending else [])
    reports = [LinearReport(name=name, method=engine.method,
                            sparsity=sp, recon_error=err, seconds=secs,
                            shape=shape)
               for (name, _, _, secs, shape), (sp, err)
               in zip(pending, scalars)]
    sched.stats.wall_s = time.monotonic() - t_wall
    engine.last_pipeline_stats = sched.stats
    return params, reports
