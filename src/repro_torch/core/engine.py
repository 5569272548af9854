"""Whole-model layer-wise pruning engine (paper Sec. 5; a port of
``repro.core.engine``).

The engine walks the model segment by segment (one transformer block
each), so peak memory is one segment's weights and Hessians:

  for each segment:
    1. run the calibration hiddens through the segment in capture mode,
       accumulating H = mean_t 2 x xᵀ per prunable linear;
    2. prune every linear with ``pruner.prune_matrix``;
    3. re-run the segment with the *pruned* weights to produce the next
       segment's calibration inputs.

Model contract (implemented by ``models.transformer.LM``):

  model.prunable_segments() -> list[SegmentSpec]
  model.calib_init(params, batch) -> h        # the hidden entering segment 0
  model.params_to_flat / params_from_jax      # only with a progress_store

By default (``pipeline="auto"``, as the reference) ``run`` drives the
batched scheduler of :mod:`repro_torch.core.pipeline`: stacked
calibration batches, one capture and one propagate per segment, and no
host sync mid-segment.  ``pipeline="off"`` keeps the paper's serial
per-batch loop, the semantic reference (equal masks up to near ties,
tested).

Fault tolerance: with a ``progress_store`` (``ckpt.PruneProgressStore``)
the engine checkpoints (next segment, params) after every segment, and
``run`` resumes from the last completed one — in both modes.  ``skip``
leaves every linear whose ``segment.linear`` name contains one of its
patterns unpruned.

Distribution: pass ``mesh=`` (a DeviceMesh) or construct the engine
inside ``repro_torch.dist.use_mesh(mesh)``.  Every process is one rank:
the pipelined scheduler shards the calibration batches over the data
(+pod) axes and all-reduces each linear's Hessian
(``core.distributed.allreduce_calibration``), and every layer solve
whose rows divide runs row-parallel over the ``model`` axis
(``prune_matrix_sharded``, Remark 4.2).  Every rank walks the same
segments and linears in the same order, so their collectives pair up.
Only rank 0 writes the progress store; the others wait for it at a
barrier, and read it back on resume.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.calibration import CalibrationSet
from repro_torch.core.clock import no_clock
from repro_torch.core.pruner import PruneResult, prune_matrix
from repro_torch.core.sparsity import SparsitySpec
from repro_torch.dist import comm
from repro_torch.dist.api import axis_size, current_ctx
from repro_torch.obs import Obs

log = logging.getLogger("repro_torch.engine")


@dataclasses.dataclass
class LinearSpec:
    """Handle to one prunable weight inside a segment's params: ``get``
    returns it in the paper's (n_out, m_in) orientation, ``set`` writes
    it back in the model's storage layout."""

    name: str
    get: Callable[[Any], torch.Tensor]
    set: Callable[[Any, torch.Tensor], Any]


@dataclasses.dataclass
class SegmentSpec:
    """One sequentially-prunable model segment (one block)."""

    name: str
    apply: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    #      (seg_params, h, capture: bool) -> (h_out, captures)
    linears: List[LinearSpec]
    get_params: Callable[[Any], Any]
    set_params: Callable[[Any, Any], Any]


@dataclasses.dataclass
class LinearReport:
    name: str
    method: str
    sparsity: float
    recon_error: float
    # serial mode: the solve's blocking wall-clock; pipelined mode: the
    # host's time to enqueue it (the stage seconds are in
    # engine.last_pipeline_stats)
    seconds: float
    shape: Tuple[int, int]


class PruningEngine:
    """Drives Algorithm 1 across a whole model, one segment at a time.

    ``clock`` (a ``core.clock.StageClock``) times the serial engine's
    stages: capture, hessian, propagate, and prune_matrix's inverse,
    mask, compensation and recon_error.  The pipelined engine reports
    its stages through ``obs`` and ``last_pipeline_stats`` instead."""

    def __init__(self, model, spec: SparsitySpec | str, method: str = "SM",
                 blocksize: int = 128, gamma: float = 0.01,
                 score: Optional[str] = None,
                 row_chunk: Optional[int] = None,
                 row_balanced: bool = False, skip: Sequence[str] = (),
                 progress_store=None, mesh=None, pipeline="auto",
                 calib_shard="auto", obs: Optional[Obs] = None,
                 clock=no_clock):
        self.model = model
        self.spec = SparsitySpec.parse(spec) if isinstance(spec, str) else spec
        self.method = method
        self.blocksize = blocksize
        self.gamma = gamma
        self.score = score
        self.row_chunk = row_chunk
        self.row_balanced = row_balanced
        self.skip = tuple(skip)
        self.progress_store = progress_store
        if pipeline not in ("auto", "on", "off"):
            raise ValueError(
                f"pipeline={pipeline!r} not in ('auto', 'on', 'off')")
        self.pipeline = pipeline
        self.calib_shard = calib_shard
        self.obs = obs if obs is not None else Obs.disabled()
        self.clock = clock
        self.last_pipeline_stats = None
        if mesh is None:
            ctx = current_ctx()
            mesh = ctx.mesh if ctx is not None else None
        self.mesh = mesh

    # ------------------------------------------------------------------
    def _should_skip(self, name: str) -> bool:
        return any(pat in name for pat in self.skip)

    def _model_parallel(self) -> int:
        """Ranks available for the row-parallel layer solve."""
        if self.mesh is None or "model" not in self.mesh.mesh_dim_names:
            return 1
        return axis_size(self.mesh, "model")

    def _prune_one(self, w: torch.Tensor, hmat: torch.Tensor,
                   sync: bool = True, clock=no_clock) -> PruneResult:
        """One layer solve — row-parallel over the mesh's ``model`` axis
        when it has more than one rank, the rows divide, and the spec
        selects per row (N:M, or ``row_balanced``: a global top-k must
        not change its selection under a mesh), else local.
        ``sync=False`` leaves the loss on the device (the reference's
        ``_prune_one(sync=False)``)."""
        tp = self._model_parallel()
        traceable = self.spec.is_semi_structured or self.row_balanced
        if tp > 1 and w.dim() == 2 and w.shape[0] % tp == 0 and traceable:
            from repro_torch.core.distributed import prune_matrix_sharded
            from repro_torch.core.pruner import reconstruction_error_traced

            w_new, mask = prune_matrix_sharded(
                w, hmat, self.spec, self.mesh, method=self.method,
                blocksize=self.blocksize, gamma=self.gamma,
                score=self.score, row_chunk=self.row_chunk)
            loss = reconstruction_error_traced(w, w_new, hmat)
            return PruneResult(w_new, mask, float(loss) if sync else loss,
                               self.method, self.spec)
        return prune_matrix(
            w, hmat, self.spec, method=self.method,
            blocksize=self.blocksize, gamma=self.gamma, score=self.score,
            row_chunk=self.row_chunk, row_balanced=self.row_balanced,
            clock=clock, sync=sync)

    def _resume(self, params: Any) -> Tuple[int, Any]:
        """(first segment to prune, params): the progress store's
        checkpoint when it holds one, else (0, params)."""
        if self.progress_store is None:
            return 0, params
        resumed = self.progress_store.load()
        if resumed is None:
            return 0, params
        start_seg, flat = resumed
        log.info("resuming pruning at segment %d", start_seg)
        return start_seg, self.model.params_from_jax(flat)

    def _checkpoint(self, next_segment: int, params: Any) -> None:
        if self.progress_store is None:
            return
        if comm.is_main_rank():
            self.progress_store.save(next_segment,
                                     self.model.params_to_flat(params))
        self._barrier()

    def _finish(self) -> None:
        if self.progress_store is None:
            return
        self._barrier()            # every rank is past its last read
        if comm.is_main_rank():
            self.progress_store.finalize()

    def _barrier(self) -> None:
        if self.mesh is not None:
            comm.barrier()

    def run(self, params: Any, calib_batches: Sequence[Any]
            ) -> Tuple[Any, List[LinearReport]]:
        """Prune the whole model; ``calib_batches``: token batches.  The
        pipelined scheduler unless ``pipeline="off"``."""
        if self.pipeline != "off":
            from repro_torch.core.pipeline import run_pipelined

            return run_pipelined(self, params, calib_batches)
        return self._run_serial(params, calib_batches)

    def _run_serial(self, params: Any, calib_batches: Sequence[Any]
                    ) -> Tuple[Any, List[LinearReport]]:
        """The paper's host-driven per-batch loop (``pipeline="off"``)."""
        self.last_pipeline_stats = None
        clock = self.clock
        reports: List[LinearReport] = []
        segments = self.model.prunable_segments()
        start_seg, params = self._resume(params)
        with clock("capture"):
            hiddens = [self.model.calib_init(params, b) for b in calib_batches]
        for seg in segments[:start_seg]:
            with clock("propagate"):
                seg_params = seg.get_params(params)
                hiddens = [seg.apply(seg_params, h, capture=False)[0]
                           for h in hiddens]
        for si in range(start_seg, len(segments)):
            seg = segments[si]
            seg_params = seg.get_params(params)

            # 1. capture + accumulate Hessians
            calib = CalibrationSet()
            for h in hiddens:
                with clock("capture"):
                    _, caps = seg.apply(seg_params, h, capture=True)
                with clock("hessian"):
                    calib.update(caps)
                del caps

            # 2. prune each linear
            for lin in seg.linears:
                name = f"{seg.name}.{lin.name}"
                if self._should_skip(name):
                    continue
                if lin.name not in calib.accs:
                    raise KeyError(
                        f"segment {seg.name}: no capture for linear "
                        f"{lin.name!r} (captures: {sorted(calib.names())})")
                w = lin.get(seg_params)
                t0 = time.monotonic()
                res = self._prune_one(w, calib.hessian(lin.name), clock=clock)
                seg_params = lin.set(seg_params, res.w)
                reports.append(LinearReport(
                    name=name, method=self.method, sparsity=res.sparsity,
                    recon_error=res.loss, seconds=time.monotonic() - t0,
                    shape=tuple(w.shape)))
            del calib

            # 3. write back + propagate with pruned weights
            params = seg.set_params(params, seg_params)
            with clock("propagate"):
                hiddens = [seg.apply(seg_params, h, capture=False)[0]
                           for h in hiddens]
            self._checkpoint(si + 1, params)
        self._finish()
        return params, reports


def summarize(reports: Sequence[LinearReport]) -> Dict[str, float]:
    if not reports:
        return {"linears": 0}
    return {
        "linears": len(reports),
        "mean_sparsity": float(
            sum(r.sparsity for r in reports) / len(reports)),
        "total_recon_error": float(sum(r.recon_error for r in reports)),
        "total_seconds": float(sum(r.seconds for r in reports)),
    }
