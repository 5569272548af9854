"""Whole-model layer-wise pruning engine (paper Sec. 5; a port of
``repro.core.engine`` with the serial semantics of ``pipeline="off"``).

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

The reference's pipelined scheduler (``core/pipeline.py``), mesh-sharded
solves, ``PruneProgressStore`` resume and name-pattern ``skip`` are not
ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.calibration import CalibrationSet
from repro_torch.core.clock import no_clock
from repro_torch.core.pruner import PruneResult, prune_matrix
from repro_torch.core.sparsity import SparsitySpec


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
    seconds: float              # the solve's blocking wall-clock
    shape: Tuple[int, int]


class PruningEngine:
    """Drives Algorithm 1 across a whole model, one segment at a time.

    ``clock`` (a ``core.clock.StageClock``) times the stages: capture,
    hessian, propagate, and prune_matrix's inverse, mask, compensation
    and recon_error."""

    def __init__(self, model, spec: SparsitySpec | str, method: str = "SM",
                 blocksize: int = 128, gamma: float = 0.01,
                 score: Optional[str] = None,
                 row_chunk: Optional[int] = None,
                 row_balanced: bool = False, clock=no_clock):
        self.model = model
        self.spec = SparsitySpec.parse(spec) if isinstance(spec, str) else spec
        self.method = method
        self.blocksize = blocksize
        self.gamma = gamma
        self.score = score
        self.row_chunk = row_chunk
        self.row_balanced = row_balanced
        self.clock = clock

    def run(self, params: Any, calib_batches: Sequence[Any]
            ) -> Tuple[Any, List[LinearReport]]:
        """Prune the whole model; ``calib_batches``: token batches."""
        clock = self.clock
        reports: List[LinearReport] = []
        with clock("capture"):
            hiddens = [self.model.calib_init(params, b) for b in calib_batches]
        for seg in self.model.prunable_segments():
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
                if lin.name not in calib.accs:
                    raise KeyError(
                        f"segment {seg.name}: no capture for linear "
                        f"{lin.name!r} (captures: {sorted(calib.names())})")
                w = lin.get(seg_params)
                t0 = time.monotonic()
                res: PruneResult = prune_matrix(
                    w, calib.hessian(lin.name), self.spec,
                    method=self.method, blocksize=self.blocksize,
                    gamma=self.gamma, score=self.score,
                    row_chunk=self.row_chunk,
                    row_balanced=self.row_balanced, clock=clock)
                seg_params = lin.set(seg_params, res.w)
                reports.append(LinearReport(
                    name=f"{seg.name}.{lin.name}", method=self.method,
                    sparsity=res.sparsity, recon_error=res.loss,
                    seconds=time.monotonic() - t0, shape=tuple(w.shape)))
            del calib

            # 3. write back + propagate with pruned weights
            params = seg.set_params(params, seg_params)
            with clock("propagate"):
                hiddens = [seg.apply(seg_params, h, capture=False)[0]
                           for h in hiddens]
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
