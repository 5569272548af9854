"""Layer-wise calibration capture (paper Sec. 3.3; a port of
``repro.core.calibration``).

The engine runs the calibration set through one segment in capture
mode, which returns the input ``x`` of every linear inside it under the
linear's name.  Each capture is flattened token-major, (tokens, d_in),
and feeds that linear's streaming Hessian accumulator directly — the
``hessian_accum`` kernel reads that layout, so nothing is transposed.

Per-shard sets (the pipelined scheduler's ``calib_shard``) combine with
:meth:`CalibrationSet.merge_all`.  The reference's weighted captures
``(x, weights)`` (MoE routed tokens) wait for the port that needs them
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Sequence

import torch

from repro_torch.core.hessian import HessianAccumulator


class CalibrationSet:
    """Holds one Hessian accumulator per (named) linear in a segment."""

    def __init__(self):
        self.accs: Dict[str, HessianAccumulator] = {}

    def update(self, captures: Mapping[str, torch.Tensor]) -> None:
        for name, cap in captures.items():
            if isinstance(cap, tuple):
                raise NotImplementedError(
                    f"capture {name!r}: weighted (MoE) captures are not "
                    "ported (ROADMAP.md)")
            x2 = cap.reshape(-1, cap.shape[-1])
            acc = self.accs.get(name)
            if acc is None:
                acc = HessianAccumulator(x2.shape[1], device=x2.device)
                self.accs[name] = acc
            acc.update_tokens(x2)

    @classmethod
    def from_captures(cls, captures: Mapping[str, torch.Tensor]
                      ) -> "CalibrationSet":
        """One-shot construction from a single (batched) capture dict."""
        out = cls()
        out.update(captures)
        return out

    def merge(self, other: "CalibrationSet") -> "CalibrationSet":
        out = CalibrationSet()
        for name in set(self.accs) | set(other.accs):
            a, b = self.accs.get(name), other.accs.get(name)
            out.accs[name] = (b if a is None else a if b is None
                              else a.merge(b))
        return out

    @classmethod
    def merge_all(cls, sets: Sequence["CalibrationSet"]) -> "CalibrationSet":
        """Merge N per-shard sets, one weighted mean per linear
        (``HessianAccumulator.merge_many``)."""
        sets = list(sets)
        if len(sets) == 1:
            return sets[0]
        out = cls()
        names = set().union(*(set(s.accs) for s in sets))
        for name in sorted(names):
            out.accs[name] = HessianAccumulator.merge_many(
                [s.accs[name] for s in sets if name in s.accs])
        return out

    def hessian(self, name: str) -> torch.Tensor:
        return self.accs[name].finalize()

    def names(self) -> Iterable[str]:
        return self.accs.keys()
