"""Layer-wise calibration capture (paper Sec. 3.3; a port of
``repro.core.calibration``).

The engine runs the calibration set through one segment in capture
mode, which returns the input ``x`` of every linear inside it under the
linear's name.  Each capture is flattened token-major, (tokens, d_in),
and feeds that linear's streaming Hessian accumulator directly — the
``hessian_accum`` kernel reads that layout, so nothing is transposed.

A capture is ``x`` (..., T, d_in), or ``(x, weights)`` with weights
(..., T) — a MoE expert's routed tokens and their validity — whose
0-weight tokens stay out of the Hessian (``update_weighted``; the
accumulator's count then stays on the device).  Leading dims are
flattened.  Per-shard sets (the pipelined scheduler's ``calib_shard``)
combine with :meth:`CalibrationSet.merge_all`.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.hessian import HessianAccumulator

Capture = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _flatten_capture(cap: Capture
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A capture → (x (T, d), weights (T,) or None)."""
    if isinstance(cap, tuple):
        x, w = cap
        x2 = x.reshape(-1, x.shape[-1])
        w2 = w.reshape(-1)
        if w2.shape[0] != x2.shape[0]:
            raise ValueError(f"capture weights {tuple(w.shape)} "
                             f"incompatible with x {tuple(x.shape)}")
        return x2, w2
    return cap.reshape(-1, cap.shape[-1]), None


class CalibrationSet:
    """Holds one Hessian accumulator per (named) linear in a segment."""

    def __init__(self):
        self.accs: Dict[str, HessianAccumulator] = {}

    def update(self, captures: Mapping[str, Capture]) -> None:
        for name, cap in captures.items():
            x2, w2 = _flatten_capture(cap)
            acc = self.accs.get(name)
            if acc is None:
                acc = HessianAccumulator(x2.shape[1], device=x2.device,
                                         weighted=w2 is not None)
                self.accs[name] = acc
            if w2 is None:
                acc.update_tokens(x2)
            else:
                acc.update_weighted_tokens(x2, w2)

    @classmethod
    def from_captures(cls, captures: Mapping[str, Capture]
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
