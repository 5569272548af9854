"""Layer-wise calibration capture (paper Sec. 3.3; a port of
``repro.core.calibration``).

The engine runs the calibration set through one segment in capture
mode, which returns the input ``x`` of every linear inside it under the
linear's name.  Each capture is flattened token-major, (tokens, d_in),
and feeds that linear's streaming Hessian accumulator directly — the
``hessian_accum`` kernel reads that layout, so nothing is transposed.

The reference's weighted captures ``(x, weights)`` (MoE routed tokens)
and its shard merges wait for the ports that need them (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

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

    def hessian(self, name: str) -> torch.Tensor:
        return self.accs[name].finalize()

    def names(self) -> Iterable[str]:
        return self.accs.keys()
