"""Calibration Hessian accumulation: H = mean_t 2·x_t·x_tᵀ (a port of
``repro.core.hessian``).

H is kept as the running *mean* over the tokens seen so far,
H_n = H_{n-1}·(n_prev/n) + 2·x·xᵀ/n, accumulated in f32 whatever the
activations' dtype.  Each update is one ``hessian_accum`` launch on the
card (``kernels.ops.hessian_update``: H ← β·H + α·2·XᵀX in place, no
m×m temporary), reading the token-major captures without a transposed
copy.  Dampening (Remark 4.1) adds γ·mean(diag H) to the diagonal.

The weighted (MoE) update of the reference waits for the port that
needs it (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops


class HessianAccumulator:
    """Streaming accumulator for the layer Hessian H = mean_t 2 x_t x_tᵀ.

        acc = HessianAccumulator(m, device)
        for x in batches:            # x: (m, B) layer inputs
            acc.update(x)            # or acc.update_tokens(x (B, m))
        h = acc.finalize()           # (m, m) f32
    """

    def __init__(self, dim: int, device="cpu", h: Optional[torch.Tensor] = None,
                 count: float = 0.0):
        self.dim = dim
        self.h = (h if h is not None else
                  torch.zeros((dim, dim), dtype=torch.float32, device=device))
        self.count = float(count)

    def update_tokens(self, tokens_first: torch.Tensor) -> None:
        """x: (B, m) — rows are calibration tokens (the capture layout)."""
        if tokens_first.dim() != 2 or tokens_first.shape[1] != self.dim:
            raise ValueError(f"expected (B, {self.dim}) activations, got "
                             f"{tuple(tokens_first.shape)}")
        b = tokens_first.shape[0]
        # the reference keeps the count in f32 and scales by f32 ratios
        new = np.float32(self.count) + np.float32(b)
        beta = float(np.float32(self.count) / new)
        alpha = float(np.float32(1.0) / new)
        ops.hessian_update(tokens_first.contiguous(), self.h, alpha, beta)
        self.count = float(new)

    def update(self, x: torch.Tensor) -> None:
        """x: (m, B) — columns are calibration tokens."""
        if x.dim() != 2 or x.shape[0] != self.dim:
            raise ValueError(f"expected ({self.dim}, B) activations, got "
                             f"{tuple(x.shape)}")
        self.update_tokens(x.T)

    def merge(self, other: "HessianAccumulator") -> "HessianAccumulator":
        """Token-weighted mean of two accumulators (e.g. data shards)."""
        total = self.count + other.count
        if total > 0:
            h = (self.h * self.count + other.h * other.count) / max(total, 1.0)
        else:
            h = self.h
        return HessianAccumulator(self.dim, h=h, count=total)

    @staticmethod
    def merge_many(accs: "list[HessianAccumulator]") -> "HessianAccumulator":
        """Token-weighted mean of N accumulators (the calibration-sharding
        merge of ``core.pipeline``)."""
        if len(accs) == 1:
            return accs[0]
        dim = accs[0].dim
        if any(a.dim != dim for a in accs):
            raise ValueError(
                f"cannot merge accumulators of dims {[a.dim for a in accs]}")
        total = float(np.float32(sum(np.float32(a.count) for a in accs)))
        if total <= 0:
            return HessianAccumulator(dim, h=accs[0].h, count=0.0)
        # the counts stay host scalars: no copy to the device, no sync
        h = accs[0].h * accs[0].count
        for a in accs[1:]:
            h.add_(a.h, alpha=a.count)
        return HessianAccumulator(dim, h=h / max(total, 1.0), count=total)

    def finalize(self) -> torch.Tensor:
        return self.h


def dampened_inverse(h: torch.Tensor, gamma: float = 0.01) -> torch.Tensor:
    """(H + γ·mean(diag H)·I)⁻¹ via Cholesky (Remark 4.1), with a 1e-8
    absolute floor on the dampening for dead input channels.  Row-major
    (the solver may hand back a column-major result): the nm_select
    kernel reads its diagonal blocks in place."""
    m = h.shape[0]
    damp = torch.clamp(gamma * torch.mean(torch.diagonal(h)), min=1e-8)
    eye = torch.eye(m, dtype=h.dtype, device=h.device)
    chol = torch.linalg.cholesky_ex(h + damp * eye).L
    return torch.cholesky_solve(eye, chol).contiguous()
