"""Calibration Hessian accumulation: H = mean_t 2·x_t·x_tᵀ (a port of
``repro.core.hessian``).

H is kept as the running *mean* over the tokens seen so far,
H_n = H_{n-1}·(n_prev/n) + 2·x·xᵀ/n, accumulated in f32 whatever the
activations' dtype.  Each update is one ``hessian_accum`` launch on the
card (``kernels.ops.hessian_update``: H ← β·H + α·2·XᵀX in place, no
m×m temporary), reading the token-major captures without a transposed
copy.  Dampening (Remark 4.1) adds γ·mean(diag H) to the diagonal.

The weighted update (:meth:`HessianAccumulator.update_weighted`, a MoE
expert's Hessian over its routed tokens) keeps its count — Σ of the
weights so far — on the device, as a 0-dim f32 tensor: the kernel reads
it with the weights, forms α and β itself and writes the new count back,
so no calibration batch reads anything back to the host.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.kernels import ops


class HessianAccumulator:
    """Streaming accumulator for the layer Hessian H = mean_t 2 x_t x_tᵀ.

        acc = HessianAccumulator(m, device)
        for x in batches:            # x: (m, B) layer inputs
            acc.update(x)            # or acc.update_tokens(x (B, m))
        h = acc.finalize()           # (m, m) f32

    ``count`` is a host float for the plain updates and a 0-dim f32
    device tensor once the accumulator is weighted (``weighted=True``, or
    a tensor ``count``); one accumulator takes one kind of update.
    """

    def __init__(self, dim: int, device="cpu", h: Optional[torch.Tensor] = None,
                 count: Union[float, torch.Tensor] = 0.0,
                 weighted: bool = False):
        self.dim = dim
        self.h = (h if h is not None else
                  torch.zeros((dim, dim), dtype=torch.float32, device=device))
        if isinstance(count, torch.Tensor):
            self.count = count
        elif weighted:
            self.count = torch.full((), float(count), dtype=torch.float32,
                                    device=self.h.device)
        else:
            self.count = float(count)

    @property
    def weighted(self) -> bool:
        return isinstance(self.count, torch.Tensor)

    def update_tokens(self, tokens_first: torch.Tensor) -> None:
        """x: (B, m) — rows are calibration tokens (the capture layout)."""
        if tokens_first.dim() != 2 or tokens_first.shape[1] != self.dim:
            raise ValueError(f"expected (B, {self.dim}) activations, got "
                             f"{tuple(tokens_first.shape)}")
        if self.weighted:
            raise ValueError("a weighted accumulator takes update_weighted")
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

    def update_weighted_tokens(self, x: torch.Tensor,
                               weights: torch.Tensor) -> None:
        """x: (B, m) tokens; weights: (B,) ≥ 0, bool (routing validity) or
        float (gate probabilities).  H ← H·c/(c+Σw) + 2·Xᵀdiag(w)X /
        max(c+Σw, 1e-12) with the count c on the device (the reference's
        ``_accum_update_weighted``): an accumulator whose tokens all
        weigh 0 keeps H = 0 and count 0."""
        if x.dim() != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected (B, {self.dim}) activations, got "
                             f"{tuple(x.shape)}")
        if weights.shape != (x.shape[0],):
            raise ValueError(f"weights {tuple(weights.shape)} incompatible "
                             f"with x {tuple(x.shape)}")
        if not self.weighted:
            raise ValueError("a plain accumulator takes update_tokens")
        ops.hessian_update_weighted(x.contiguous(), weights.contiguous(),
                                    self.h, self.count)

    def update_weighted(self, x: torch.Tensor, weights: torch.Tensor) -> None:
        """x: (m, B) — columns are tokens; weights: (B,)."""
        if x.dim() != 2 or x.shape[0] != self.dim:
            raise ValueError(f"expected ({self.dim}, B) activations, got "
                             f"{tuple(x.shape)}")
        self.update_weighted_tokens(x.T, weights)

    def merge(self, other: "HessianAccumulator") -> "HessianAccumulator":
        """Token-weighted mean of two accumulators (e.g. data shards)."""
        if self.weighted or other.weighted:
            return HessianAccumulator.merge_many([self, other])
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
        if any(a.weighted for a in accs):
            return HessianAccumulator._merge_weighted(accs)
        total = float(np.float32(sum(np.float32(a.count) for a in accs)))
        if total <= 0:
            return HessianAccumulator(dim, h=accs[0].h, count=0.0)
        # the counts stay host scalars: no copy to the device, no sync.
        # Each H·n is rounded before the sum (no fused multiply-add), the
        # arithmetic of core.distributed.psum_hessian's all-reduce: two
        # shards merged here or across two ranks give the same bits
        h = accs[0].h * accs[0].count
        for a in accs[1:]:
            h += a.h * a.count
        return HessianAccumulator(dim, h=h / max(total, 1.0), count=total)

    @staticmethod
    def _merge_weighted(accs: "list[HessianAccumulator]"
                        ) -> "HessianAccumulator":
        """The reference's ``_merge_many`` with the counts on the device:
        Σ c_s·H_s / max(Σ c_s, 1), or the first H when every count is 0 —
        chosen on the device, so nothing is read back."""
        if not all(a.weighted for a in accs):
            raise ValueError("cannot merge weighted and plain accumulators")
        cs = torch.stack([a.count for a in accs])
        total = cs.sum()
        h = torch.einsum("s,sij->ij", cs, torch.stack([a.h for a in accs]))
        h = torch.where(total > 0, h / torch.clamp(total, min=1.0),
                        accs[0].h)
        return HessianAccumulator(accs[0].dim, h=h, count=total)

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
