"""Sparsity specifications: unstructured rate or semi-structured N:M
(a copy of ``repro.core.sparsity``).

A spec is parsed from strings like "0.5" (50% unstructured) or "2:4"
(N:M semi-structured — N pruned out of every M consecutive weights in a
row, matching the paper's Sec. 4.3.2 / NVIDIA 2:4 convention).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SparsitySpec:
    """Either unstructured (rate in (0,1)) or semi-structured N:M."""

    rate: Optional[float] = None  # unstructured sparsity fraction
    n: Optional[int] = None       # pruned per group (semi-structured)
    m: Optional[int] = None       # group size (semi-structured)

    # ------------------------------------------------------------------
    @staticmethod
    def parse(text: str) -> "SparsitySpec":
        text = str(text).strip()
        if ":" in text:
            n_s, m_s = text.split(":")
            n, m = int(n_s), int(m_s)
            if not (0 < n < m):
                raise ValueError(f"invalid N:M sparsity {text!r}: need 0<N<M")
            return SparsitySpec(n=n, m=m)
        rate = float(text)
        if not (0.0 < rate < 1.0):
            raise ValueError(f"invalid unstructured sparsity {rate}: need (0,1)")
        return SparsitySpec(rate=rate)

    @staticmethod
    def unstructured(rate: float) -> "SparsitySpec":
        return SparsitySpec.parse(str(rate))

    @staticmethod
    def semi_structured(n: int, m: int) -> "SparsitySpec":
        return SparsitySpec.parse(f"{n}:{m}")

    # ------------------------------------------------------------------
    @property
    def is_semi_structured(self) -> bool:
        return self.n is not None

    @property
    def fraction(self) -> float:
        """Overall fraction of weights pruned."""
        if self.is_semi_structured:
            return self.n / self.m
        return float(self.rate)

    def pruned_per_row_block(self, block_cols: int) -> int:
        """Number of weights pruned in each row within a column block."""
        if self.is_semi_structured:
            if block_cols % self.m:
                raise ValueError(
                    f"block of {block_cols} cols not divisible by M={self.m}")
            return (block_cols // self.m) * self.n
        return int(math.floor(block_cols * self.rate + 1e-9))

    def validate_block(self, block_cols: int) -> None:
        if self.is_semi_structured and block_cols % self.m:
            raise ValueError(
                f"blocksize {block_cols} incompatible with {self.n}:{self.m}")

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        if self.is_semi_structured:
            return f"{self.n}:{self.m}"
        return f"{self.rate:g}"
