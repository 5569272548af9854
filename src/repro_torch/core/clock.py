"""Wall seconds per named stage of the pruning pass.

A stage's time includes its device work: on a CUDA device the clock
synchronises when a stage ends.  Passed as ``clock=`` to
``PruningEngine`` and ``pruner.prune_matrix``; without one, nothing is
timed and nothing synchronises.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class StageClock:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.seconds[stage] += time.perf_counter() - t0


def no_clock(stage: str) -> contextlib.AbstractContextManager:
    """The clock of an untimed run."""
    return contextlib.nullcontext()
