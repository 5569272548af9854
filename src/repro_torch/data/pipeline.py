"""Step-indexed batching for training, calibration and evaluation (the
reference's ``repro.data.pipeline``).

``DataPipeline.batch_at(step)`` is a pure function of the step index:
the trainer resumes by continuing its step counter, with no iterator
state to checkpoint.  One device only — the reference's ``mesh`` is
refused, as are modality-frontend configs (their archs are not ported).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.data.synthetic import (STREAM_CALIB, STREAM_EVAL,
                                        STREAM_TRAIN, MarkovCorpus)
from repro_torch.models.base import ArchConfig

Batch = Dict[str, torch.Tensor]


class DataPipeline:
    def __init__(self, cfg: ArchConfig, global_batch: int, seq_len: int,
                 seed: int = 0, mesh=None, device="cpu"):
        if mesh is not None:
            raise ValueError("DataPipeline: a mesh is not ported yet "
                             "(ROADMAP.md, Queue 1: distribution)")
        if getattr(cfg, "frontend", None) is not None:
            raise ValueError(f"{cfg.name}: frontend configs are not ported "
                             "yet (ROADMAP.md, Queue 1: other families)")
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.corpus = MarkovCorpus(cfg.vocab_size, seed=seed, device=device)

    def _make(self, stream: int, step: int) -> Batch:
        toks = self.corpus.batch_at(stream, step, self.global_batch,
                                    self.seq_len)
        return {"tokens": toks, "labels": toks}

    def batch_at(self, step: int) -> Batch:
        return self._make(STREAM_TRAIN, step)

    def eval_batch(self, step: int) -> Batch:
        return self._make(STREAM_EVAL, step)

    def calib_batch(self, idx: int) -> Batch:
        return self._make(STREAM_CALIB, idx)


def calibration_batches(cfg: ArchConfig, n_samples: int = 128,
                        seq_len: int = 128, batch: int = 8, seed: int = 0,
                        device="cpu") -> List[Batch]:
    """The paper's calibration protocol: ``n_samples`` segments of
    ``seq_len`` tokens, in batches of ``batch``, from the calibration
    stream."""
    pipe = DataPipeline(cfg, batch, seq_len, seed=seed, device=device)
    return [pipe.calib_batch(i) for i in range(max(1, n_samples // batch))]
