"""Step-indexed batching for training, calibration and evaluation (the
reference's ``repro.data.pipeline``).

``DataPipeline.batch_at(step)`` is a pure function of the step index:
the trainer resumes by continuing its step counter, with no iterator
state to checkpoint.  One device only — the reference's ``mesh`` is
refused.

A modality-frontend config's batches carry ``frontend_feats`` (B,
frontend_len, frontend_dim) bf16, drawn as the reference draws them:
``0.25 · normal(fold_in(batch_key(stream, step), 987))`` in f32, then
cast; the prefix-LM's text is ``seq_len − frontend_len`` tokens, so
that a sequence is ``seq_len`` positions.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch import random as rnd
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
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.corpus = MarkovCorpus(cfg.vocab_size, seed=seed, device=device)

    def _make(self, stream: int, step: int) -> Batch:
        cfg = self.cfg
        t_text = self.seq_len
        if cfg.frontend is not None and not cfg.encdec:
            t_text = self.seq_len - cfg.frontend_len
        toks = self.corpus.batch_at(stream, step, self.global_batch, t_text)
        batch = {"tokens": toks, "labels": toks}
        if cfg.frontend is not None:
            fkey = rnd.fold_in(self.corpus.batch_key(stream, step), 987)
            batch["frontend_feats"] = (0.25 * rnd.normal(
                fkey, (self.global_batch, cfg.frontend_len,
                       cfg.frontend_dim))).to(torch.bfloat16)
        return batch

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
