"""Step-indexed batching for training, calibration and evaluation (the
reference's ``repro.data.pipeline``).

``DataPipeline.batch_at(step)`` is a pure function of the step index:
the trainer resumes by continuing its step counter, with no iterator
state to checkpoint.

With a mesh — passed, or resolved from the active ``dist.use_mesh``
context at construction — every rank draws the same global batch from
the seed and keeps its own rows over the data (+pod) axes
(``dist.sharding.batch_sharding``, the reference's batch layout) of a
training batch, so a run's data does not depend on its rank count.
Calibration and evaluation batches stay whole on every rank: the
pruning engine shards the calibration by batch (``core.pipeline``), and
every rank evaluates the whole set.

A modality-frontend config's batches carry ``frontend_feats`` (B,
frontend_len, frontend_dim) bf16, drawn as the reference draws them:
``0.25 · normal(fold_in(batch_key(stream, step), 987))`` in f32, then
cast; the prefix-LM's text is ``seq_len − frontend_len`` tokens, so
that a sequence is ``seq_len`` positions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import random as rnd
from repro_torch.dist.api import current_ctx
from repro_torch.dist.sharding import batch_sharding
from repro_torch.data.synthetic import (STREAM_CALIB, STREAM_EVAL,
                                        STREAM_TRAIN, MarkovCorpus)
from repro_torch.models.base import ArchConfig

Batch = Dict[str, torch.Tensor]


class DataPipeline:
    def __init__(self, cfg: ArchConfig, global_batch: int, seq_len: int,
                 seed: int = 0, mesh=None,
                 dp_axes: Optional[Sequence[str]] = None, device="cpu"):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.corpus = MarkovCorpus(cfg.vocab_size, seed=seed, device=device)
        if mesh is None:
            ctx = current_ctx()
            if ctx is not None:
                mesh = ctx.mesh
                if dp_axes is None:
                    dp_axes = ctx.dp_axes
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes) if dp_axes is not None else ("data",)
        self.shard = (batch_sharding(mesh, self.dp_axes)
                      if mesh is not None else None)

    def _finish(self, batch: Batch) -> Batch:
        """This rank's rows of the global batch (all of it without a
        mesh)."""
        if self.shard is None:
            return batch
        return {k: self.shard.take(v) for k, v in batch.items()}

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
        return self._finish(self._make(STREAM_TRAIN, step))

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
