"""Shared fixtures. NOTE: no XLA_FLAGS here — tests see 1 CPU device by
design (the 512-device mesh exists only inside launch/dryrun.py and the
subprocess-based tests in test_dist.py)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.data import DataPipeline
from repro.models import LM
from repro.optim import AdamW
from repro.optim.schedules import warmup_cosine
from repro.train import TrainConfig, Trainer


@pytest.fixture(scope="session")
def tiny_lm():
    """The paper-tiny-lm trained ~200 steps on the synthetic corpus.

    Session-scoped: trained once, shared by pruning/serving/benchmark
    tests. Returns (model, params, pipeline)."""
    cfg = get_config("paper_tiny_lm")
    model = LM(cfg)
    pipe = DataPipeline(cfg, global_batch=16, seq_len=64, seed=0)
    opt = AdamW(lr=warmup_cosine(1e-3, 20, 200))
    out = "/tmp/repro_test_tiny_lm"
    tc = TrainConfig(total_steps=200, global_batch=16, seq_len=64,
                     ckpt_every=200, out_dir=out, log_every=100)
    trainer = Trainer(model, opt, pipe, tc)
    params, _, _ = trainer.run()   # resumes from ckpt if already trained
    return model, params, pipe


def eval_ppl(model, params, pipe, n=6):
    tot = cnt = 0.0
    for i in range(n):
        _, m = model.loss_fn(params, pipe.eval_batch(i))
        tot += float(m["ce"]) * float(m["tokens"])
        cnt += float(m["tokens"])
    return float(np.exp(tot / cnt))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def random_psd_hessian(key, m, scale=1.0):
    """A well-conditioned random PSD 'calibration' Hessian."""
    x = jax.random.normal(key, (m, 4 * m))
    return scale * (2.0 * (x @ x.T) / (4 * m)) + 0.1 * jnp.eye(m)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where CUDA is missing")
