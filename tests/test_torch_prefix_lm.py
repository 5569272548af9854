"""The prefix-LM in the port — paligemma-3b: gemma-2b's backbone behind
a stubbed SigLIP patch frontend whose projected features go in front of
the text as a bidirectional prefix — at its ``SMOKE`` size, on the CPU
against the JAX package (``tests/frontend_parity.py`` holds the checks
and their tolerances):

* the config and its aliases, the keyed init (``embed/frontend_proj``
  included) and the checkpoint leaves' round trip;
* forward logits in f32 and bf16, the loss on both routes and its
  gradients, prefill and decode through the dense cache;
* the prefix's visibility: another image feature moves the first image
  position, a later text token no earlier position;
* ``DataPipeline``'s frontend draws, bit for bit;
* static ``ServeEngine(extra_batch=...)`` greedy streams and the packed
  leaves against the JAX engine's;
* MS 2:4 and SM 0.5 through the serial and the pipelined engine against
  the reference's serial engine, and the prune CLI in-process.
"""

import numpy as np
import pytest

import frontend_parity as fp
from frontend_parity import partitionable  # noqa: F401  (autouse)
from repro_torch.launch import prune as launch_prune

ARCH = "paligemma_3b"
SEQ = 32                 # calibration positions: 8 image + 24 text


def test_config_and_keyed_init_match_reference():
    fp.check_config_and_init(ARCH, "paligemma-3b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(dtype):
    fp.check_forward(ARCH, dtype)


def test_loss_and_grads_match_reference():
    fp.check_loss_and_grads(ARCH)


def test_prefill_and_decode_match_reference():
    fp.check_prefill_decode(ARCH)


def test_prefix_is_bidirectional():
    fp.check_visibility(ARCH)


def test_data_pipeline_frontend_draws_match_reference():
    fp.check_pipeline_draws(ARCH, SEQ)


def test_static_streams_match_jax_engine():
    fp.check_static_streams(ARCH)


def test_packed_leaves_match_reference():
    fp.check_packed_leaves(ARCH)


@pytest.mark.parametrize("method,spec", [("MS", "2:4"), ("SM", "0.5")])
@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_engine_matches_reference(method, spec, pipeline):
    tm, _, reports = fp.check_engine(ARCH, SEQ, method, spec, pipeline)
    assert len(reports) == 7 * tm.cfg.num_layers


def test_prune_cli_takes_the_model(tmp_path, capsys):
    """The launcher on random weights and ids: its random-id route draws
    the frontend's features from the same generator, and the text is
    --calib-seq minus the 8 image positions."""
    cfg = launch_prune.cfglib.get_smoke(ARCH)
    calib, ev = launch_prune.load_tokens(None, cfg.vocab_size, 8, SEQ,
                                         "cpu", cfg=cfg)
    assert calib[0]["tokens"].shape == (8, SEQ - cfg.frontend_len)
    assert calib[0]["frontend_feats"].shape == (8, cfg.frontend_len,
                                                cfg.frontend_dim)
    launch_prune.main(["--arch", "paligemma-3b", "--smoke", "--device",
                       "cpu", "--method", "MS", "--sparsity", "2:4",
                       "--calib-samples", "8", "--calib-seq", str(SEQ),
                       "--out", str(tmp_path)])
    out = capsys.readouterr().out
    ppl = [float(line.split()[-1]) for line in out.splitlines()
           if "ppl:" in line]
    assert len(ppl) == 2 and all(np.isfinite(ppl))
    assert (tmp_path / "pruned_params").is_dir()
