"""The encoder-decoder in the port — seamless-m4t-large-v2: a stubbed
speech frontend's frames through a non-causal encoder stack, and a
decoder whose blocks follow their causal self-attention with
cross-attention over the encoder's output — at its ``SMOKE`` size, on
the CPU against the JAX package (``tests/frontend_parity.py`` holds the
checks and their tolerances):

* the config and its aliases, the keyed init (``enc/layers``, ``enc/ln``,
  the ``xattn`` linears) and the checkpoint leaves' round trip;
* forward logits in f32 and bf16, the loss on both routes and its
  gradients, prefill (the cross K / V cached once) and decode;
* who sees whom: other frames move every decoder position, a later
  token no earlier one;
* ``DataPipeline``'s frontend draws, bit for bit;
* static ``ServeEngine(extra_batch=...)`` greedy streams and the packed
  leaves (encoder, self- and cross-attention, MLPs) against the JAX
  engine's;
* the ``enc{li}`` segments before the periods, their linears and
  captures, and MS 2:4 and SM 0.5 through the serial and the pipelined
  engine (the ``{"h", "enc"}`` state stacked leaf by leaf) against the
  reference's serial engine.
"""

import jax
import numpy as np
import pytest
import torch

import frontend_parity as fp
from frontend_parity import partitionable  # noqa: F401  (autouse)
from repro.ckpt.store import _flatten

ARCH = "seamless_m4t_large_v2"
SEQ = 24


def test_config_and_keyed_init_match_reference():
    fp.check_config_and_init(ARCH, "seamless-m4t-large-v2")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(dtype):
    fp.check_forward(ARCH, dtype)


def test_loss_and_grads_match_reference():
    fp.check_loss_and_grads(ARCH)


def test_prefill_caches_cross_kv_and_decode_matches_reference():
    fp.check_prefill_decode(ARCH)


def test_cross_attention_sees_every_frame():
    fp.check_visibility(ARCH)


def test_data_pipeline_frontend_draws_match_reference():
    fp.check_pipeline_draws(ARCH, SEQ)


def test_static_streams_match_jax_engine():
    fp.check_static_streams(ARCH)


def test_packed_leaves_match_reference():
    fp.check_packed_leaves(ARCH)


def test_segments_and_captures_match_reference():
    """``enc0`` … then ``period0`` …, with the reference's linear names in
    its order; each first segment's captures (the cross-attention's
    ``xattn.wk`` / ``wv`` over the normed encoder output) within TOL."""
    jm, jp, tm, calib, _ = fp.prune_setup(ARCH, SEQ)
    tp = tm.params_from_jax(_flatten(jp))
    jsegs, tsegs = jm.prunable_segments(), tm.prunable_segments()
    assert [s.name for s in tsegs] == [s.name for s in jsegs]
    assert [s.name for s in tsegs[:3]] == ["enc0", "enc1", "period0"]
    for ts, js in zip(tsegs, jsegs):
        assert [x.name for x in ts.linears] == [x.name for x in js.linears]
    assert "_encln" in tsegs[2].get_params(tp)
    jstate = jm.calib_init(jp, calib[0])
    tstate = tm.calib_init(tp, fp.t_batch(calib[0]))
    assert tstate.keys() == {"h", "enc"}
    for i in (0, 1, 2):
        js, ts = jsegs[i], tsegs[i]
        jstate, jcaps = jax.jit(lambda p, s, a=js.apply: a(
            p, s, capture=True))(js.get_params(jp), jstate)
        tstate, tcaps = ts.apply(ts.get_params(tp), tstate, capture=True)
        assert tcaps.keys() == jcaps.keys()
        for key in jcaps:
            np.testing.assert_allclose(tcaps[key].numpy(),
                                       np.asarray(jcaps[key]), rtol=fp.TOL,
                                       atol=fp.TOL, err_msg=key)
    assert "s0.xattn.wk" in tcaps and tcaps["s0.xattn.wk"].shape[1] == 16
    for key in ("h", "enc"):
        np.testing.assert_allclose(tstate[key].numpy(),
                                   np.asarray(jstate[key]), rtol=fp.TOL,
                                   atol=fp.TOL)


@pytest.mark.parametrize("method,spec", [("MS", "2:4"), ("SM", "0.5")])
@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_engine_matches_reference(method, spec, pipeline):
    tm, tpr, reports = fp.check_engine(ARCH, SEQ, method, spec, pipeline)
    cfg = tm.cfg
    assert len(reports) == 6 * cfg.enc_layers + 10 * cfg.num_layers
    assert reports[0].name == "enc0.attn.wq"
    assert all(isinstance(lp["xattn"]["wk"], torch.Tensor)
               for lp in tpr["layers"])
