"""Full-sequence attention in the port against the JAX package, on CPU.

On the CPU ``ops.attention`` and the model's full-sequence branch take
``flash_attn_plain`` (the CUDA kernel is held against it on the card in
``tests/test_torch_cuda.py``).  Tolerances are the reference's own for
its kernel (``tests/test_kernels.py``): 2e-5 in f32, where both sides
run the same softmax in f32 and differ only in summation order, and
3e-2 with bf16 inputs.  The model-level comparisons keep the 1e-4 of
``tests/test_torch_model.py``.

One case pins a fault of the reference: its ``ops.attention`` pads T to
a tile multiple with zero keys, which join a non-causal softmax.  The
prefix-LM's bidirectional prefix and non-causal S ≠ T (cross-attention)
are held against the reference's ``_sdpa`` under its masks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import _flatten
from repro.configs import get_config as j_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import LM as JLM
from repro.models import layers as jlayers
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import flash_attn, flash_attn_plain
from repro_torch.models import layers
from repro_torch.models.transformer import LM

F32_TOL = 2e-5
BF16_TOL = 3e-2
MODEL_TOL = 1e-4


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("bh,t,d", [(2, 128, 32), (4, 256, 64),
                                    (1, 384, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_reference_sweep(bh, t, d, causal):
    q, k, v = _qkv(bh * t + d, (bh, t, d))
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (bh, t, d)
    want_kernel = jops.attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    want_ref = jref.flash_attn_ref(*map(jnp.asarray, (q, k, v)),
                                   causal=causal)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_bf16_matches_reference(causal):
    q, k, v = _qkv(9, (2, 128, 64))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    got = ops.attention(tq, tk, tv, causal=causal)
    want = jref.flash_attn_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("t", [100, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_exact_at_ragged_t(t, causal):
    q, k, v = _qkv(t, (2, t, 32))
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want = jref.flash_attn_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_reference_attention_pads_ragged_non_causal():
    """The reference's fault: at T = 200 its zero-padded keys join the
    non-causal softmax, so it leaves its own plain version (the port
    does not: the case above)."""
    q, k, v = map(jnp.asarray, _qkv(200, (2, 200, 32)))
    padded = jops.attention(q, k, v, causal=False)
    exact = jref.flash_attn_ref(q, k, v, causal=False)
    assert float(jnp.max(jnp.abs(padded - exact))) > 1e-2
    causal = jops.attention(q, k, v, causal=True)
    np.testing.assert_allclose(np.asarray(causal),
                               np.asarray(jref.flash_attn_ref(q, k, v)),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_grouped_layout_matches_reference_per_head(h, kv, causal):
    """The model's (B, T, H, hd) / (B, T, KV, hd) layout: head i reads kv
    head i // (H / KV), as the reference's ``_sdpa`` groups them."""
    rng = np.random.default_rng(h * 10 + kv)
    q = rng.standard_normal((2, 70, h, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 70, kv, 32)).astype(np.float32)
            for _ in range(2))
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.shape == (2, 70, h, 32)
    g = h // kv
    for i in range(h):
        want = jref.flash_attn_ref(jnp.asarray(q[:, :, i]),
                                   jnp.asarray(k[:, :, i // g]),
                                   jnp.asarray(v[:, :, i // g]),
                                   causal=causal)
        np.testing.assert_allclose(got[:, :, i].numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)


def test_cpu_flash_attn_is_the_plain_version_and_launches_nothing():
    q, k, v = map(torch.from_numpy, _qkv(1, (1, 40, 2, 16)))
    flash_attn.launches = 0
    assert torch.equal(flash_attn(q, k, v, True),
                       flash_attn_plain(q, k, v, True))
    assert flash_attn.launches == 0


# ----------------------------------------------------------------------
# the sliding window (attn_local)
# ----------------------------------------------------------------------
def _grouped(seed, t, hd, h=4, kv=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, t, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, t, kv, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("t,window", [(37, 8), (37, 1), (37, 37),
                                      (37, 100), (129, 64), (200, 17)])
@pytest.mark.parametrize("hd", [16, 64, 256])
def test_windowed_attention_matches_reference_sdpa(t, window, hd):
    """``flash_attn_plain(window=)`` (what a CPU tensor takes) against the
    reference's ``_sdpa`` under ``causal_mask(t, t, window)``: ragged T,
    window 1 (each row sees itself), window ≥ T (no key masked)."""
    q, k, v = _grouped(t * hd + window, t, hd)
    got = flash_attn_plain(*map(torch.from_numpy, (q, k, v)), True, window)
    want = jlayers._sdpa(*map(jnp.asarray, (q, k, v)),
                         jlayers.causal_mask(t, t, window), 4, 2)
    np.testing.assert_allclose(got.reshape(2, t, 4 * hd).numpy(),
                               np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    if window >= t:
        assert torch.equal(got, flash_attn_plain(
            *map(torch.from_numpy, (q, k, v)), True))
    if window == 1:                                 # each row its own v
        np.testing.assert_allclose(
            got.numpy(), np.repeat(v, 2, axis=2), rtol=0, atol=1e-6)
    # the window is causal only, as the reference's mask
    assert torch.equal(
        flash_attn_plain(*map(torch.from_numpy, (q, k, v)), False, window),
        flash_attn_plain(*map(torch.from_numpy, (q, k, v)), False))


@pytest.mark.parametrize("t,window,chunk", [(64, 8, 16), (96, 20, 32),
                                            (64, 40, 16)])
@pytest.mark.parametrize("hd", [16, 256])
def test_windowed_attention_matches_reference_banded(t, window, chunk, hd):
    """Against the reference's ``_sdpa_banded`` (its flagged route past
    8192 positions: the diagonal band only), at T a multiple of its
    chunk, bands narrower and wider than a chunk."""
    q, k, v = _grouped(t + window + hd, t, hd)
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                        window=window)
    want = jlayers._sdpa_banded(*map(jnp.asarray, (q, k, v)), 4, 2, window,
                                chunk=chunk)
    np.testing.assert_allclose(got.reshape(2, t, 4 * hd).numpy(),
                               np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_online_softmax_takes_the_window():
    """The trainer's route past ONLINE_ATTN_THRESHOLD (``_sdpa_online``
    with a window) against the reference's, at a small chunk."""
    q, k, v = _grouped(5, 64, 16)
    got = layers._sdpa_online(*map(torch.from_numpy, (q, k, v)), 4, 2,
                              window=12, chunk=16)
    want = jlayers._sdpa_online(*map(jnp.asarray, (q, k, v)), 4, 2,
                                window=12, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


# ----------------------------------------------------------------------
# the prefix-LM's bidirectional prefix, and S ≠ T (cross-attention)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("t,prefix", [(37, 1), (37, 8), (37, 37), (37, 60),
                                      (200, 65)])
@pytest.mark.parametrize("hd", [16, 256])
def test_prefix_attention_matches_reference_sdpa(t, prefix, hd):
    """``flash_attn_plain(prefix_len=)`` and ``ops.attention`` against the
    reference's ``_sdpa`` under ``causal_mask(t, t, prefix_len=)``: a
    prefix inside the sequence, of all of it, and past it (every key
    seen: the non-causal result); a non-causal call ignores it."""
    q, k, v = map(torch.from_numpy, _grouped(t + prefix + hd, t, hd))
    got = flash_attn_plain(q, k, v, True, None, prefix)
    want = jlayers._sdpa(*map(jnp.asarray, (q.numpy(), k.numpy(),
                                            v.numpy())),
                         jlayers.causal_mask(t, t, prefix_len=prefix), 4, 2)
    np.testing.assert_allclose(got.reshape(2, t, 4 * hd).numpy(),
                               np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    assert torch.equal(ops.attention(q, k, v, prefix_len=prefix), got)
    if prefix >= t:
        np.testing.assert_allclose(got.numpy(),
                                   flash_attn_plain(q, k, v, False).numpy(),
                                   rtol=0, atol=1e-6)
    assert torch.equal(flash_attn_plain(q, k, v, False, None, prefix),
                       flash_attn_plain(q, k, v, False))


@pytest.mark.parametrize("t,s", [(1, 40), (7, 40), (40, 40), (33, 9)])
@pytest.mark.parametrize("kv", [4, 2])
def test_cross_attention_matches_reference_sdpa(t, s, kv):
    """Non-causal attention of T queries over S keys (the decoder's
    cross-attention) in both layouts, against the reference's ``_sdpa``
    under an all-true mask, as its cross branch computes it."""
    rng = np.random.default_rng(t * s + kv)
    q = rng.standard_normal((2, t, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, kv, 16)).astype(np.float32)
            for _ in range(2))
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    assert got.shape == (2, t, 4, 16)
    want = jlayers._sdpa(*map(jnp.asarray, (q, k, v)),
                         jnp.ones((1, 1, 1, t, s), bool), 4, kv)
    np.testing.assert_allclose(got.reshape(2, t, 64).numpy(),
                               np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    q3, k3, v3 = (np.ascontiguousarray(x[:, :, 0]) for x in (q, k, v))
    flat = ops.attention(*map(torch.from_numpy, (q3, k3, v3)), causal=False)
    want3 = jlayers._sdpa(*(jnp.asarray(x[:, :, None]) for x in (q3, k3, v3)),
                          jnp.ones((1, 1, 1, t, s), bool), 1, 1)
    np.testing.assert_allclose(flat.numpy(), np.asarray(want3),
                               rtol=F32_TOL, atol=F32_TOL)


def test_causal_attention_needs_as_many_keys_as_queries():
    q, k, v = map(torch.from_numpy, _qkv(3, (1, 12, 2, 16)))
    with pytest.raises(ValueError, match="as many keys"):
        flash_attn(q, k[:, :7], v[:, :7], True)
    with pytest.raises(ValueError, match="as many keys"):
        ops.attention(q, k[:, :7], v[:, :7], causal=True, prefix_len=3)


def test_online_softmax_takes_the_prefix():
    """The trainer's route past ONLINE_ATTN_THRESHOLD (``_sdpa_online``
    with a prefix) against the reference's, at a small chunk."""
    q, k, v = _grouped(6, 64, 16)
    got = layers._sdpa_online(*map(torch.from_numpy, (q, k, v)), 4, 2,
                              chunk=16, prefix_len=20)
    want = jlayers._sdpa_online(*map(jnp.asarray, (q, k, v)), 4, 2,
                                prefix_len=20, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


# ----------------------------------------------------------------------
# the model's full-sequence attention at f32
# ----------------------------------------------------------------------
def _tiny(kv):
    """paper_tiny_lm (4 heads), with ``kv`` kv heads: G = 4 / kv."""
    return (dataclasses.replace(j_get_config("paper_tiny_lm"),
                                num_kv_heads=kv),
            dataclasses.replace(configs.get_config("paper_tiny_lm"),
                                num_kv_heads=kv))


@pytest.mark.parametrize("kv", [4, 2])
def test_attn_apply_matches_reference(kv):
    jcfg, tcfg = _tiny(kv)
    jp = jlayers.attn_init(jax.random.key(kv), jcfg, jnp.float32)
    tp = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jp)
    h = np.random.default_rng(kv).standard_normal((2, 50, 128)).astype(
        np.float32)
    jcaps, tcaps = {}, {}
    want, _ = jlayers.attn_apply(jp, jnp.asarray(h), jcfg, caps=jcaps)
    got = layers.attn_apply(tp, torch.from_numpy(h), tcfg, caps=tcaps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    assert sorted(tcaps) == sorted(jcaps)
    for name in jcaps:                  # attn.wo's input is the attention
        np.testing.assert_allclose(tcaps[name].numpy(),
                                   np.asarray(jcaps[name]), rtol=MODEL_TOL,
                                   atol=MODEL_TOL)


@pytest.mark.parametrize("kv", [4, 2])
def test_lm_forward_matches_reference(kv):
    jcfg, tcfg = _tiny(kv)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = LM(tcfg, device="cpu")
    tp = tm.params_from_jax(_flatten(jp))
    toks = np.random.default_rng(kv).integers(0, 512, size=(2, 77)).astype(
        np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
