"""The port's threefry (``repro_torch.random``) against ``jax.random``.

Every test runs under ``jax.threefry_partitionable(True)``: the port
implements the partitionable scheme (jax's default since 0.5), whose
``split`` and ``random_bits`` differ from the older one, and the
context manager pins it whatever the installed jax's default is.

The integer parts — ``key``, ``fold_in``, ``split``, the 32-bit bits,
``randint`` — and ``uniform`` (a bit trick, no rounding) are bit-equal.
The float parts are not free: ``normal`` goes through ``log1p`` inside
XLA's f32 inverse error function and ``gumbel`` through two ``log``s,
where torch and XLA may round an ulp apart.  ``normal`` is held to
NORMAL_ATOL (measured: ≤ 7.2e-7 over 10⁵ draws, on ≈ 4.7 % of them);
``categorical`` — the argmax over gumbel + logits that sampled decoding
and the corpus draw — to a flip rate of at most CATEGORICAL_MAX_FLIPS
(measured: 0 of 4,096 rows at V = 512).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.ckpt.store import _flatten
from repro.models import LM as JLM
from repro_torch import configs
from repro_torch import random as rnd
from repro_torch.models.transformer import LM

SEEDS = (0, 1, 2**31 - 1, -5)
SHAPES = ((), (7,), (3, 5), (8, 151936))
NORMAL_ATOL = 2e-6
CATEGORICAL_MAX_FLIPS = 4 / 4096


@pytest.fixture(autouse=True)
def partitionable():
    """The partitionable scheme, and one torch thread: the bit path is
    ~170 small integer ops a call, which a shared thread pool slows
    tenfold on a busy host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.threefry_partitionable(True):
            yield
    finally:
        torch.set_num_threads(threads)


def _data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bit_equal(seed):
    jk, tk = jax.random.key(seed), rnd.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _data(jk))
    for data in (0, 7, 123456789, 2**32 - 1):
        np.testing.assert_array_equal(rnd.fold_in(tk, data).numpy(),
                                      _data(jax.random.fold_in(jk, data)))
    for num in (2, 3, (2, 3)):
        np.testing.assert_array_equal(rnd.split(tk, num).numpy(),
                                      _data(jax.random.split(jk, num)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_equal(seed, shape):
    jk, tk = jax.random.key(seed), rnd.key(seed)
    bits = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    np.testing.assert_array_equal(rnd.random_bits(tk, shape).numpy(),
                                  bits.astype(np.int64))
    u = np.asarray(jax.random.uniform(jk, shape))
    np.testing.assert_array_equal(rnd.uniform(tk, shape).numpy().view(
        np.int32), u.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(0, 512), (-7, 151936), (5, 5),
                                   (-2**31, 2**31 - 1)])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bit_equal(seed, lo, hi):
    """Including the uint32 wrap of the span multiplier (151,943: its
    2¹⁶·2¹⁶ wraps to 0) and an empty range (always ``lo``)."""
    jk, tk = jax.random.key(seed), rnd.key(seed)
    want = np.asarray(jax.random.randint(jk, (1000,), lo, hi))
    np.testing.assert_array_equal(rnd.randint(tk, (1000,), lo, hi).numpy(),
                                  want)


def test_batched_keys_draw_as_one_key_each():
    """Keys (K..., 2) batch like the reference's vmap over keys."""
    keys = rnd.split(rnd.key(3), (2, 3))
    got = rnd.uniform(keys, (4, 5))
    assert got.shape == (2, 3, 4, 5)
    for i in range(2):
        for j in range(3):
            torch.testing.assert_close(got[i, j], rnd.uniform(keys[i, j],
                                                              (4, 5)),
                                       rtol=0, atol=0)
    rows = rnd.fold_in(rnd.fold_in(rnd.key(0), torch.arange(4)), 9)
    jrows = jax.vmap(lambda u: jax.random.fold_in(
        jax.random.fold_in(jax.random.key(0), u), 9))(jnp.arange(4))
    np.testing.assert_array_equal(rows.numpy(), _data(jrows))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_tolerance(seed):
    want = np.asarray(jax.random.normal(jax.random.key(seed), (100000,)))
    got = rnd.normal(rnd.key(seed), (100000,)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    assert np.abs(got).max() > 4.0          # both tails reached


def test_gumbel_and_categorical_flip_rate():
    keys = rnd.split(rnd.key(11), 4096)
    jkeys = jax.random.split(jax.random.key(11), 4096)
    logits = np.random.default_rng(0).normal(size=(4096, 512)).astype(
        np.float32) * 3.0
    want_g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (512,)))(
        jkeys))
    got_g = rnd.gumbel(keys, (512,)).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=2e-6, atol=2e-6)
    want = np.asarray(jax.vmap(jax.random.categorical)(jkeys,
                                                       jnp.asarray(logits)))
    got = rnd.categorical(keys, torch.from_numpy(logits)).numpy()
    flips = int(np.sum(got != want))
    assert flips <= CATEGORICAL_MAX_FLIPS * len(want), flips
    # one key over the whole batch (static mode's draw)
    want1 = np.asarray(jax.random.categorical(jkeys[0],
                                              jnp.asarray(logits[:64])))
    got1 = rnd.categorical(keys[0], torch.from_numpy(logits[:64])).numpy()
    assert int(np.sum(got1 != want1)) <= 1


@pytest.mark.parametrize("arch", ["paper_tiny_lm", "qwen1_5_0_5b"])
def test_keyed_init_reproduces_reference_init(arch):
    """``LM.init(key(seed))`` is the reference's ``LM.init``: the same
    key splits, the normals within NORMAL_ATOL of 1 (relative to each
    leaf's scale)."""
    want = _flatten(JLM(j_get_smoke(arch)).init(jax.random.key(3)))
    tm = LM(configs.get_smoke(arch), device="cpu")
    got = tm.params_to_flat(tm.init(rnd.key(3)))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if g.dtype.kind == "V":                     # bf16 bits
            g = (g.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
            w = (np.asarray(w).view(np.uint16).astype(np.uint32)
                 << 16).view(np.float32)
            tol = 2 ** -7
        else:
            tol = NORMAL_ATOL
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=path)


def test_seed_outside_int32_is_refused():
    with pytest.raises(OverflowError):
        rnd.key(2**31)
