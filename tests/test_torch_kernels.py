"""The port's kernel layer on CPU against the JAX package.

The port's plain versions (what every wrapper runs for a CPU tensor) are
held against the reference's Pallas kernels run in interpret mode, at
the sweep shapes and tolerances of tests/test_kernels.py; the 2:4 packing
is held against the reference element for element.  Inputs are made
with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.nm_spmm import nm_spmm as j_nm_spmm
from repro.kernels.paged_attn import paged_attn as j_paged_attn
from repro_torch.kernels import ops, ref
from repro_torch.kernels.hessian_accum import (hessian_accum,
                                               hessian_accum_plain)
from repro_torch.kernels.nm_select import nm_select, nm_select_plain
from repro_torch.kernels.nm_spmm import nm_spmm, nm_spmm_decode
from repro_torch.kernels.paged_attn import paged_attn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs several workers on the machine's
    cores, and torch's default pool of a thread a core in each of them
    oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sparse_24(rng, k, n):
    """(K, N) f32 with the 2 smallest |w| of every 4-row group zeroed."""
    w = rng.standard_normal((k, n)).astype(np.float32)
    g = w.reshape(k // 4, 4, n)
    drop = np.argsort(np.abs(g), axis=1)[:, :2, :]
    np.put_along_axis(g, drop, 0.0, axis=1)
    return g.reshape(k, n)


def _both(a, dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a)).to(tdt)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_24_matches_reference_and_round_trips(dtype):
    rng = np.random.default_rng(0)
    w = _sparse_24(rng, 64, 24)
    # groups with fewer than 2 nonzeros: a kept value at position 0 next
    # to a padding slot that also points at position 0 (sum, not scatter)
    w[0:4, 0] = [1.5, 0.0, 0.0, 0.0]
    w[4:8, 1] = 0.0
    w[8:12, 2] = [0.0, 0.0, 0.0, -2.0]
    jw, tw = _both(w, dtype)
    jv, ji = jref.compress_24(jw)
    tv, ti = ops.compress_24(tw)
    np.testing.assert_array_equal(_np(tv), _np(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int8 and tv.dtype == tw.dtype
    np.testing.assert_array_equal(_np(ref.decompress_24(tv, ti)), _np(tw))
    np.testing.assert_array_equal(_np(ref.decompress_24(tv, ti)),
                                  _np(jref.decompress_24(jv, ji)))


def _pallas_nm_spmm(x, vals, idx, block=128):
    """The reference's tiled kernel, padded as its ops wrapper pads."""
    m, k = x.shape
    n = vals.shape[1]
    bm = min(block, max(8, m))
    xp = jops._pad_to(x, (bm, block))
    vp = jops._pad_to(vals, (block // 2, block))
    ip = jops._pad_to(idx, (block // 2, block))
    y = j_nm_spmm(xp, vp, ip, bm=bm, bn=block, bk=block, interpret=True)
    return y[:m, :n]


@pytest.mark.parametrize("k,n,m", [(128, 128, 64), (256, 192, 96),
                                   (64, 320, 8), (512, 128, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nm_spmm_plain_matches_pallas(k, n, m, dtype):
    rng = np.random.default_rng(k + n + m)
    w = _sparse_24(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    (jw, tw), (jx, tx) = _both(w, dtype), _both(x, dtype)
    jv, ji = jref.compress_24(jw)
    tv, ti = ops.compress_24(tw)
    want = _pallas_nm_spmm(jx, jv, ji)
    got = nm_spmm(tx, tv, ti)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * 8)


@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (3, 256, 384),
                                   (8, 200, 256), (5, 132, 64)])
@pytest.mark.parametrize("act", [None, "silu", "gelu"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_nm_spmm_decode_plain_matches_pallas(m, k, n, act, with_bias):
    """Skinny M with the fused epilogue, K and N off the 128 tile; the
    reference's ops wrapper pads and runs the Pallas decode kernel."""
    rng = np.random.default_rng(m * 7 + k + n)
    w = _sparse_24(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal((n,)).astype(np.float32) if with_bias else None
    (jw, tw), (jx, tx) = _both(w), _both(x)
    jv, ji = jref.compress_24(jw)
    tv, ti = ops.compress_24(tw)
    jb, tb = _both(bias) if with_bias else (None, None)
    want = jops.nm_matmul(jx, jv, ji, jb, activation=act, use_kernel=True,
                          out_dtype=jnp.float32)
    got = nm_spmm_decode(tx, tv, ti, tb, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("m", [5, 130])
@pytest.mark.parametrize("act", [None, "silu", "gelu"])
def test_nm_matmul_dispatch_matches_reference_oracle(m, act):
    """The port's ops.nm_matmul on CPU (either side of the M ≤ 128
    split) against the reference's jnp oracle dispatch."""
    rng = np.random.default_rng(m)
    w = _sparse_24(rng, 96, 40)
    x = rng.standard_normal((2, m, 96)).astype(np.float32)
    bias = rng.standard_normal((40,)).astype(np.float32)
    (jw, tw), (jx, tx), (jb, tb) = _both(w), _both(x), _both(bias)
    jv, ji = jref.compress_24(jw)
    tv, ti = ops.compress_24(tw)
    want = jops.nm_matmul(jx, jv, ji, jb, activation=act, use_kernel=False)
    got = ops.nm_matmul(tx, tv, ti, tb, activation=act)
    assert got.shape == (2, m, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------------
# pruning-pass kernels: the reference's sweep shapes and tolerances
# (tests/test_kernels.py), its Pallas kernels in interpret mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("m,t", [(32, 128), (96, 320), (128, 128),
                                 (70, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hessian_accum_plain_matches_pallas(m, t, dtype):
    rng = np.random.default_rng(m * t)
    x = rng.standard_normal((m, t)).astype(np.float32)
    jx, tx = _both(x, dtype)
    want = np.asarray(jops.hessian_xxt(jx))
    h = torch.full((m, m), float("nan"))             # β = 0 never reads h
    got = hessian_accum_plain(tx.T.contiguous(), h)  # token-major (T, m)
    assert got is h and got.dtype == torch.float32
    tol = 5e-2 if dtype == "bfloat16" else 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(ops.hessian_xxt(tx).numpy(), want, rtol=tol,
                               atol=tol)


def test_hessian_accum_alpha_beta_is_the_streaming_mean():
    """H ← β·H + α·2·XᵀX with the streaming-mean α, β equals the
    reference's ``_accum_update`` (f32, 1e-6 relative)."""
    from repro.core.hessian import _accum_update

    rng = np.random.default_rng(5)
    h0 = rng.standard_normal((24, 24)).astype(np.float32)
    h0 = h0 + h0.T
    x = rng.standard_normal((40, 24)).astype(np.float32)
    want, _ = _accum_update(jnp.asarray(h0), jnp.float32(60.0),
                            jnp.asarray(x.T))
    got = hessian_accum(torch.from_numpy(x), torch.from_numpy(h0.copy()),
                        alpha=float(np.float32(1) / np.float32(100)),
                        beta=float(np.float32(60) / np.float32(100)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("r,c", [(16, 32), (48, 64), (128, 128), (33, 20)])
def test_nm_select_plain_matches_pallas(r, c):
    rng = np.random.default_rng(r * c)
    w = rng.standard_normal((r, c)).astype(np.float32)
    a = rng.standard_normal((c, c)).astype(np.float32)
    hinv = (a @ a.T / c + np.eye(c)).astype(np.float32)
    want = np.asarray(jops.nm_select_mask(jnp.asarray(w), jnp.asarray(hinv)))
    got = nm_select_plain(torch.from_numpy(w), torch.from_numpy(hinv))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.nm_select_ref(jnp.asarray(w),
                                                   jnp.asarray(hinv))))
    assert (got.numpy().reshape(r, c // 4, 4).sum(-1) == 2).all()


def test_nm_select_reads_a_block_of_hinv_in_place_and_keeps_tie_order():
    """A strided diagonal block of a larger inverse gives the mask of its
    contiguous copy; exact ties take the first pair in NM_COMBOS_24
    order, as jnp.argmin does."""
    rng = np.random.default_rng(9)
    big = rng.standard_normal((48, 48)).astype(np.float32)
    big = big @ big.T / 48 + np.eye(48, dtype=np.float32)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    w[0, :4] = 1.0                                   # all six pairs tie
    tb = torch.from_numpy(big)[16:32, 16:32]
    got = ops.nm_select_mask(torch.from_numpy(w), tb)
    np.testing.assert_array_equal(
        got.numpy(), nm_select_plain(torch.from_numpy(w),
                                     tb.contiguous()).numpy())
    eye_mask = ops.nm_select_mask(torch.from_numpy(w), torch.eye(16))
    np.testing.assert_array_equal(
        eye_mask.numpy(), np.asarray(jref.nm_select_ref(
            jnp.asarray(w), jnp.eye(16))))
    assert eye_mask[0, :4].tolist() == [True, True, False, False]


# ----------------------------------------------------------------------
def _paged_setup(rng, b, kv, g, hd, ps, pmax, int8=False):
    n_pages = b * pmax + 1
    q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
    if int8:
        kp = rng.integers(-127, 128, (n_pages, ps, kv, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (n_pages, ps, kv, hd)).astype(np.int8)
        ks = (rng.random((n_pages, ps, kv)) / 64).astype(np.float32)
        vs = (rng.random((n_pages, ps, kv)) / 64).astype(np.float32)
    else:
        kp = rng.standard_normal((n_pages, ps, kv, hd)).astype(np.float32)
        vp = rng.standard_normal((n_pages, ps, kv, hd)).astype(np.float32)
        ks = vs = None
    lengths = rng.integers(1, pmax * ps + 1, size=b).astype(np.int32)
    lengths[0] = 0                                  # an idle slot
    bt = np.zeros((b, pmax), np.int32)
    pid = 1
    for i in range(b):
        for j in range(-(-int(lengths[i]) // ps)):
            bt[i, j] = pid
            pid += 1
    return q, kp, vp, bt, lengths, ks, vs


def _to_torch(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("b,kv,g,hd,ps,pmax,window,int8", [
    (3, 2, 2, 16, 8, 3, None, False), (2, 1, 4, 32, 16, 2, None, False),
    (4, 4, 1, 64, 8, 4, None, False), (3, 2, 2, 16, 8, 3, 5, False),
    (4, 2, 4, 16, 8, 3, None, True), (3, 2, 2, 16, 8, 3, 5, True),
    (2, 1, 8, 256, 16, 2, None, False), (2, 1, 8, 256, 16, 2, None, True)])
def test_paged_attn_plain_matches_pallas(b, kv, g, hd, ps, pmax, window,
                                         int8):
    rng = np.random.default_rng(b * hd + ps + int(int8))
    q, kp, vp, bt, lengths, ks, vs = _paged_setup(rng, b, kv, g, hd, ps,
                                                  pmax, int8)
    want = j_paged_attn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                        jnp.asarray(bt), jnp.asarray(lengths), window=window,
                        interpret=True,
                        k_scale=None if ks is None else jnp.asarray(ks),
                        v_scale=None if vs is None else jnp.asarray(vs))
    got = paged_attn(*_to_torch(q, kp, vp, bt, lengths), window,
                     *_to_torch(ks, vs))
    assert got.dtype == torch.float32 and got.shape == (b, kv, g, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert (got[0] == 0).all()                      # idle slot: exact zeros


def test_paged_attention_dispatch_dtype_matches_reference_oracle():
    """ops.paged_attention on CPU: the reference oracle's numbers on live
    rows, in the pages' dtype."""
    rng = np.random.default_rng(3)
    q, kp, vp, bt, lengths, _, _ = _paged_setup(rng, 3, 2, 2, 16, 8, 3)
    want = jops.paged_attention(*map(jnp.asarray, (q, kp, vp, bt, lengths)))
    got = ops.paged_attention(*_to_torch(q, kp, vp, bt, lengths))
    assert got.dtype == torch.float32
    live = lengths > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
def test_cpu_tensors_take_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(1)
    tw = torch.from_numpy(_sparse_24(rng, 32, 16))
    tv, ti = ops.compress_24(tw)
    ops.reset_launch_counts()
    for m in (4, 200):
        x = torch.from_numpy(rng.standard_normal((m, 32)).astype(np.float32))
        torch.testing.assert_close(ops.nm_matmul(x, tv, ti), x @ tw,
                                   rtol=1e-5, atol=1e-5)
    q, kp, vp, bt, lengths, _, _ = _paged_setup(rng, 2, 1, 1, 8, 4, 2)
    ops.paged_attention(*_to_torch(q, kp, vp, bt, lengths))
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    ops.hessian_xxt(x)
    ops.nm_select_mask(x, torch.eye(8))
    ops.attention(x[None], x[None], x[None])
    assert ops.launch_counts() == {"nm_spmm": 0, "nm_spmm_decode": 0,
                                   "paged_attn": 0, "hessian_accum": 0,
                                   "nm_select": 0, "flash_attn": 0}


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU launches the kernel or raises: on a device
    the kernels do not run on (``meta`` here) the wrappers raise instead
    of quietly taking the plain version."""
    x = torch.empty((4, 32), device="meta")
    vals = torch.empty((16, 8), device="meta")
    idx = torch.empty((16, 8), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        nm_spmm(x, vals, idx)
    with pytest.raises(RuntimeError, match="CUDA"):
        nm_spmm_decode(x, vals, idx)
    q = torch.empty((1, 1, 1, 8), device="meta")
    pages = torch.empty((2, 4, 1, 8), device="meta")
    bt = torch.empty((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        paged_attn(q, pages, pages, bt, torch.empty((1,), device="meta"))
    with pytest.raises(RuntimeError, match="CUDA"):
        hessian_accum(x, torch.empty((32, 32), device="meta"))
    with pytest.raises(RuntimeError, match="CUDA"):
        nm_select(x, torch.empty((32, 32), device="meta"))


def test_override_dispatch_nests():
    assert not ops._plain()
    with ops.override_dispatch():
        assert ops._plain()
        with ops.override_dispatch(plain=False):
            assert not ops._plain()
        assert ops._plain()
    assert not ops._plain()


def test_override_dispatch_is_thread_local():
    """A scope opened in one thread reroutes none of another thread's
    launches: the serve front end's replica threads keep the kernels
    while a check in the main thread holds one against its plain
    version, and the other way round."""
    import threading

    seen = {}
    inside, release = threading.Event(), threading.Event()

    def worker(name, plain):
        with ops.override_dispatch(plain):
            seen[name + "_in"] = ops._plain()
            if name == "a":
                inside.set()
            release.wait(timeout=10)
        seen[name + "_out"] = ops._plain()

    with ops.override_dispatch():
        t = threading.Thread(target=lambda: seen.update(
            other=ops._plain()))
        t.start()
        t.join()
        assert ops._plain()
    assert seen.pop("other") is False
    a = threading.Thread(target=worker, args=("a", True))
    a.start()
    assert inside.wait(timeout=10)
    assert not ops._plain()                   # the main thread: kernels
    b = threading.Thread(target=worker, args=("b", False))
    b.start()
    release.set()
    a.join()
    b.join()
    assert seen == {"a_in": True, "a_out": False, "b_in": False,
                    "b_out": False}


def test_launch_counts_exact_across_threads():
    """Two workers bumping one wrapper's count lose nothing: the bump is
    taken under the build module's lock, which ``launch_counts`` and
    ``reset_launch_counts`` take too."""
    import threading

    from repro_torch.kernels import build

    ops.reset_launch_counts()
    threads = [threading.Thread(target=lambda: [
        build.count_launch(paged_attn) for _ in range(20000)])
        for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ops.launch_counts()["paged_attn"] == 40000
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


def test_activate_matches_reference():
    y = np.linspace(-6, 6, 101).astype(np.float32)
    for act in (None, "silu", "gelu"):
        np.testing.assert_allclose(
            ref.activate(torch.from_numpy(y), act).numpy(),
            np.asarray(jref.activate(jnp.asarray(y), act)), rtol=1e-6,
            atol=1e-6)
    with pytest.raises(ValueError):
        ref.activate(torch.from_numpy(y), "relu")
    assert jax.default_backend() == "cpu"
