"""The port's pruning math on CPU against the JAX package.

Inputs are made with numpy from a seed and handed to both packages;
each comparison states its tolerance.  At a fixed (w, H) the two
packages run the same operations in f32, so masks must be equal and
weights agree to a few f32 ulps of their scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hessian as jhessian
from repro.core import masks as jmasks
from repro.core import mrp as jmrp
from repro.core import pruner as jpruner
from repro.core import scores as jscores
from repro.core import sparsegpt as jsparsegpt
from repro.core.sparsity import SparsitySpec as JSpec
from repro_torch.core import hessian, masks, mrp, pruner, scores, sparsegpt
from repro_torch.core.calibration import CalibrationSet
from repro_torch.core.sparsity import SparsitySpec

W_TOL = 2e-6          # |Δw| / max|w| at a fixed (w, H): f32 rounding only


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs several workers on the machine's
    cores, and torch's default pool of a thread a core in each of them
    oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _psd(rng, m, scale=1.0):
    x = rng.standard_normal((m, 4 * m)).astype(np.float32)
    return (scale * (2.0 * (x @ x.T) / (4 * m))
            + 0.1 * np.eye(m)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close_w(got, want):
    want = _np(want)
    assert np.abs(_np(got) - want).max() <= W_TOL * max(1.0, np.abs(want).max())


# ----------------------------------------------------------------------
# Hessian
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hessian_accumulator_matches_reference_over_batches(dtype):
    rng = np.random.default_rng(0)
    m = 24
    jacc = jhessian.HessianAccumulator(m)
    tacc = hessian.HessianAccumulator(m)
    for b in (17, 40, 64, 5):
        x = rng.standard_normal((b, m)).astype(np.float32)
        jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else None)
        tx = _t(x).to(torch.bfloat16 if dtype == "bfloat16" else
                      torch.float32)
        jacc.update_tokens(jx)
        tacc.update_tokens(tx)
    assert tacc.count == float(jacc.count) == 126.0
    np.testing.assert_allclose(_np(tacc.finalize()), np.asarray(jacc.h),
                               rtol=1e-5, atol=1e-6)
    # update (m, B) is update_tokens of the transpose; merge weighs counts
    other = hessian.HessianAccumulator(m)
    jother = jhessian.HessianAccumulator(m)
    x = rng.standard_normal((m, 30)).astype(np.float32)
    other.update(_t(x))
    jother.update(jnp.asarray(x))
    np.testing.assert_allclose(_np(tacc.merge(other).h),
                               np.asarray(jacc.merge(jother).h),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tacc.update(_t(x.T))


def test_calibration_set_flattens_captures_token_major():
    rng = np.random.default_rng(1)
    cap = rng.standard_normal((2, 5, 12)).astype(np.float32)
    cs = CalibrationSet()
    cs.update({"a.wq": _t(cap)})
    want = jhessian.HessianAccumulator(12)
    want.update_tokens(jnp.asarray(cap.reshape(10, 12)))
    np.testing.assert_allclose(_np(cs.hessian("a.wq")), np.asarray(want.h),
                               rtol=1e-6, atol=1e-6)
    assert list(cs.names()) == ["a.wq"]


@pytest.mark.parametrize("gamma", [0.01, 0.1])
def test_dampened_inverse_matches_reference(gamma):
    rng = np.random.default_rng(2)
    h = _psd(rng, 48)
    h[:, 7] = h[7, :] = 0.0                          # a dead input channel
    want = np.asarray(jhessian.dampened_inverse(jnp.asarray(h), gamma))
    got = _np(hessian.dampened_inverse(_t(h), gamma))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ----------------------------------------------------------------------
# scores and masks
# ----------------------------------------------------------------------
def test_scores_and_masks_match_reference_with_ties():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((12, 16)).astype(np.float32)
    w[0] = 0.5                                       # a row of ties
    w[1, :8] = -0.25
    h = _psd(rng, 16)
    hinv = np.asarray(jhessian.dampened_inverse(jnp.asarray(h)))
    for name in ("magnitude", "wanda", "obs", "sparsegpt"):
        js = np.asarray(jscores.compute_score(
            name, jnp.asarray(w), jnp.asarray(h), jnp.asarray(hinv)))
        ts = scores.compute_score(name, _t(w), _t(h), _t(hinv))
        np.testing.assert_allclose(_np(ts), js, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(
            _np(masks.nm_mask_from_scores(ts, 2, 4)),
            np.asarray(jmasks.nm_mask_from_scores(jnp.asarray(js), 2, 4)))
        for k in (0, 37, 96, 192):
            np.testing.assert_array_equal(
                _np(masks.unstructured_mask_from_scores(ts, k)),
                np.asarray(jmasks.unstructured_mask_from_scores(
                    jnp.asarray(js), k)))
        for k in (0, 5, 16):
            np.testing.assert_array_equal(
                _np(masks.unstructured_mask_rowwise(ts, k)),
                np.asarray(jmasks.unstructured_mask_rowwise(
                    jnp.asarray(js), k)))
    with pytest.raises(ValueError, match="unknown score"):
        scores.compute_score("nope", _t(w), _t(h), _t(hinv))


def test_padded_row_indices_and_mask_helpers_match_reference():
    rng = np.random.default_rng(4)
    mask = rng.random((9, 20)) < 0.3
    mask[3] = False
    k = jmasks.bucket_k(jmasks.max_row_count(jnp.asarray(mask)), step=4)
    assert masks.bucket_k(masks.max_row_count(_t(mask)), step=4) == k
    assert masks.bucket_k(0) == jmasks.bucket_k(0) == 32
    ji, jv = jmasks.padded_row_indices(jnp.asarray(mask), k)
    ti, tv = masks.padded_row_indices(_t(mask), k)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    nm = np.zeros((4, 8), bool)
    nm[:, [0, 3, 5, 6]] = True
    assert masks.validate_nm(_t(nm), 2, 4) and masks.validate_nm(nm, 2, 4)
    nm[0, 1] = True
    assert not masks.validate_nm(_t(nm), 2, 4)
    assert masks.sparsity_of(_t(mask)) == pytest.approx(
        jmasks.sparsity_of(jnp.asarray(mask)), abs=1e-7)


# ----------------------------------------------------------------------
# MRP
# ----------------------------------------------------------------------
@pytest.mark.parametrize("row_chunk", [None, 5])
def test_mrp_compensate_matches_reference_and_float64_oracle(row_chunk):
    rng = np.random.default_rng(5)
    n, m = 13, 32
    w = rng.standard_normal((n, m)).astype(np.float32)
    hinv = np.asarray(jhessian.dampened_inverse(jnp.asarray(_psd(rng, m))))
    mask = rng.random((n, m)) < 0.4
    mask[2] = False                                  # a row with nothing pruned
    k = int(mask.sum(1).max()) + 3                   # identity padding
    ji, jv = jmasks.padded_row_indices(jnp.asarray(mask), k)
    jw, jl = jmrp.mrp_compensate(jnp.asarray(w), jnp.asarray(hinv), ji, jv,
                                 row_chunk=row_chunk)
    tw, tl = mrp.mrp_compensate(_t(w), _t(hinv), _t(np.asarray(ji)),
                                _t(np.asarray(jv)), row_chunk=row_chunk)
    _close_w(tw, jw)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5, atol=1e-6)
    assert (_np(tw)[mask] == 0).all()
    for q in range(n):
        ref_row, ref_loss = mrp.mrp_row_reference(
            w[q], hinv, np.nonzero(mask[q])[0])
        j_row, j_loss = jmrp.mrp_row_reference(w[q], hinv,
                                               np.nonzero(mask[q])[0])
        np.testing.assert_array_equal(ref_row, j_row)
        assert ref_loss == j_loss
        np.testing.assert_allclose(_np(tw)[q], ref_row, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref_row).max())
        assert float(tl[q]) == pytest.approx(ref_loss, rel=1e-4, abs=1e-6)
    # the mask form sizes k_max itself
    tw2, _ = mrp.mrp_compensate_mask(_t(w), _t(hinv), _t(mask))
    _close_w(tw2, jmrp.mrp_compensate_mask(jnp.asarray(w), jnp.asarray(hinv),
                                           jnp.asarray(mask))[0])


@pytest.mark.parametrize("n_prune,m_group", [(2, 4), (1, 4), (2, 8)])
def test_select_nm_mask_mrp_matches_reference(n_prune, m_group):
    rng = np.random.default_rng(6 + m_group)
    w = rng.standard_normal((20, 32)).astype(np.float32)
    hinv = np.asarray(jhessian.dampened_inverse(jnp.asarray(_psd(rng, 32))))
    np.testing.assert_allclose(
        _np(mrp.nm_group_losses(_t(w), _t(hinv), n_prune, m_group)),
        np.asarray(jmrp.nm_group_losses(jnp.asarray(w), jnp.asarray(hinv),
                                        n_prune, m_group)),
        rtol=1e-5, atol=1e-7)
    got = mrp.select_nm_mask_mrp(_t(w), _t(hinv), n_prune, m_group)
    want = jmrp.select_nm_mask_mrp(jnp.asarray(w), jnp.asarray(hinv),
                                   n_prune, m_group)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert masks.validate_nm(got, n_prune, m_group)
    assert _np(mrp.nm_combinations(n_prune, m_group)).tolist() == np.asarray(
        jmrp.nm_combinations(n_prune, m_group)).tolist()


# ----------------------------------------------------------------------
# SparseGPT
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["2:4", "0.5"])
@pytest.mark.parametrize("override", [False, True])
def test_sparsegpt_prune_matches_reference(spec, override):
    rng = np.random.default_rng(7)
    n, m = 16, 64
    w = rng.standard_normal((n, m)).astype(np.float32)
    h = _psd(rng, m)
    mask = None
    if override:
        hinv = jhessian.dampened_inverse(jnp.asarray(h))
        mask = np.asarray(jmrp.select_nm_mask_mrp(jnp.asarray(w), hinv, 2, 4))
    jw, jm, jl = jsparsegpt.sparsegpt_prune(
        jnp.asarray(w), jnp.asarray(h), JSpec.parse(spec), blocksize=32,
        mask_override=None if mask is None else jnp.asarray(mask))
    tw, tm, tl = sparsegpt.sparsegpt_prune(
        _t(w), _t(h), SparsitySpec.parse(spec), blocksize=32,
        mask_override=None if mask is None else _t(mask))
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    _close_w(tw, jw)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _np(sparsegpt.cholesky_inv_upper(_t(h))),
        np.asarray(jsparsegpt.cholesky_inv_upper(jnp.asarray(h))),
        rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# prune_matrix: every method on one fixed (w, H)
# ----------------------------------------------------------------------
CASES = [(meth, spec) for meth in pruner.METHODS for spec in ("2:4", "0.5")
         if not (meth in ("MS", "MM") and spec == "0.5")]


@pytest.mark.parametrize("method,spec", CASES)
def test_prune_matrix_matches_reference(method, spec):
    rng = np.random.default_rng(8)
    n, m = 48, 64
    w = rng.standard_normal((n, m)).astype(np.float32)
    h = _psd(rng, m)
    jr = jpruner.prune_matrix(jnp.asarray(w), jnp.asarray(h), spec,
                              method=method, blocksize=32)
    tr = pruner.prune_matrix(_t(w), _t(h), spec, method=method, blocksize=32,
                             row_chunk=7)
    np.testing.assert_array_equal(_np(tr.mask), np.asarray(jr.mask))
    _close_w(tr.w, jr.w)
    assert tr.loss == pytest.approx(jr.loss, rel=1e-5)
    assert tr.sparsity == pytest.approx(jr.sparsity, abs=1e-7)
    assert tr.loss == pytest.approx(
        pruner.reconstruction_error(_t(w), tr.w, _t(h)), rel=1e-6)
    if method in ("SM", "MM"):
        assert tr.stats["final_mrp_loss"] == pytest.approx(
            jr.stats["final_mrp_loss"], rel=1e-5)
        assert len(tr.stats["block_mrp_losses"]) == m // 32


def test_prune_matrix_rejects_what_the_reference_rejects():
    w, h = torch.zeros((4, 8)), torch.eye(8)
    with pytest.raises(ValueError, match="N:M only"):
        pruner.prune_matrix(w, h, "0.5", method="MM")
    with pytest.raises(ValueError, match="not in"):
        pruner.prune_matrix(w, h, "2:4", method="XX")
    with pytest.raises(ValueError, match="divisible"):
        pruner.prune_matrix(torch.zeros((4, 12)), torch.eye(12), "2:4",
                            blocksize=8)


def test_prune_matrix_row_balanced_and_bf16_match_reference():
    rng = np.random.default_rng(10)
    w = rng.standard_normal((16, 32)).astype(np.float32)
    h = _psd(rng, 32)
    jr = jpruner.prune_matrix(jnp.asarray(w), jnp.asarray(h), "0.5",
                              method="SM", blocksize=16, row_balanced=True)
    tr = pruner.prune_matrix(_t(w), _t(h), "0.5", method="SM", blocksize=16,
                             row_balanced=True)
    np.testing.assert_array_equal(_np(tr.mask), np.asarray(jr.mask))
    _close_w(tr.w, jr.w)
    # bf16 weights: the solve runs in f32 and the result comes back bf16
    jr = jpruner.prune_matrix(jnp.asarray(w, jnp.bfloat16), jnp.asarray(h),
                              "2:4", method="MM", blocksize=16)
    tr = pruner.prune_matrix(_t(w).to(torch.bfloat16), _t(h), "2:4",
                             method="MM", blocksize=16)
    assert tr.w.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tr.mask), np.asarray(jr.mask))
    np.testing.assert_allclose(tr.w.float().numpy(),
                               np.asarray(jr.w, np.float32), rtol=1e-2,
                               atol=1e-2)
