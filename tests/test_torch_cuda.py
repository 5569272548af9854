"""The port's CUDA kernels on the card against their plain versions.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  This file imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax.)
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core.pruner import prune_matrix
from repro_torch.kernels import ops
from repro_torch.kernels.nm_spmm import (nm_spmm, nm_spmm_decode,
                                         nm_spmm_decode_plain, nm_spmm_plain)
from repro_torch.kernels.paged_attn import paged_attn, paged_attn_plain

pytestmark = pytest.mark.cuda
REL_TOL = 2e-5          # |kernel - plain| / max(1, |plain|): f32 sums reordered


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _packed(gen, k, n, dtype):
    w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
    w = prune_matrix(w.T, "2:4")[0].T.contiguous().to(dtype)
    return ops.compress_24(w)


def _close(got, want):
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (8, 1024, 2816),
                                   (5, 132, 64), (32, 200, 256),
                                   (100, 256, 384)])
@pytest.mark.parametrize("act", [None, "silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_spmm_decode_matches_plain(gen, m, k, n, act, dtype):
    vals, idx = _packed(gen, k, n, dtype)
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    bias = torch.randn(n, generator=gen, device="cuda").to(dtype)
    _close(nm_spmm_decode(x, vals, idx, bias, act),
           nm_spmm_decode_plain(x, vals, idx, bias, act))


@pytest.mark.parametrize("m,k,n", [(130, 512, 128), (256, 1024, 2816),
                                   (200, 132, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_spmm_matches_plain(gen, m, k, n, dtype):
    vals, idx = _packed(gen, k, n, dtype)
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    _close(nm_spmm(x, vals, idx), nm_spmm_plain(x, vals, idx))


@pytest.mark.parametrize("b,kv,g,hd,ps,pmax,window,int8", [
    (8, 16, 1, 64, 16, 8, None, False), (3, 2, 2, 16, 8, 3, 5, False),
    (2, 1, 8, 32, 16, 2, None, False), (4, 4, 1, 64, 8, 4, None, True),
    (3, 2, 4, 16, 8, 3, 5, True)])
def test_paged_attn_matches_plain(gen, b, kv, g, hd, ps, pmax, window, int8):
    n_pages = b * pmax + 1
    q = torch.randn(b, kv, g, hd, generator=gen, device="cuda")
    if int8:
        kp, vp = (torch.randint(-127, 128, (n_pages, ps, kv, hd),
                                generator=gen, device="cuda").to(torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(n_pages, ps, kv, generator=gen, device="cuda")
                  / 64 for _ in range(2))
    else:
        kp, vp = (torch.randn(n_pages, ps, kv, hd, generator=gen,
                              device="cuda") for _ in range(2))
        ks = vs = None
    lengths = np.random.default_rng(b).integers(1, pmax * ps + 1, size=b)
    lengths[0] = 0                                  # an idle slot
    bt = np.zeros((b, pmax), np.int32)
    pid = 1
    for i, n_ in enumerate(lengths):
        for j in range(-(-int(n_) // ps)):
            bt[i, j] = pid
            pid += 1
    bt = torch.from_numpy(bt).cuda()
    ln = torch.from_numpy(lengths.astype(np.int32)).cuda()
    got = paged_attn(q, kp, vp, bt, ln, window, ks, vs)
    _close(got, paged_attn_plain(q, kp, vp, bt, ln, window, ks, vs))
    assert (got[0] == 0).all()


def test_launch_counters_count_kernel_launches_only(gen):
    vals, idx = _packed(gen, 64, 32, torch.float32)
    x = torch.randn(4, 64, generator=gen, device="cuda")
    ops.reset_launch_counts()
    ops.nm_matmul(x, vals, idx)
    ops.nm_matmul(torch.randn(200, 64, generator=gen, device="cuda"), vals,
                  idx)
    with ops.override_dispatch(plain=True):
        ops.nm_matmul(x, vals, idx)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"nm_spmm": 1, "nm_spmm_decode": 1,
                                   "paged_attn": 0}
