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

from repro_torch.core.pruner import prune_linears, prune_matrix
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import flash_attn, flash_attn_plain
from repro_torch.kernels.hessian_accum import (hessian_accum,
                                               hessian_accum_plain,
                                               hessian_accum_weighted,
                                               hessian_accum_weighted_plain)
from repro_torch.kernels.nm_select import nm_select, nm_select_plain
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
    layers = [{"mlp": {"wo": w}}]
    w = prune_linears({"layers": layers}, "2:4")["layers"][0]["mlp"]["wo"]
    return ops.compress_24(w.to(dtype))


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
    got = nm_spmm_decode(x, vals, idx, bias, act)
    assert nm_spmm_decode.last_kernel == ("tensor cores"
                                          if dtype == torch.bfloat16
                                          else "f32 FMA")
    _close(got, nm_spmm_decode_plain(x, vals, idx, bias, act))
    assert torch.equal(got, nm_spmm_decode(x, vals, idx, bias, act))


@pytest.mark.parametrize("m", [1, 8, 16, 33, 64, 128])
@pytest.mark.parametrize("k", [132, 2816])
@pytest.mark.parametrize("n", [64, 200, 2816])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_spmm_decode_routes_padding_slots(gen, m, k, n, dtype):
    """Every batch-fragment count of the tensor-core decode kernel (M 1,
    8, 16, 33, 64, 128), K split over a cluster (2816) or not (132), N
    ragged against its 128-column strips (64, 200), padding-slot groups:
    bf16 on the tensor cores and f32 on the FMA kernel, within the f32
    tolerance of the plain version, the same bits twice."""
    vals, idx = _packed_with_padding(gen, k, n, dtype)
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    bias = torch.randn(n, generator=gen, device="cuda").to(dtype)
    act = ("silu", "gelu", None)[m % 3]
    got = nm_spmm_decode(x, vals, idx, bias, act)
    assert nm_spmm_decode.last_kernel == ("tensor cores"
                                          if dtype == torch.bfloat16
                                          else "f32 FMA")
    _close(got, nm_spmm_decode_plain(x, vals, idx, bias, act))
    assert torch.equal(got, nm_spmm_decode(x, vals, idx, bias, act))


def test_nm_spmm_decode_unaligned_bf16_takes_the_fma_kernel(gen):
    vals, idx = _packed(gen, 256, 96, torch.bfloat16)
    flat = torch.empty(vals.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view_as(vals)                 # rows 2 bytes off 16
    shifted.copy_(vals)
    x = torch.randn(8, 256, generator=gen, device="cuda").to(torch.bfloat16)
    got = nm_spmm_decode(x, shifted, idx, None, "silu")
    assert nm_spmm_decode.last_kernel == "f32 FMA"
    _close(got, nm_spmm_decode_plain(x, vals, idx, None, "silu"))


@pytest.mark.parametrize("m,k,n", [(130, 512, 128), (256, 1024, 2816),
                                   (200, 132, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nm_spmm_matches_plain(gen, m, k, n, dtype):
    vals, idx = _packed(gen, k, n, dtype)
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    _close(nm_spmm(x, vals, idx), nm_spmm_plain(x, vals, idx))
    assert nm_spmm.last_kernel == ("tensor cores" if dtype == torch.bfloat16
                                   else "f32 FMA")


def _packed_with_padding(gen, k, n, dtype):
    """A pruned weight whose columns 0-2 of every 2:4 group hold a kept
    value at position 0 beside a padding slot (idx (0, 0)), two padding
    slots, and a kept value at position 3 (idx (3, 0)), as
    ``compress_24`` packs groups with fewer than two nonzeros."""
    w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
    w = prune_linears({"layers": [{"mlp": {"wo": w}}]},
                      "2:4")["layers"][0]["mlp"]["wo"]
    g = w.view(k // 4, 4, n)
    g[:, :, 0] = torch.tensor([1.5, 0.0, 0.0, 0.0], device="cuda")
    g[:, :, 1] = 0.0
    g[:, :, 2] = torch.tensor([0.0, 0.0, 0.0, -2.0], device="cuda")
    return ops.compress_24(w.to(dtype))


@pytest.mark.parametrize("m", [129, 256, 257])
def test_nm_spmm_bf16_tensor_cores_split_k(gen, m):
    """The tensor-core route at K = 2816 (mlp.wo's depth, split over a
    cluster) and a ragged N: within the f32 tolerance of the plain
    version (bf16 products are exact in f32), padding-slot groups
    included, and the same bits on a second call."""
    k, n = 2816, 200
    vals, idx = _packed_with_padding(gen, k, n, torch.bfloat16)
    assert (idx.view(k // 4, 2, n)[:, :, 1] == 0).all()       # (0, 0)
    assert (idx.view(k // 4, 2, n)[:, 0, 2] == 3).all()       # (3, 0)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    got = nm_spmm(x, vals, idx)
    assert nm_spmm.last_kernel == "tensor cores"
    _close(got, nm_spmm_plain(x, vals, idx))
    assert torch.equal(got, nm_spmm(x, vals, idx))             # deterministic


SERVE_LENGTHS = [96, 70, 65, 0, 33, 128, 17, 81]       # chip_smoke's batch


@pytest.mark.parametrize("b,kv,g,hd,ps,pmax,window,int8,dtype,lengths", [
    (8, 16, 1, 64, 16, 8, None, False, torch.float32, None),
    (3, 2, 2, 16, 8, 3, 5, False, torch.float32, None),
    (2, 1, 8, 32, 16, 2, None, False, torch.float32, None),
    (4, 4, 1, 64, 8, 4, None, True, torch.float32, None),
    (3, 2, 4, 16, 8, 3, 5, True, torch.float32, None),
    # the serving shape in the model's dtype, and with int8 pages
    (8, 16, 1, 64, 16, 8, None, False, torch.bfloat16, SERVE_LENGTHS),
    (8, 16, 1, 64, 16, 8, None, True, torch.bfloat16, SERVE_LENGTHS),
    # one request at 544 keys: 7 splits of 5 pages over a cluster
    (1, 16, 1, 64, 16, 34, None, False, torch.bfloat16, [544]),
    (1, 16, 1, 64, 16, 34, None, False, torch.float32, [537]),
    # the long-prompt serving run: one slot at 544 keys among 7 idle ones
    # in a table 36 pages wide (8 splits of 5 pages)
    (8, 16, 1, 64, 16, 36, None, False, torch.bfloat16, [544] + [0] * 7),
    (8, 16, 1, 64, 16, 36, None, False, torch.float32, [0] * 7 + [529]),
    # gemma-2b's G 8 / hd 256 (G·hd = 2048)
    (2, 1, 8, 256, 16, 2, None, False, torch.float32, None),
    (2, 1, 8, 256, 16, 2, None, True, torch.float32, None),
    (2, 1, 8, 256, 16, 2, None, False, torch.bfloat16, [31, 20]),
    # a window that leaves splits 0-5 of 7 without a live key
    (1, 16, 1, 64, 16, 34, 20, False, torch.float32, [530]),
    (2, 16, 1, 64, 16, 34, 40, True, torch.bfloat16, [530, 0]),
    # an all-idle batch: exact zeros, no key read
    (4, 4, 1, 64, 16, 4, None, False, torch.float32, [0, 0, 0, 0]),
    # a long context: two ring stages a split
    (1, 4, 1, 64, 16, 256, None, False, torch.bfloat16, [4000]),
    # hd off the 16-byte lane slice: the scalar route
    (2, 2, 2, 20, 8, 3, None, False, torch.float32, None),
    # Jamba's attention slot: KV 8, G 8, hd 128 (bf16 and int8 pages)
    (8, 8, 8, 128, 16, 8, None, False, torch.bfloat16, SERVE_LENGTHS),
    (8, 8, 8, 128, 16, 8, None, True, torch.bfloat16, SERVE_LENGTHS)])
def test_paged_attn_matches_plain(gen, b, kv, g, hd, ps, pmax, window, int8,
                                  dtype, lengths):
    """Against the plain version on the same values in f32 (bf16 inputs
    upcast: the plain version rounds bf16 probabilities, the kernel keeps
    f32): within tolerance, idle slots exact zeros, the same bits twice."""
    n_pages = b * pmax + 1
    q = torch.randn(b, kv, g, hd, generator=gen, device="cuda").to(dtype)
    if int8:
        kp, vp = (torch.randint(-127, 128, (n_pages, ps, kv, hd),
                                generator=gen, device="cuda").to(torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(n_pages, ps, kv, generator=gen, device="cuda")
                  / 64 for _ in range(2))
    else:
        kp, vp = (torch.randn(n_pages, ps, kv, hd, generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        ks = vs = None
    if lengths is None:
        lengths = np.random.default_rng(b).integers(1, pmax * ps + 1, size=b)
        lengths[0] = 0                              # an idle slot
    lengths = np.asarray(lengths)
    bt = np.zeros((b, pmax), np.int32)
    pid = 1
    for i, n_ in enumerate(lengths):
        for j in range(-(-int(n_) // ps)):
            bt[i, j] = pid
            pid += 1
    bt = torch.from_numpy(bt).cuda()
    ln = torch.from_numpy(lengths.astype(np.int32)).cuda()
    got = paged_attn(q, kp, vp, bt, ln, window, ks, vs)
    f32 = (lambda t: t) if int8 else (lambda t: t.float())
    _close(got, paged_attn_plain(q.float(), f32(kp), f32(vp), bt, ln, window,
                                 ks, vs))
    assert (got[ln == 0] == 0).all()
    assert torch.equal(got, paged_attn(q, kp, vp, bt, ln, window, ks, vs))
    p = paged_attn.last_plan
    assert 1 <= p.split <= min(pmax, 8) and p.split * p.pages >= pmax
    assert paged_attn.last_kernel == (
        "16-byte copies" if hd % (16 if int8 else 8) == 0 else "scalar loads")


@pytest.mark.parametrize("dtype,int8", [
    (torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)])
def test_paged_attn_shared_block_table(gen, dtype, int8):
    """Every live row maps the same first 3 pages, as a prefix-cache
    attach leaves them, then pages of its own (slot 3 idle): within
    tolerance of the plain version, idle rows exact zeros, the same bits
    twice."""
    b, kv, hd, ps, pmax, shared = 8, 16, 64, 16, 8, 3
    lengths = np.asarray([96, 70, 65, 0, 49, 128, 50, 81])
    n_pages = b * pmax + 1
    q = torch.randn(b, kv, 1, hd, generator=gen, device="cuda").to(dtype)
    if int8:
        kp, vp = (torch.randint(-127, 128, (n_pages, ps, kv, hd),
                                generator=gen, device="cuda").to(torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(n_pages, ps, kv, generator=gen, device="cuda")
                  / 64 for _ in range(2))
    else:
        kp, vp = (torch.randn(n_pages, ps, kv, hd, generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        ks = vs = None
    bt = np.zeros((b, pmax), np.int32)
    pid = 1 + shared
    for i, n_ in enumerate(lengths):
        for j in range(-(-int(n_) // ps)):
            bt[i, j] = 1 + j if j < shared else pid
            pid += j >= shared
    assert (bt[lengths > 0, :shared] == [1, 2, 3]).all()
    bt = torch.from_numpy(bt).cuda()
    ln = torch.from_numpy(lengths.astype(np.int32)).cuda()
    got = paged_attn(q, kp, vp, bt, ln, None, ks, vs)
    f32 = (lambda t: t) if int8 else (lambda t: t.float())
    _close(got, paged_attn_plain(q.float(), f32(kp), f32(vp), bt, ln, None,
                                 ks, vs))
    assert (got[ln == 0] == 0).all()
    assert torch.equal(got, paged_attn(q, kp, vp, bt, ln, None, ks, vs))


def test_paged_attn_offset_pages_take_scalar_loads(gen):
    """Pages that start 2 bytes off 16 (a contiguous view at an odd
    offset) take the scalar route, with the same numbers."""
    b, kv, hd, ps, pmax = 2, 4, 64, 16, 3
    shape = (b * pmax + 1, ps, kv, hd)
    n = math.prod(shape)
    kp, vp = (torch.randn(n + 1, generator=gen, device="cuda").to(
        torch.bfloat16)[1:].view(shape) for _ in range(2))
    q = torch.randn(b, kv, 1, hd, generator=gen,
                    device="cuda").to(torch.bfloat16)
    bt = torch.arange(1, b * pmax + 1, dtype=torch.int32,
                      device="cuda").view(b, pmax)
    ln = torch.tensor([40, 17], dtype=torch.int32, device="cuda")
    got = paged_attn(q, kp, vp, bt, ln)
    assert paged_attn.last_kernel == "scalar loads"
    _close(got, paged_attn_plain(q.float(), kp.float(), vp.float(), bt, ln))


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
                                   "paged_attn": 0, "hessian_accum": 0,
                                   "nm_select": 0, "flash_attn": 0}


# ----------------------------------------------------------------------
# pruning-pass kernels
# ----------------------------------------------------------------------
@pytest.mark.parametrize("t,m", [(16384, 1024), (200, 70), (1, 64),
                                 (4097, 130), (262144, 1024), (16384, 2816)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.25, 0.75)])
def test_hessian_accum_matches_plain(gen, t, m, dtype, alpha, beta):
    """Both routes (bf16 rows on 16 bytes: tensor cores; else f32 FMA),
    the split token range summed in order: within tolerance, exactly
    symmetric, the same bits twice.  Both sides sum T terms in f32, so
    past T = 16384 the tolerance grows as sqrt(T / 16384), as
    chip_smoke's stacked row."""
    x = torch.randn(t, m, generator=gen, device="cuda").to(dtype)
    if t > 16384:
        alpha = alpha / t                            # the stacked call's 1/T
    h0 = torch.randn(m, m, generator=gen, device="cuda")
    h0 = h0 + h0.T
    want = hessian_accum_plain(x, h0.clone(), alpha, beta)
    got = h0.clone() if beta else torch.full_like(h0, float("nan"))
    hessian_accum(x, got, alpha, beta)
    tc = dtype == torch.bfloat16 and m % 8 == 0
    assert hessian_accum.last_kernel == ("tensor cores" if tc else "f32 FMA")
    err = (got - want).abs().max().item()
    tol = REL_TOL * max(1.0, math.sqrt(t / 16384))
    assert err <= tol * max(1.0, want.abs().max().item()), err
    assert torch.equal(got, got.T)                   # mirrored exactly
    again = h0.clone() if beta else torch.full_like(h0, float("nan"))
    assert torch.equal(got, hessian_accum(x, again, alpha, beta))


def test_hessian_accum_unaligned_bf16_takes_the_fma_kernel(gen):
    flat = torch.randn(300 * 64 + 1, generator=gen,
                       device="cuda").to(torch.bfloat16)
    x = flat[1:].view(300, 64)                       # rows 2 bytes off 16
    got = hessian_accum(x, torch.empty(64, 64, device="cuda"))
    assert hessian_accum.last_kernel == "f32 FMA"
    _close(got, hessian_accum_plain(x, torch.empty(64, 64, device="cuda")))
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("t,m", [(40960, 4096), (4097, 130), (200, 64),
                                 (1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["bool", "float", "zero"])
def test_hessian_accum_weighted_matches_plain(gen, t, m, dtype, kind):
    """The weighted form (a MoE expert's routed tokens) on both routes —
    bool weights keep the tensor cores for bf16 rows on 16 bytes, float
    weights take the f32 FMA — against the plain version, from a count c
    on the device: H within tolerance, exactly symmetric, the same bits
    twice, c + Σw written back with no host sync; an all-zero w leaves H
    and c as they were."""
    x = torch.randn(t, m, generator=gen, device="cuda").to(dtype)
    if kind == "float":
        w = torch.rand(t, generator=gen, device="cuda")
    else:
        w = torch.rand(t, generator=gen, device="cuda") < (
            0.0 if kind == "zero" else 0.8)
    h0 = torch.randn(m, m, generator=gen, device="cuda")
    h0 = h0 + h0.T
    c0 = torch.full((), 0.5 * t, device="cuda")
    hp, cp = h0.clone(), c0.clone()
    want = hessian_accum_weighted_plain(x, w, hp, cp)
    got, c = h0.clone(), c0.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hessian_accum_weighted(x, w, got, c)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tc = dtype == torch.bfloat16 and m % 8 == 0 and kind != "float"
    assert hessian_accum.last_kernel == ("tensor cores" if tc else "f32 FMA")
    err = (got - want).abs().max().item()
    tol = REL_TOL * max(1.0, math.sqrt(t / 16384))
    assert err <= tol * max(1.0, want.abs().max().item()), err
    assert torch.equal(got, got.T)
    assert c.item() == pytest.approx(cp.item(), rel=1e-6)
    again, c2 = h0.clone(), c0.clone()
    assert torch.equal(got, hessian_accum_weighted(x, w, again, c2))
    if kind == "zero":
        assert torch.equal(got, h0) and c.item() == c0.item()


def test_weighted_calibration_from_zero_count_on_card(gen):
    """An expert whose tokens all weigh 0 keeps H = 0 and count 0 (the
    1e-8 dampening floor then stands alone), through CalibrationSet."""
    from repro_torch.core.calibration import CalibrationSet

    x = torch.randn(5, 40, 64, generator=gen, device="cuda").to(
        torch.bfloat16)
    valid = torch.zeros(5, 40, dtype=torch.bool, device="cuda")
    valid[1:] = torch.rand(4, 40, generator=gen, device="cuda") < 0.7
    cs = CalibrationSet()
    for e in range(5):
        cs.update({f"moe.wi.{e}": (x[e], valid[e])})
    assert not cs.hessian("moe.wi.0").any()
    assert cs.accs["moe.wi.0"].count.item() == 0.0
    with ops.override_dispatch(plain=True):
        plain = CalibrationSet()
        for e in range(5):
            plain.update({f"moe.wi.{e}": (x[e], valid[e])})
    for e in range(1, 5):
        _close(cs.hessian(f"moe.wi.{e}"), plain.hessian(f"moe.wi.{e}"))


def test_moe_block_on_card_matches_plain(gen):
    """phi3.5-moe's SMOKE (f32) on the card: the forward, a capture's
    weighted Hessians and a static greedy serve, with the kernels against
    the plain override; the serve is static with continuous asked."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.calibration import CalibrationSet
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_smoke("phi3_5_moe_42b_a6_6b")
    model = LM(cfg, device="cuda")
    params = prune_linears(model.init(gen), "2:4")
    params["embed"]["tok"] = params["embed"]["tok"] * 8.0
    toks = torch.randint(0, 256, (3, 37), generator=gen, device="cuda")
    seg = model.prunable_segments()[0]
    sp = seg.get_params(params)
    h0 = model.calib_init(params, {"tokens": toks})
    _, caps = seg.apply(sp, h0, capture=True)
    ops.reset_launch_counts()
    got = model.forward(params, toks)
    kern = CalibrationSet.from_captures(caps)
    counts = ops.launch_counts()
    with ops.override_dispatch(plain=True):
        want = model.forward(params, toks)
        plain = CalibrationSet.from_captures(caps)
    _close(got, want)
    assert counts["flash_attn"] == cfg.num_layers
    assert counts["hessian_accum"] == 4 + 1 + 3 * cfg.moe.num_experts
    for name in kern.names():
        _close(kern.hessian(name), plain.hessian(name))
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, 256, size=12,
                                               dtype=np.int32),
                    max_new_tokens=8) for i in range(4)]
    eng = ServeEngine(model, params, max_batch=4, max_len=32,
                      mode="continuous")
    assert eng.mode == "static"
    a = eng.generate(reqs)
    with ops.override_dispatch(plain=True):
        b = eng.generate(reqs)
    assert [r.tokens.tolist() for r in a] == [r.tokens.tolist() for r in b]


@pytest.mark.parametrize("r,c", [(1024, 128), (2816, 1024), (33, 20),
                                 (1, 4), (130, 4100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_nm_select_matches_plain(gen, r, c, dtype, offset):
    """Bit-equal masks, no tie allowance: the kernel rounds each step of
    the pair losses as the plain version does.  ``offset`` 1 starts w
    and Hinv one element off their load width: the scalar route."""
    w = torch.randn(r * c + offset, generator=gen, device="cuda").to(dtype)
    w = w[offset:].view(r, c)
    a = torch.randn(c, c, generator=gen, device="cuda")
    hinv = torch.empty(c * c + offset, device="cuda")
    hinv = hinv[offset:].view(c, c)
    hinv.copy_(a @ a.T / c + torch.eye(c, device="cuda"))
    got = nm_select(w, hinv)
    assert nm_select.last_kernel == ("scalar loads" if offset
                                     else "vector loads")
    assert torch.equal(got, nm_select_plain(w, hinv))
    assert (got.reshape(r, c // 4, 4).sum(-1) == 2).all()


def test_nm_select_reads_strided_views(gen):
    """A column block of w and a diagonal block of Hinv, as the MM block
    loop hands them over, without copies."""
    w = torch.randn(64, 512, generator=gen, device="cuda")
    a = torch.randn(512, 512, generator=gen, device="cuda")
    hinv = a @ a.T / 512 + torch.eye(512, device="cuda")
    wb, hb = w[:, 128:256], hinv[128:256, 128:256]
    assert torch.equal(nm_select(wb, hb),
                       nm_select_plain(wb.contiguous(), hb.contiguous()))
    assert nm_select.last_kernel == "vector loads"
    wb, hb = w[:, 130:258], hinv[130:258, 130:258]   # 8 bytes off 16
    assert torch.equal(nm_select(wb, hb),
                       nm_select_plain(wb.contiguous(), hb.contiguous()))
    assert nm_select.last_kernel == "scalar loads"


def test_prune_matrix_mm_runs_both_kernels_and_matches_plain(gen):
    x = torch.randn(4096, 256, generator=gen, device="cuda")
    w = torch.randn(96, 256, generator=gen, device="cuda")
    ops.reset_launch_counts()
    h = ops.hessian_xxt(x.T) / 4096
    res = prune_matrix(w, h, "2:4", method="MM", blocksize=128)
    counts = ops.launch_counts()
    assert counts["hessian_accum"] == 1 and counts["nm_select"] == 2
    with ops.override_dispatch(plain=True):
        ref = prune_matrix(w, h, "2:4", method="MM", blocksize=128)
    assert torch.equal(res.mask, ref.mask)
    _close(res.w, ref.w)


# ----------------------------------------------------------------------
# full-sequence attention
# ----------------------------------------------------------------------
BF16_TOL_REL = 1e-4     # bf16 inputs, |kernel - plain| / max(1, |plain|):
                        # both compute in f32, the kernel keeps ~16 bits of P


@pytest.mark.parametrize("b,t,h,kv,hd", [
    (2, 128, 2, 2, 32), (1, 200, 4, 2, 64), (2, 2048, 4, 2, 64),
    (3, 100, 2, 1, 128), (1, 1, 1, 1, 64), (2, 65, 3, 3, 16),
    (1, 100, 2, 1, 200)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_matches_plain(gen, b, t, h, kv, hd, causal, dtype):
    q = torch.randn(b, t, h, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, t, kv, hd, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    got = flash_attn(q, k, v, causal)
    tensor_cores = dtype == torch.bfloat16 and hd in (32, 64, 128, 256)
    assert flash_attn.last_kernel == ("tensor cores" if tensor_cores
                                      else "f32 FMA")
    want = flash_attn_plain(q, k, v, causal)
    assert got.dtype == torch.float32 and got.shape == (b, t, h, hd)
    if dtype == torch.float32:
        _close(got, want)
    else:
        err = (got - want).abs().max().item()
        assert err <= BF16_TOL_REL * max(1.0, want.abs().max().item()), err
    assert torch.equal(got, flash_attn(q, k, v, causal))   # deterministic


@pytest.mark.parametrize("t", [127, 129, 130, 257])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_tensor_cores_ragged_query_tiles(gen, t, hd, causal):
    """128-row query tiles with a ragged edge (T around 128 and 256),
    grouped-query heads (G = 2), every head dim of the tensor-core
    kernel: within BF16_TOL_REL of the plain version, deterministic."""
    q = torch.randn(2, t, 4, hd, generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(2, t, 2, hd, generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    got = flash_attn(q, k, v, causal)
    assert flash_attn.last_kernel == "tensor cores"
    want = flash_attn_plain(q, k, v, causal)
    err = (got - want).abs().max().item()
    assert err <= BF16_TOL_REL * max(1.0, want.abs().max().item()), err
    assert torch.equal(got, flash_attn(q, k, v, causal))   # deterministic


def test_flash_attn_reads_strided_views(gen):
    """q, k, v as column slices of one packed (B, T, 3, H, hd) tensor."""
    qkv = torch.randn(2, 150, 3, 4, 64, generator=gen, device="cuda")
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = flash_attn(q, k, v, True)
    assert torch.equal(got, flash_attn(q.contiguous(), k.contiguous(),
                                       v.contiguous(), True))
    _close(got, flash_attn_plain(q, k, v, True))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_tensor_cores_keep_probabilities_near_f32(gen, causal):
    """The bf16 tensor-core kernel multiplies V by P split into two bf16
    halves: ~16 bits of each probability, so it lands within 1e-4 of the
    f32 plain version (one bf16 rounding of P would be ~1e-3 off)."""
    q, k, v = (torch.randn(2, 512, 4, 64, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    got = flash_attn(q, k, v, causal)
    assert flash_attn.last_kernel == "tensor cores"
    assert (got - flash_attn_plain(q, k, v, causal)).abs().max().item() < 1e-4


def _flash_case(gen, b, t, h, kv, hd, dtype):
    q = torch.randn(b, t, h, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, t, kv, hd, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def _flash_close(got, want, dtype):
    err = (got - want).abs().max().item()
    tol = (REL_TOL if dtype == torch.float32 else BF16_TOL_REL) * max(
        1.0, want.abs().max().item())
    assert err <= tol, err


@pytest.mark.parametrize("b,t,h,kv", [(2, 128, 2, 2), (1, 129, 4, 2),
                                      (1, 257, 8, 1), (1, 2048, 8, 1),
                                      (2, 65, 16, 8)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_hd256_matches_plain(gen, b, t, h, kv, causal, dtype):
    """gemma's head dim: bf16 on the tensor cores (Q read from shared
    memory, 32-key tiles), f32 on the FMA kernel (16-key tiles); G 1, 2
    and 8; ragged query tiles."""
    q, k, v = _flash_case(gen, b, t, h, kv, 256, dtype)
    got = flash_attn(q, k, v, causal)
    assert flash_attn.last_kernel == ("tensor cores"
                                      if dtype == torch.bfloat16
                                      else "f32 FMA")
    assert got.shape == (b, t, h, 256)
    _flash_close(got, flash_attn_plain(q, k, v, causal), dtype)
    assert torch.equal(got, flash_attn(q, k, v, causal))   # deterministic


@pytest.mark.parametrize("t,window,hd", [
    (t, w, hd) for t, w in ((257, 64), (300, 1), (129, 100), (200, 200),
                            (130, 500))
    for hd in (16, 32, 64, 128, 256)] + [(2100, 1024, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_window_matches_plain(gen, t, window, hd, dtype):
    """A causal sliding window on every route: bands narrower than a key
    tile (window 1, 64), ragged T, a window ≥ T (no key masked), and
    gemma3's band (hd 256, window 1024) past T 2048; a non-causal call
    ignores the window."""
    q, k, v = _flash_case(gen, 1, t, 4, 2, hd, dtype)
    got = flash_attn(q, k, v, True, window)
    tensor_cores = dtype == torch.bfloat16 and hd != 16
    assert flash_attn.last_kernel == ("tensor cores" if tensor_cores
                                      else "f32 FMA")
    _flash_close(got, flash_attn_plain(q, k, v, True, window), dtype)
    assert torch.equal(got, flash_attn(q, k, v, True, window))
    if window >= t:
        assert torch.equal(got, flash_attn(q, k, v, True))
    assert torch.equal(flash_attn(q, k, v, False, window),
                       flash_attn(q, k, v, False))


@pytest.mark.parametrize("prefix", [1, 63, 64, 65, 256, 320])
@pytest.mark.parametrize("hd,h,kv", [(256, 8, 1), (64, 4, 4), (64, 4, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_prefix_matches_plain(gen, prefix, hd, h, kv, dtype):
    """The prefix-LM's bidirectional prefix at PaliGemma's T 320 (256
    image + 64 text positions): prefixes inside a key tile, on its edges,
    the whole image and the whole sequence (= non-causal), on every
    route — PaliGemma's hd 256 / MQA and hd 64 at G 1 and 2; the prefix
    moves the result, and a non-causal call ignores it."""
    q, k, v = _flash_case(gen, 2, 320, h, kv, hd, dtype)
    got = flash_attn(q, k, v, True, None, prefix)
    assert flash_attn.last_kernel == ("tensor cores"
                                      if dtype == torch.bfloat16
                                      else "f32 FMA")
    _flash_close(got, flash_attn_plain(q, k, v, True, None, prefix), dtype)
    assert torch.equal(got, flash_attn(q, k, v, True, None, prefix))
    if prefix >= 320:
        assert torch.equal(got, flash_attn(q, k, v, False))
    elif prefix == 1:            # key 0: every causal row sees it already
        assert torch.equal(got, flash_attn(q, k, v, True))
    else:
        assert not torch.equal(got, flash_attn(q, k, v, True))
    assert torch.equal(flash_attn(q, k, v, False, None, prefix),
                       flash_attn(q, k, v, False))


@pytest.mark.parametrize("t,s", [(1, 1024), (64, 1024), (200, 129),
                                 (1024, 1024), (130, 1)])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_cross_matches_plain(gen, t, s, hd, dtype):
    """Non-causal attention of T queries over S ≠ T keys (the decoder's
    cross-attention over the encoder's frames) at seamless's 16 / 16
    heads: ragged query and key tiles on every route; a causal call
    with S ≠ T raises."""
    q = torch.randn(2, t, 16, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(2, s, 16, hd, generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    got = flash_attn(q, k, v, False)
    assert flash_attn.last_kernel == ("tensor cores"
                                      if dtype == torch.bfloat16
                                      else "f32 FMA")
    assert got.shape == (2, t, 16, hd)
    _flash_close(got, flash_attn_plain(q, k, v, False), dtype)
    assert torch.equal(got, flash_attn(q, k, v, False))
    if s != t:
        with pytest.raises(ValueError, match="as many keys"):
            flash_attn(q, k, v, True)


def test_flash_attn_hd256_unaligned_bf16_takes_the_fma_kernel(gen):
    flat = torch.randn(1 * 70 * 2 * 256 + 1, generator=gen,
                       device="cuda").to(torch.bfloat16)
    q = flat[1:].view(1, 70, 2, 256)             # rows 2 bytes off 16
    k, v = (torch.randn(1, 70, 1, 256, generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    got = flash_attn(q, k, v, True, 9)
    assert flash_attn.last_kernel == "f32 FMA"
    _flash_close(got, flash_attn_plain(q, k, v, True, 9), torch.bfloat16)


def test_flash_attn_unaligned_bf16_takes_the_fma_kernel(gen):
    flat = torch.randn(2 * 100 * 2 * 64 + 1, generator=gen,
                       device="cuda").to(torch.bfloat16)
    k = flat[1:].view(2, 100, 2, 64)             # rows 2 bytes off 16
    v = torch.randn(2, 100, 2, 64, generator=gen,
                    device="cuda").to(torch.bfloat16)
    q = torch.randn(2, 100, 4, 64, generator=gen,
                    device="cuda").to(torch.bfloat16)
    got = flash_attn(q, k, v, True)
    assert flash_attn.last_kernel == "f32 FMA"
    assert (got - flash_attn_plain(q, k, v, True)).abs().max().item() < 1e-4


@pytest.mark.parametrize("t", [128, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_signature(gen, t, causal):
    from repro_torch.kernels.ref import flash_attn_ref

    q, k, v = (torch.randn(4, t, 64, generator=gen, device="cuda")
               for _ in range(3))
    ops.reset_launch_counts()
    got = ops.attention(q, k, v, causal)
    assert ops.launch_counts()["flash_attn"] == 1 and got.shape == q.shape
    _close(got, flash_attn_ref(q, k, v, causal))


def test_pipelined_prune_resumes_bit_identical_on_card(gen, tmp_path):
    from repro_torch.ckpt import PruneProgressStore
    from repro_torch.configs import get_smoke
    from repro_torch.core.engine import PruningEngine
    from repro_torch.models.transformer import LM

    model = LM(get_smoke("qwen1_5_0_5b"), device="cuda")
    params = model.init(gen)
    toks = torch.randint(0, model.cfg.vocab_size, (4, 2, 64), generator=gen,
                         device="cuda")
    calib = [{"tokens": x, "labels": x} for x in toks]
    ops.reset_launch_counts()
    ref, _ = PruningEngine(model, "2:4", method="MM", blocksize=32).run(
        params, calib)
    counts = ops.launch_counts()
    assert counts["flash_attn"] == 2 * model.cfg.num_layers
    assert counts["hessian_accum"] == 7 * model.cfg.num_layers

    class Bomb(PruneProgressStore):
        def save(self, next_segment, flat):
            super().save(next_segment, flat)
            raise RuntimeError("simulated node failure")

    with pytest.raises(RuntimeError):
        PruningEngine(model, "2:4", method="MM", blocksize=32,
                      progress_store=Bomb(str(tmp_path))).run(params, calib)
    got, reports = PruningEngine(
        model, "2:4", method="MM", blocksize=32,
        progress_store=PruneProgressStore(str(tmp_path))).run(params, calib)
    assert len(reports) == 7 * (model.cfg.num_layers - 1)
    for a, b in zip(model.params_to_flat(ref).values(),
                    model.params_to_flat(got).values()):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ----------------------------------------------------------------------
# slice 8: threefry on the card, the gradient guard, the trainer's route
# ----------------------------------------------------------------------
def test_threefry_on_card_equals_cpu(gen):
    """The integer bit path runs the same ops on both devices."""
    from repro_torch import random as rnd

    keys = rnd.fold_in(rnd.fold_in(rnd.key(7, "cuda"),
                                   torch.arange(8, device="cuda")), 3)
    for shape in ((151936,), (3, 5)):
        assert torch.equal(rnd.random_bits(keys, shape).cpu(),
                           rnd.random_bits(keys.cpu(), shape))
        assert torch.equal(rnd.uniform(keys, shape).cpu(),
                           rnd.uniform(keys.cpu(), shape))
    assert torch.equal(rnd.split(keys, 4).cpu(), rnd.split(keys.cpu(), 4))


def test_wrappers_refuse_grad_on_card(gen):
    q = torch.randn((1, 64, 2, 32), device="cuda", generator=gen,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attn: an input requires"):
        flash_attn(q, q, q)
    with torch.no_grad():
        assert flash_attn(q, q, q).shape == q.shape
    x = torch.randn((4, 64), device="cuda", generator=gen,
                    requires_grad=True)
    vals, idx = _packed(gen, 64, 32, torch.float32)
    with pytest.raises(RuntimeError, match="nm_spmm_decode: an input"):
        nm_spmm_decode(x, vals, idx)


def test_differentiable_route_trains_on_card(gen):
    """Every param leaf gets a gradient, no kernel launches, and the loss
    equals the kernel route's."""
    from repro_torch import configs
    from repro_torch import random as rnd
    from repro_torch.data import DataPipeline
    from repro_torch.models.transformer import LM
    from repro_torch.optim import tree_leaves

    cfg = configs.get_smoke("paper_tiny_lm")
    model = LM(cfg, device="cuda")
    params = model.init(rnd.key(0, "cuda"))
    batch = DataPipeline(cfg, 4, 32, device="cuda").batch_at(0)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    ops.reset_launch_counts()
    loss, _ = model.loss_fn(params, batch, differentiable=True)
    grads = torch.autograd.grad(loss, leaves)
    assert not any(ops.launch_counts().values())
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
    with torch.no_grad():
        plain, _ = model.loss_fn(params, batch)
    assert abs(float(loss.detach()) - float(plain)) <= 1e-4 * float(plain)


@pytest.mark.parametrize("m,k,n,act", [(8, 8192, 24576, "silu"),
                                       (8, 24576, 8192, None),
                                       (256, 8192, 24576, None),
                                       (256, 24576, 8192, None)])
def test_nm_spmm_at_jamba_ffn_shapes(gen, m, k, n, act):
    """Jamba's FFN (d_model 8192, d_ff 24576) packed 2:4, bf16: the
    decode kernel's cluster K-split at K = 24576 and the tiled kernel,
    within the f32 tolerance of the plain version, the same bits twice."""
    vals, idx = _packed(gen, k, n, torch.bfloat16)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    if m <= 128:
        got = nm_spmm_decode(x, vals, idx, None, act)
        assert nm_spmm_decode.last_kernel == "tensor cores"
        _close(got, nm_spmm_decode_plain(x, vals, idx, None, act))
        assert torch.equal(got, nm_spmm_decode(x, vals, idx, None, act))
    else:
        got = nm_spmm(x, vals, idx)
        assert nm_spmm.last_kernel == "tensor cores"
        _close(got, nm_spmm_plain(x, vals, idx))
        assert torch.equal(got, nm_spmm(x, vals, idx))


def _hybrid_cfg(dtype="float32"):
    from repro_torch.models.base import ArchConfig

    return ArchConfig(name="hybrid-cuda-test", family="hybrid",
                      num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=256,
                      period=("mamba", "attn"), mlp_kind="swiglu",
                      ssm_mlp=True, ssm_state=4, ssm_conv=4, dtype=dtype)


def test_hybrid_serves_on_card_continuous_equals_static(gen):
    """A 2:4-pruned Mamba/attention hybrid on the card: continuous (with
    a starved pool too) and static greedy streams equal; the packed FFN
    and attention linears launch the 2:4 kernels, the attention slot
    paged_attn; recompute preemption only, no prefix index."""
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine

    model = LM(_hybrid_cfg(), device="cuda")
    params = prune_linears(model.init(gen), "2:4")
    params["unembed"]["head"] = params["unembed"]["head"] * 8.0
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, 256, size=(4, 7, 12)[i % 3],
                                               dtype=np.int32),
                    max_new_tokens=(2, 5, 9, 14)[i % 4]) for i in range(8)]
    static = ServeEngine(model, params, max_batch=4, max_len=48,
                         mode="static").generate(reqs)
    for kw in (dict(), dict(num_pages=6)):
        eng = ServeEngine(model, params, max_batch=4, max_len=48,
                          page_size=8, prefill_chunk=8, **kw)
        assert eng.pool.prefix is None and not eng._swap_ok
        ops.reset_launch_counts()
        res = eng.generate(reqs)
        counts = ops.launch_counts()
        assert counts["nm_spmm_decode"] > 0 and counts["paged_attn"] > 0
        for a, b in zip(res, static):
            np.testing.assert_array_equal(a.tokens, b.tokens)
        assert eng.stats["preempt_swap"] == 0
        if kw:
            assert eng.stats["preempt_recompute"] > 0


def test_mamba_differentiable_route_on_card(gen):
    """The tiny Mamba LM's training route on the card: every leaf gets a
    finite gradient, no kernel launches, the loss equals the eval
    route's."""
    from repro_torch import random as rnd
    from repro_torch.configs.paper_tiny_lm import MAMBA
    from repro_torch.data import DataPipeline
    from repro_torch.models.transformer import LM
    from repro_torch.optim import tree_leaves

    model = LM(MAMBA, device="cuda")
    params = model.init(rnd.key(0, "cuda"))
    batch = DataPipeline(MAMBA, 4, 32, device="cuda").batch_at(0)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    ops.reset_launch_counts()
    loss, _ = model.loss_fn(params, batch, differentiable=True)
    grads = torch.autograd.grad(loss, leaves)
    assert not any(ops.launch_counts().values())
    assert all(torch.isfinite(g).all() for g in grads)
    with torch.no_grad():
        plain, _ = model.loss_fn(params, batch)
    assert abs(float(loss.detach()) - float(plain)) <= 1e-5 * float(plain)


def test_replica_threads_serve_on_card_under_no_grad(gen):
    """Two replica worker threads serve the card: the workers step under
    ``torch.no_grad()`` — params that require grad (a trainer's live
    leaves) reach the kernel wrappers without tripping ``refuse_grad`` —
    and their streams equal a main-thread ``generate``, whichever
    replica served a request.  ``launch_counts()`` is exact with both
    workers launching: 7 packed linears a layer for every model pass
    (each burst's k decode steps, plus its chunk) and one paged_attn a
    layer for every decode step, read off the bursts' trace spans."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.frontend import (CompletionRequest, Replica,
                                            Router)

    cfg = get_smoke("qwen1_5_0_5b")
    model = LM(cfg, device="cuda")
    params = prune_linears(model.init(gen), "2:4")
    knobs = dict(max_batch=4, max_len=48, page_size=8, prefill_chunk=8,
                 steps_per_sync=2)
    ref = ServeEngine(model, params, **knobs)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, 256, size=(4, 7, 12)[i % 3],
                                               dtype=np.int32),
                    max_new_tokens=(5, 9, 14)[i % 3]) for i in range(8)]
    want = {r.uid: r.tokens.tolist() for r in ref.generate(reqs)}
    live = dict(ref.params)
    live["embed"] = {k: v.clone().requires_grad_(True)
                     for k, v in ref.params["embed"].items()}
    router = Router([Replica(ServeEngine(model, live, trace=True, **knobs),
                             name=f"r{i}") for i in range(2)])
    try:
        ops.reset_launch_counts()
        with torch.enable_grad():                 # the caller's grad mode
            out = router.complete([CompletionRequest(
                prompt=r.prompt.tolist(), max_tokens=r.max_new_tokens,
                uid=r.uid) for r in reqs])
        counts = ops.launch_counts()
    finally:
        router.close()
    assert sorted({o.replica for o in out}) == ["r0", "r1"]
    assert {o.uid: o.tokens for o in out} == want
    steps = chunks = 0
    for rep in router.replicas:
        for ev in rep.engine.obs.tracer.events(ph="X"):
            if ev["name"] in ("decode_burst", "prefill_burst"):
                steps += ev["args"]["k"]
                chunks += ev["name"] == "prefill_burst"
    layers = cfg.num_layers
    assert steps > 0 and chunks > 0
    assert counts["nm_spmm_decode"] == 7 * layers * (steps + chunks)
    assert counts["paged_attn"] == layers * steps
    for k in ("nm_spmm", "hessian_accum", "nm_select", "flash_attn"):
        assert counts[k] == 0


def test_collectives_on_a_one_rank_nccl_group(gen):
    """Distribution on the card: a host mesh is a 1-rank NCCL group; the
    Hessian all-reduce returns H, the row-parallel solve (nm_select on
    the card) gives the one-device row-balanced mask, compressed_psum is
    within one int8 step, every tensor staying on the card."""
    from repro_torch.core.distributed import (hessian_allreduce,
                                              prune_matrix_sharded)
    from repro_torch.dist import comm, mesh_from_spec
    from repro_torch.optim.compression import compressed_psum

    mesh = mesh_from_spec("host", "cuda")
    assert torch.distributed.get_backend() == "nccl"
    w = torch.randn(256, 512, generator=gen, device="cuda")
    x = torch.randn(2048, 512, generator=gen, device="cuda")
    h = 2.0 * (x.T @ x) / x.shape[0]
    merged = hessian_allreduce(mesh, h, 2048.0, "data")
    assert merged.is_cuda and torch.allclose(merged, h, rtol=1e-6, atol=0)
    ops.reset_launch_counts()
    w_sh, m_sh = prune_matrix_sharded(w, h, "2:4", mesh, method="MM",
                                      blocksize=128)
    assert ops.launch_counts()["nm_select"] > 0
    ref = prune_matrix(w, h, "2:4", method="MM", blocksize=128,
                       row_balanced=True)
    assert torch.equal(m_sh, ref.mask)
    _close(w_sh, ref.w)
    flat = w.reshape(-1)
    out = compressed_psum(flat, comm.group_of(mesh, "data"))
    assert out.is_cuda
    assert (out - flat).abs().max().item() <= flat.abs().max().item() / 127
