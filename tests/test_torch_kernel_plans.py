"""The host-side plans of the port's kernels, on CPU.

``hessian_accum.plan``, ``nm_spmm.decode_plan``, ``paged_attn.plan`` and
``nm_select.plan`` are pure Python: which route each (dtype, shape,
alignment) takes, how the Hessian's token range is split, how the decode
product's K and the decode attention's pages are split over a cluster,
and how nm_select's grid covers the groups.  The kernels themselves run
only on the card (tests/test_torch_cuda.py).
"""

import inspect

import pytest
import torch

from repro_torch.kernels import hessian_accum as H
from repro_torch.kernels import nm_select as N
from repro_torch.kernels import nm_spmm as S
from repro_torch.kernels import paged_attn as P

SMS = 132                                            # an H100 SXM


@pytest.mark.parametrize("dtype,m,aligned,route", [
    (torch.bfloat16, 1024, True, "tensor cores"),
    (torch.bfloat16, 2816, True, "tensor cores"),
    (torch.bfloat16, 64, True, "tensor cores"),
    (torch.bfloat16, 130, True, "f32 FMA"),          # rows off 16 bytes
    (torch.bfloat16, 70, True, "f32 FMA"),
    (torch.bfloat16, 1024, False, "f32 FMA"),        # pointer off 16 bytes
    (torch.float32, 1024, True, "f32 FMA"),          # f32 stays f32 math
])
def test_hessian_route(dtype, m, aligned, route):
    p = H.plan(dtype, 4096, m, aligned, SMS)
    assert p.route == route and p.tile == H.TILE[route]
    nb = -(-m // p.tile)
    assert p.tiles == nb * (nb + 1) // 2


@pytest.mark.parametrize("t,m,split", [
    (262144, 1024, 7),    # the stacked call: 36 tiles x 7 = 252 of 264
    (16384, 1024, 7),     # a serial batch
    (262144, 2816, 1),    # 253 tiles already fill a wave
    (16384, 2816, 1),
    (1, 64, 1),
])
def test_hessian_split_on_the_main_path(t, m, split):
    p = H.plan(torch.bfloat16, t, m, True, SMS)
    assert p.route == "tensor cores" and p.split == split
    blocks = p.tiles * p.split
    cap = H.BLOCKS_PER_SM * SMS
    assert blocks / (-(-blocks // cap) * cap) >= H.FILL or p.split == 1


def test_hessian_empty_capture_takes_the_fma_kernel():
    p = H.plan(torch.bfloat16, 0, 1024, True, SMS)
    assert p.route == "f32 FMA" and p.split == 1


@pytest.mark.parametrize("t", [1, 31, 32, 33, 127, 128, 200, 4097, 16384,
                               262144])
@pytest.mark.parametrize("m", [64, 70, 130, 1024, 2816])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hessian_split_keeps_every_token_range_nonempty(t, m, dtype):
    """The kernels give split s the chunks [s·C/S, (s+1)·C/S): every range
    holds at least one chunk (at least MIN_CHUNKS where S > 1)."""
    for sms in (1, 8, 132):
        p = H.plan(dtype, t, m, True, sms)
        chunks = -(-t // H.CHUNK)
        assert 1 <= p.split <= chunks
        sizes = [(s + 1) * chunks // p.split - s * chunks // p.split
                 for s in range(p.split)]
        assert sum(sizes) == chunks
        assert min(sizes) >= (H.MIN_CHUNKS if p.split > 1 else 1)
        assert p.tiles * p.split <= max(
            p.tiles, H.MAX_WAVES * H.BLOCKS_PER_SM * sms)


def h100(mb, c):
    """Clusters of c one-block-an-SM blocks that 8 GPCs of 16 SMs hold."""
    return 8 * (16 // c)


@pytest.mark.parametrize("dtype,n,aligned,route", [
    (torch.bfloat16, 1024, True, "tensor cores"),
    (torch.bfloat16, 200, True, "tensor cores"),     # ragged strip
    (torch.bfloat16, 100, True, "f32 FMA"),          # rows off 8 columns
    (torch.bfloat16, 1024, False, "f32 FMA"),        # pointer off
    (torch.float32, 1024, True, "f32 FMA"),
])
def test_decode_route(dtype, n, aligned, route):
    assert S.decode_plan(dtype, 8, 1024, n, aligned, h100).route == route


@pytest.mark.parametrize("m,mb,row_blocks", [
    (1, 1, 1), (8, 1, 1), (9, 2, 1), (16, 2, 1), (17, 4, 1), (32, 4, 1),
    (33, 4, 2), (64, 4, 2), (128, 4, 4)])
def test_decode_batch_fragments(m, mb, row_blocks):
    p = S.decode_plan(torch.bfloat16, m, 1024, 1024, True, h100)
    assert (p.mb, p.row_blocks) == (mb, row_blocks)


@pytest.mark.parametrize("m,k,n,cluster", [
    (8, 1024, 1024, 16),   # attn.wq/wk/wv/wo: 8 strips x 16 = 128 blocks
    (8, 1024, 2816, 5),    # mlp.wi/wg: 22 strips x 5 = 110
    (8, 2816, 1024, 16),   # mlp.wo
    (32, 1024, 2816, 5),   # the prefill chunk
    (128, 1024, 1024, 4),  # 4 row blocks x 8 strips x 4 = 128
    (8, 132, 200, 2),      # 9 K steps: 2 blocks x 4 slices
    (32, 132, 200, 2),
    (8, 16, 64, 1),
])
def test_decode_cluster_split(m, k, n, cluster):
    p = S.decode_plan(torch.bfloat16, m, k, n, True, h100)
    assert p.route == "tensor cores" and p.cluster == cluster
    assert -(-n // S.DECODE_BN) * p.row_blocks <= h100(p.mb, p.cluster)


def test_decode_without_room_for_a_cluster_does_not_split():
    # a card that runs no cluster at once, or too shallow a K
    p = S.decode_plan(torch.bfloat16, 32, 16384, 128, True, lambda mb, c: 0)
    assert p.route == "tensor cores" and p.cluster == 1
    assert S.decode_plan(torch.bfloat16, 8, 64, 128, True,
                         h100).cluster == 1


# ----------------------------------------------------------------------
# paged_attn: the page range split over a cluster, from shapes alone
# ----------------------------------------------------------------------
@pytest.mark.parametrize("b,p_max,split,pages", [
    (8, 8, 2, 4),       # chip_smoke's batch of 8: 4 pages (64 keys) a split
    (1, 34, 7, 5),      # one request at 512-544 keys: 7 splits of 5 pages
    (8, 36, 8, 5),      # the long prompt among 7 idle slots
    (1, 1, 1, 1),
])
def test_paged_plan_on_the_main_path(b, p_max, split, pages):
    p = P.plan(b, 16, 1, 64, 16, p_max, torch.bfloat16)
    assert (p.split, p.pages) == (split, pages)
    assert (p.heads, p.head_blocks, p.lanes) == (1, 1, 8)
    assert p.blocks == b * 16 * p.split
    assert p.stages == 1 and p.rows * P.NW * 32 // p.lanes >= pages * 16


@pytest.mark.parametrize("b", [1, 8])
def test_paged_plan_fills_about_one_wave(b):
    """At the serving shapes the grid gives every SM work, within two
    blocks a SM (128 threads and a few KB of shared memory each: one
    wave)."""
    p_max = 34 if b == 1 else 8
    p = P.plan(b, 16, 1, 64, 16, p_max, torch.bfloat16)
    assert 0.8 * SMS <= p.blocks <= 2 * SMS


@pytest.mark.parametrize("b", [1, 2, 8, 64, 256])
def test_paged_plan_split_follows_the_table_width_alone(b):
    """The split is the same at any batch: the grid grows with B, an
    idle slot's blocks exit at once."""
    p = P.plan(b, 16, 1, 64, 16, 36, torch.bfloat16)
    assert (p.split, p.pages, p.stages) == (8, 5, 1)
    assert p.blocks == b * 16 * 8


@pytest.mark.parametrize("p_max", [1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 33, 34,
                                   36, 64, 65, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_plan_never_splits_past_the_pages(p_max, dtype, ps):
    p = P.plan(1, 16, 1, 64, ps, p_max, dtype)
    assert 1 <= p.split <= min(P.MAX_SPLIT, p_max)
    assert (p.split - 1) * p.pages < p_max <= p.split * p.pages
    groups = P.NW * 32 // p.lanes
    k = -(-(p.pages * ps) // groups)            # rows a lane group holds
    assert p.rows == min(P.ROWS_MAX, k)
    assert p.stages == (1 if k <= p.rows else 2)


@pytest.mark.parametrize("dtype,heads,head_blocks,lanes", [
    (torch.bfloat16, 4, 2, 32), (torch.float32, 4, 2, 32),
    (torch.int8, 2, 4, 16)])
def test_paged_plan_takes_gemma_heads(dtype, heads, head_blocks, lanes):
    """G·hd = 2048 (gemma-2b: G 8, hd 256): the heads go to several
    blocks, each lane keeping at most ACC_MAX accumulators."""
    p = P.plan(2, 1, 8, 256, 16, 2, dtype)
    assert (p.heads, p.head_blocks, p.lanes) == (heads, head_blocks, lanes)
    assert p.heads * P.LANE_ELEMS[dtype] <= P.ACC_MAX


def test_paged_plan_refuses_rows_wider_than_a_warp():
    with pytest.raises(ValueError, match="hd=264"):
        P.plan(1, 1, 1, 264, 16, 2, torch.bfloat16)
    assert P.plan(1, 1, 1, 512, 16, 2, torch.int8).lanes == 32


def test_paged_plan_reads_no_lengths():
    """The plan runs before every decode step of the device-resident
    burst: it takes shapes only, so it never reads lengths back."""
    params = inspect.signature(P.plan).parameters
    assert "lengths" not in params and "p_max" in params


# ----------------------------------------------------------------------
# nm_select: one thread a (row, group)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("r", [1024, 2816, 1000])
@pytest.mark.parametrize("c", [128, 1024])
def test_nm_select_plan_covers_every_group(r, c):
    blocks = N.plan(r, c)
    pairs = r * c // 4
    assert blocks * N.THREADS >= pairs > (blocks - 1) * N.THREADS


def test_nm_select_plan_gives_the_mm_block_many_blocks():
    """One 128-column block of a 1024-row linear, as the MM loop hands it
    over: ≥ 128 blocks, not the 16 of a 32-group x 64-row tiling."""
    assert N.plan(1024, 128) >= 128
    assert N.plan(2816, 128) >= SMS
