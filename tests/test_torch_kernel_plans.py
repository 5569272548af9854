"""The host-side plans of the port's two tensor-core routes, on CPU.

``hessian_accum.plan`` and ``nm_spmm.decode_plan`` are pure Python: which
route each (dtype, shape, alignment) takes, how the Hessian's token range
is split and how the decode product's K is split over a cluster.  The
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import pytest
import torch

from repro_torch.kernels import hessian_accum as H
from repro_torch.kernels import nm_spmm as S

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
