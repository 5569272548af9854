// Solution-M 2:4 mask selection (the paper's Eq. 12) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/nm_select.py::nm_select.  For
// every (row, group of 4 columns) it scores the 6 pruning pairs (p, q)
// with the exact pair loss
//
//     L(p, q) = 1/2 * w_{p,q} A^-1 w_{p,q}^T,   A = Hinv[{p,q}, {p,q}],
//
// the 2 x 2 inverse in closed form, and marks the argmin pair pruned:
// out (R, C) bytes 0/1 (a torch.bool tensor), exactly 2 per group.
// w (R, C) is f32 or bf16 with row stride ldw; Hinv is read in place with
// row stride ldh — only its 4 x 4 diagonal blocks, one per group, so the
// caller hands in a block of the full inverse without a gather or a copy.
//
// What bounds it on this card: the bytes — w read once, the mask written
// once (about 5 bytes a weight in f32), against ~15 flops a weight.
//
// Design.  A block owns 32 groups x 64 rows.  Its first 32 x 16 threads
// stage the 10 distinct Hinv entries of each of its groups in shared
// memory; then thread (g, r) walks rows r, r + 8, ...  A warp reads 32
// consecutive groups of one row (coalesced) and writes their 128 mask
// bytes.  The arithmetic keeps the reference's operation order, each
// step rounded on its own (__fmul_rn and friends are never contracted
// into FMAs) and the division by det kept as a division, so the losses
// are those of the plain PyTorch version bit for bit; the argmin takes
// the first minimum over the pairs in NM_COMBOS_24 order (strict <).
// Ragged R and any number of groups are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BG = 32;   // groups per block (threadIdx.x)
constexpr int RS = 8;    // row lanes (threadIdx.y)
constexpr int BR = 64;   // rows per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 0.5 * (wp*wp*aqq - 2*wp*wq*apq + wq*wq*app) / (app*aqq - apq*apq),
// each product and sum rounded in the reference's order.
__device__ __forceinline__ float pair_loss(float wp, float wq, float app,
                                           float aqq, float apq) {
  const float det = __fsub_rn(__fmul_rn(app, aqq), __fmul_rn(apq, apq));
  const float t1 = __fmul_rn(__fmul_rn(wp, wp), aqq);
  const float t2 = __fmul_rn(__fmul_rn(__fmul_rn(2.f, wp), wq), apq);
  const float t3 = __fmul_rn(__fmul_rn(wq, wq), app);
  const float s = __fadd_rn(__fsub_rn(t1, t2), t3);
  return __fdiv_rn(__fmul_rn(0.5f, s), det);
}

template <typename T>
__global__ void __launch_bounds__(BG * RS)
    nm_select_kernel(const T* __restrict__ w, int ldw,
                     const float* __restrict__ hinv, int ldh,
                     uint8_t* __restrict__ out, int R, int G) {
  // a[g][0..3] = diagonal A_pp; a[g][4..9] = A_pq for the 6 pairs
  __shared__ float a[BG][10];
  const int gx = threadIdx.x, ry = threadIdx.y;
  const int g = blockIdx.x * BG + gx;
  if (ry == 0 && g < G) {
    const float* hb = hinv + (size_t)(4 * g) * ldh + 4 * g;
#pragma unroll
    for (int p = 0; p < 4; ++p) a[gx][p] = hb[(size_t)p * ldh + p];
    a[gx][4] = hb[0 * (size_t)ldh + 1];
    a[gx][5] = hb[0 * (size_t)ldh + 2];
    a[gx][6] = hb[0 * (size_t)ldh + 3];
    a[gx][7] = hb[1 * (size_t)ldh + 2];
    a[gx][8] = hb[1 * (size_t)ldh + 3];
    a[gx][9] = hb[2 * (size_t)ldh + 3];
  }
  __syncthreads();
  if (g >= G) return;
  const float d0 = a[gx][0], d1 = a[gx][1], d2 = a[gx][2], d3 = a[gx][3];
  const float o01 = a[gx][4], o02 = a[gx][5], o03 = a[gx][6];
  const float o12 = a[gx][7], o13 = a[gx][8], o23 = a[gx][9];
  // pruned positions of each pair, as a 4-bit set, in NM_COMBOS_24 order
  const unsigned combo_bits[6] = {0x3u, 0x5u, 0x9u, 0x6u, 0xAu, 0xCu};

  const int r_end = min(R, (blockIdx.y + 1) * BR);
  for (int r = blockIdx.y * BR + ry; r < r_end; r += RS) {
    const T* wr = w + (size_t)r * ldw + 4 * g;
    const float w0 = to_f(wr[0]), w1 = to_f(wr[1]);
    const float w2 = to_f(wr[2]), w3 = to_f(wr[3]);
    float loss[6];
    loss[0] = pair_loss(w0, w1, d0, d1, o01);
    loss[1] = pair_loss(w0, w2, d0, d2, o02);
    loss[2] = pair_loss(w0, w3, d0, d3, o03);
    loss[3] = pair_loss(w1, w2, d1, d2, o12);
    loss[4] = pair_loss(w1, w3, d1, d3, o13);
    loss[5] = pair_loss(w2, w3, d2, d3, o23);
    int best = 0;
#pragma unroll
    for (int c = 1; c < 6; ++c)
      if (loss[c] < loss[best]) best = c;
    const unsigned bits = combo_bits[best];
    uchar4 m;
    m.x = bits & 1u;
    m.y = (bits >> 1) & 1u;
    m.z = (bits >> 2) & 1u;
    m.w = (bits >> 3) & 1u;
    *reinterpret_cast<uchar4*>(out + (size_t)r * (4 * G) + 4 * g) = m;
  }
}

}  // namespace

extern "C" int nm_select_launch(const void* w, int w_bf16, int ldw,
                                const float* hinv, int ldh, uint8_t* out,
                                int R, int C, void* stream) {
  const int G = C / 4;
  const dim3 grid((G + BG - 1) / BG, (R + BR - 1) / BR);
  const dim3 block(BG, RS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    nm_select_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w), ldw, hinv, ldh, out, R, G);
  else
    nm_select_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(w), ldw, hinv, ldh, out, R, G);
  return static_cast<int>(cudaGetLastError());
}
