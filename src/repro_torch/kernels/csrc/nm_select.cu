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
// What bounds it on this card: at the MM loop's size (one 128-column
// block of w a launch, R = 1024 or 2816 rows) latency, not the bytes —
// w read once and the mask written once is a fraction of a microsecond.
//
// Design.  One thread per (row, group): thread i of the grid owns group
// i % G of row i / G, so a warp reads consecutive groups of a row.  It
// issues its loads at once, before any other work and with no barrier:
// the group's 4 weights as one 8-byte (bf16) or 16-byte (f32) load, and
// the upper triangle of its 4 x 4 Hinv block as four 16-byte read-only
// loads of the block's rows — shared by every row of w, so they come from
// L1/L2.  Views off those boundaries take the scalar route (the same
// kernel with element loads).  The arithmetic keeps the reference's
// operation order, each step rounded on its own (__fmul_rn and friends are
// never contracted into FMAs) and the division by det kept as __fdiv_rn,
// so the losses are those of the plain PyTorch version bit for bit; the
// argmin takes the first minimum over the pairs in NM_COMBOS_24 order
// (strict <).  The group's mask goes out as one 4-byte word.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // threads a block (nm_select.py::THREADS)

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

__device__ __forceinline__ void load_w(const float* p, bool vec, float* w) {
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __ldg(p + k);
  }
}
__device__ __forceinline__ void load_w(const __nv_bfloat16* p, bool vec,
                                       float* w) {
  if (vec) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    // a bf16 is the top half of its f32
    w[0] = __uint_as_float(v.x << 16), w[1] = __uint_as_float(v.x & 0xffff0000u);
    w[2] = __uint_as_float(v.y << 16), w[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __bfloat162float(p[k]);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
    nm_select_kernel(const T* __restrict__ w, int ldw,
                     const float* __restrict__ hinv, int ldh,
                     uint32_t* __restrict__ out, int R, int G) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * G) return;
  const int r = (int)(i / G), g = (int)(i % G);
  float x[4];
  load_w(w + (size_t)r * ldw + 4 * g, VEC, x);
  // Hinv's 4 x 4 block of the group: the diagonal d and the upper
  // triangle o (the pairs' A_pq)
  const float* hb = hinv + (size_t)(4 * g) * ldh + 4 * g;
  float d0, d1, d2, d3, o01, o02, o03, o12, o13, o23;
  if (VEC) {
    const float4 h0 = __ldg(reinterpret_cast<const float4*>(hb));
    const float4 h1 = __ldg(reinterpret_cast<const float4*>(hb + ldh));
    const float4 h2 = __ldg(reinterpret_cast<const float4*>(hb + 2 * (size_t)ldh));
    const float4 h3 = __ldg(reinterpret_cast<const float4*>(hb + 3 * (size_t)ldh));
    d0 = h0.x, o01 = h0.y, o02 = h0.z, o03 = h0.w;
    d1 = h1.y, o12 = h1.z, o13 = h1.w;
    d2 = h2.z, o23 = h2.w;
    d3 = h3.w;
  } else {
    d0 = __ldg(hb), o01 = __ldg(hb + 1), o02 = __ldg(hb + 2);
    o03 = __ldg(hb + 3);
    d1 = __ldg(hb + ldh + 1), o12 = __ldg(hb + ldh + 2);
    o13 = __ldg(hb + ldh + 3);
    d2 = __ldg(hb + 2 * (size_t)ldh + 2), o23 = __ldg(hb + 2 * (size_t)ldh + 3);
    d3 = __ldg(hb + 3 * (size_t)ldh + 3);
  }
  float loss[6];
  loss[0] = pair_loss(x[0], x[1], d0, d1, o01);
  loss[1] = pair_loss(x[0], x[2], d0, d2, o02);
  loss[2] = pair_loss(x[0], x[3], d0, d3, o03);
  loss[3] = pair_loss(x[1], x[2], d1, d2, o12);
  loss[4] = pair_loss(x[1], x[3], d1, d3, o13);
  loss[5] = pair_loss(x[2], x[3], d2, d3, o23);
  // the pruned positions of each pair as bytes of a word, NM_COMBOS_24
  // order: (0,1) (0,2) (0,3) (1,2) (1,3) (2,3)
  const uint32_t words[6] = {0x00000101u, 0x00010001u, 0x01000001u,
                             0x00010100u, 0x01000100u, 0x01010000u};
  float low = loss[0];
  uint32_t word = words[0];
#pragma unroll
  for (int c = 1; c < 6; ++c)
    if (loss[c] < low) low = loss[c], word = words[c];
  out[i] = word;
}

template <typename T>
void launch(const void* w, int ldw, const float* hinv, int ldh, void* out,
            int R, int G, int blocks, int vec, cudaStream_t s) {
  const dim3 grid(blocks);
  const T* wp = static_cast<const T*>(w);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (vec)
    nm_select_kernel<T, true><<<grid, NT, 0, s>>>(wp, ldw, hinv, ldh, o,
                                                       R, G);
  else
    nm_select_kernel<T, false><<<grid, NT, 0, s>>>(wp, ldw, hinv, ldh,
                                                        o, R, G);
}

}  // namespace

// blocks: the grid (nm_select.py::plan), NT threads each covering one
// (row, group); vec: w's groups on 8 (bf16) or 16 (f32) bytes and Hinv's
// block rows on 16 — else the scalar route.
extern "C" int nm_select_launch(const void* w, int w_bf16, int ldw,
                                const float* hinv, int ldh, void* out,
                                int R, int C, int blocks, int vec,
                                void* stream) {
  const int G = C / 4;
  if (blocks < 1 || (long long)blocks * NT < (long long)R * G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    launch<__nv_bfloat16>(w, ldw, hinv, ldh, out, R, G, blocks, vec, s);
  else
    launch<float>(w, ldw, hinv, ldh, out, R, G, blocks, vec, s);
  return static_cast<int>(cudaGetLastError());
}
