// Calibration Hessian accumulation for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hessian_accum.py::hessian_accum
// (H = 2 x x^T over token tiles).  Computes, in place,
//
//     H <- beta * H + alpha * 2 * X^T X
//
// with X the captured activations, token-major (T, m) f32 or bf16, and H
// an (m, m) f32 accumulator.  alpha = 1, beta = 0 is the TPU kernel's
// function (H is then written without being read); alpha = 1/n,
// beta = n_prev/n is the streaming mean of core/hessian.py's update in one
// launch, with no m x m temporary.
//
// What bounds it on this card: 2 m^2 T flops (m^2 T for the half that is
// computed) against (T m + m^2) bytes — at m = 1024, T = 16384 some 500
// flops a byte, far above the ridge, so it is bound by operations.  This
// first version runs the f32 FMA pipe (67 TFLOP/s), no TF32: the Cholesky
// and MRP solves downstream amplify Hessian error by the condition number.
//
// Design.  H is symmetric, so only the lower-triangle (i >= j) 64 x 64
// tiles are computed, one block each; an off-diagonal tile is written at
// (i, j) and mirrored at (j, i), each location scaled by beta against its
// own old value.  The X rows are read straight from the token-major
// capture (no transposed copy): a tile load reads BT token rows of 64
// consecutive features, so neighbouring threads read neighbouring
// addresses.  The block's 256 threads each own a 4 x 4 patch of the
// tile and loop over all T tokens (the TPU grid's sequential token axis
// becomes the loop); each BT-token chunk is summed into its own partial
// before it joins the running sum, so the f32 sum over 16k tokens rounds
// in two short levels instead of one long chain.  Ragged m and T are
// masked in the loads and stores: the caller never pads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;   // output tile edge
constexpr int BT = 32;     // tokens per shared-memory chunk
constexpr int NT = 256;    // threads per block (16 x 16, 4 x 4 outputs each)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// xs[r][c] = X[t0 + r, c0 + c] as f32, zero past the ragged edges.
template <typename T>
__device__ __forceinline__ void load_chunk(float (*xs)[TILE],
                                           const T* __restrict__ x, int t0,
                                           int c0, int n_tok, int m) {
  const int c = threadIdx.x % TILE;
  const int col = c0 + c;
#pragma unroll
  for (int r = threadIdx.x / TILE; r < BT; r += NT / TILE) {
    const int t = t0 + r;
    xs[r][c] = (t < n_tok && col < m) ? to_f(x[(size_t)t * m + col]) : 0.f;
  }
}

__device__ __forceinline__ void store(float* __restrict__ h, size_t at,
                                      float v, float beta) {
  h[at] = beta == 0.f ? v : fmaf(beta, h[at], v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    hessian_accum_kernel(const T* __restrict__ x, float* __restrict__ h,
                         int n_tok, int m, float alpha2, float beta) {
  // blockIdx.x enumerates the lower-triangle tiles row by row
  const int b = blockIdx.x;
  int bi = (int)((sqrtf(8.f * (float)b + 1.f) - 1.f) * 0.5f);
  while ((bi + 1) * (bi + 2) / 2 <= b) ++bi;
  while (bi * (bi + 1) / 2 > b) --bi;
  const int bj = b - bi * (bi + 1) / 2;
  const int i0 = bi * TILE, j0 = bj * TILE;

  __shared__ __align__(16) float xi[BT][TILE];
  __shared__ __align__(16) float xj[BT][TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int t0 = 0; t0 < n_tok; t0 += BT) {
    load_chunk(xi, x, t0, i0, n_tok, m);
    load_chunk(xj, x, t0, j0, n_tok, m);
    __syncthreads();
    float part[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[a][c] = 0.f;
#pragma unroll 8
    for (int t = 0; t < BT; ++t) {
      const float4 u = *reinterpret_cast<const float4*>(&xi[t][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&xj[t][tx * 4]);
      const float uv[4] = {u.x, u.y, u.z, u.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[a][c] = fmaf(uv[a], vv[c], part[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] += part[a][c];
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      if (i < m && j < m) {
        const float v = alpha2 * acc[a][c];
        store(h, (size_t)i * m + j, v, beta);
        if (bi != bj) store(h, (size_t)j * m + i, v, beta);
      }
    }
  }
}

}  // namespace

extern "C" int hessian_accum_launch(const void* x, int x_bf16, float* h,
                                    int n_tok, int m, float alpha,
                                    float beta, void* stream) {
  const int nb = (m + TILE - 1) / TILE;
  const dim3 grid(nb * (nb + 1) / 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float alpha2 = 2.f * alpha;
  if (x_bf16)
    hessian_accum_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), h, n_tok, m, alpha2, beta);
  else
    hessian_accum_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), h, n_tok, m, alpha2, beta);
  return static_cast<int>(cudaGetLastError());
}
