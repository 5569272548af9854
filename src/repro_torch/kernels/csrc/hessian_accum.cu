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
// What bounds it on this card: m (m + 1) T operations for the symmetric
// half against 2 T m + 4 m^2 bytes.  At the main path's shapes (m = 1024 /
// 2816, T = 16384 or the pipelined engine's stacked 262144) that is 500 to
// 1400 operations a byte, far above the bf16 ridge (295): bound by
// operations.
//
// Two routes, chosen on the host by hessian_accum.py::plan (and named by
// hessian_accum.last_kernel):
//
// * "tensor cores" — bf16 captures whose rows start on 16 bytes (m % 8 == 0
//   and an aligned pointer).  A bf16 x bf16 product is exact in f32, so
//   mma.sync m16n8k16 (bf16 in, f32 out) computes the plain version's
//   function (an f32 product of the upcast captures).  Each block owns one
//   lower-triangle 128 x 128 tile of H and reads the token-major capture
//   as it lies, with no transposed copy: the tile is X_i^T X_j with the
//   tokens as the reduction dimension, so both operands are MN-major and
//   ldmatrix.trans hands out their fragments.  A 4-stage ring of 32-token
//   chunks (16 KB a stage: two TMA boxes of 32 tokens x 64 features for
//   each operand, 128-byte swizzle, zero-filled past T and m) is kept full
//   by one thread: a "full" mbarrier a stage reports the TMA bytes, an
//   "empty" one collects the 8 warps' release before the stage is
//   refilled, so chunk k + 1..k + 3 load while chunk k's products run.  A
//   diagonal tile loads one operand and uses it twice.  8 warps (2 x 4)
//   each own 64 x 32 of the tile.  Every mma starts from a zero
//   accumulator and its 16-token sum joins the running f32 sum through a
//   rounded add: the tensor cores truncate when they accumulate, and a
//   chain of thousands of mma steps over positive diagonal terms would
//   drift one way; this way the bias stays at one truncation of a 16-term
//   sum.  256 threads, 66 KB: two blocks an SM.
// * "f32 FMA" — f32 captures (f32 math, no TF32: the Cholesky and MRP
//   solves downstream amplify Hessian error by the condition number) and
//   bf16 captures whose rows are not 16-byte aligned.  64 x 64 tiles, 256
//   threads with a 4 x 4 patch each, the tile's tokens staged as f32 in
//   shared memory 32 at a time; each 32-token chunk is summed into its own
//   partial before it joins the running sum.
//
// Split of the token range.  Only the lower-triangle tiles are computed,
// too few to fill 132 SMs at m = 1024 (36 tiles of 128).  The host splits
// the T tokens into S ranges of whole 32-token chunks (plan: the smallest
// S whose grid of tiles x S blocks fills its waves to 90 %, each range at
// least 4 chunks): 7 at m = 1024 (252 blocks, one wave of two an SM), 1 at
// m = 2816 (253 tiles).  Each block writes its f32 partial tile into a
// scratch of S x tiles tiles that the wrapper allocates; a second kernel
// sums the S partials of each element in the fixed order 0..S-1, scales by
// 2 alpha, adds beta * H_old where beta != 0 (H is not read when
// beta == 0) and writes the tile at (i, j) and its mirror at (j, i) from
// the same f32 value (through a shared-memory transpose), so H is exactly
// symmetric; on a diagonal tile only i >= j is computed and mirrored.  No
// atomics: the same inputs give the same bits.  Ragged m and T are masked
// in the loads (zero-filled) and the stores: the caller never pads.
//
// The weighted form (a MoE expert's Hessian over its routed tokens):
//
//     H <- H c / max(c + sum w, 1e-12) + 2 X^T diag(w) X / max(c + sum w, 1e-12)
//     c <- c + sum w
//
// with the count c a device scalar, so that no calibration batch reads
// anything back to the host.  A first one-block pass sums w in a fixed
// order, writes 2 / denom and c / denom into two floats behind the
// partials and the new count over the old; the finishing pass reads its
// alpha and beta from there.  Bool weights (routing validity, one byte a
// token) keep the tensor-core route: each lane ANDs the bf16 pairs of its
// B fragments with a per-token 0 / 0xFFFF mask (a fragment register holds
// tokens 2 t4 + {0, 1} of its 8-token half), which zeroes the dropped
// tokens' rows of one operand exactly.  Float weights (gate
// probabilities) take the FMA route, which scales the row operand by w_t
// in f32 as it stages it — the reference's x32 * w32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BT = 32;    // tokens per chunk (both routes)
constexpr int NT = 256;   // threads per block (both routes)
constexpr int MAX_DEV = 64;

// blockIdx.x enumerates the lower-triangle tiles row by row
__device__ __forceinline__ void tile_of(int b, int* bi, int* bj) {
  int i = (int)((sqrtf(8.f * (float)b + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= b) ++i;
  while (i * (i + 1) / 2 > b) --i;
  *bi = i;
  *bj = b - i * (i + 1) / 2;
}

// this block's chunks of the token range: [*c0, *c0 + *n)
__device__ __forceinline__ void chunks_of(int n_tok, int* c0, int* n) {
  const int chunks = (n_tok + BT - 1) / BT;
  const int s = blockIdx.y, split = gridDim.y;
  *c0 = (int)((long long)s * chunks / split);
  *n = (int)((long long)(s + 1) * chunks / split) - *c0;
}

// --------------------------------------------------------------------
// f32 FMA route
// --------------------------------------------------------------------
namespace fma_route {

constexpr int TILE = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the weight of token t: 0/1 for bool (w_kind 1), the f32 value for
// float (w_kind 2)
__device__ __forceinline__ float weight(const void* w, int w_kind, int t) {
  if (w_kind == 1) return static_cast<const uint8_t*>(w)[t] ? 1.f : 0.f;
  return static_cast<const float*>(w)[t];
}

// xs[r][c] = X[t0 + r, c0 + c] as f32 (times w[t0 + r] when W_KIND is 1
// or 2), zero past the ragged edges.
template <int W_KIND, typename T>
__device__ __forceinline__ void load_chunk(float (*xs)[TILE],
                                           const T* __restrict__ x, int t0,
                                           int t_end, int c0, int m,
                                           const void* w) {
  const int c = threadIdx.x % TILE;
  const int col = c0 + c;
#pragma unroll
  for (int r = threadIdx.x / TILE; r < BT; r += NT / TILE) {
    const int t = t0 + r;
    float v = (t < t_end && col < m) ? to_f(x[(size_t)t * m + col]) : 0.f;
    if (W_KIND != 0 && t < t_end) v *= weight(w, W_KIND, t);
    xs[r][c] = v;
  }
}

// partial tile (TILE x TILE f32) of tokens in this block's range; the row
// operand scaled by the token weights when W_KIND is 1 (bool) or 2 (f32)
template <typename T, int W_KIND>
__global__ void __launch_bounds__(NT, 2)
    hessian_fma_kernel(const T* __restrict__ x, float* __restrict__ part,
                       int n_tok, int m, const void* w) {
  int bi, bj, c0, n_ch;
  tile_of(blockIdx.x, &bi, &bj);
  chunks_of(n_tok, &c0, &n_ch);
  const int i0 = bi * TILE, j0 = bj * TILE;
  const int t_end = min(n_tok, (c0 + n_ch) * BT);

  __shared__ __align__(16) float xi[BT][TILE];
  __shared__ __align__(16) float xj[BT][TILE];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int t0 = c0 * BT; t0 < t_end; t0 += BT) {
    load_chunk<W_KIND>(xi, x, t0, t_end, i0, m, w);
    load_chunk<0>(xj, x, t0, t_end, j0, m, nullptr);
    __syncthreads();
    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[a][c] = 0.f;
#pragma unroll 8
    for (int t = 0; t < BT; ++t) {
      const float4 u = *reinterpret_cast<const float4*>(&xi[t][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&xj[t][tx * 4]);
      const float uv[4] = {u.x, u.y, u.z, u.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) p[a][c] = fmaf(uv[a], vv[c], p[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] += p[a][c];
    __syncthreads();
  }

  float* out = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                          (TILE * TILE);
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(&out[(ty * 4 + a) * TILE + tx * 4]) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
}

}  // namespace fma_route

// --------------------------------------------------------------------
// tensor-core route (bf16)
// --------------------------------------------------------------------
namespace tc {

// 0xFFFF in the half of a bf16 pair whose token (t, t + 1) has weight
__device__ __forceinline__ uint32_t token_mask(const uint8_t* w, int t,
                                               int n_tok) {
  const uint32_t lo = (t < n_tok && w[t]) ? 0x0000FFFFu : 0u;
  const uint32_t hi = (t + 1 < n_tok && w[t + 1]) ? 0xFFFF0000u : 0u;
  return lo | hi;
}

constexpr int TILE = 128;                    // output tile edge
constexpr int STAGES = 4;                    // ring depth
constexpr int NW = NT / 32;                  // 8 warps: 2 (rows) x 4 (cols)
constexpr int BOX = BT * 128;                // 32 tokens x 64 features
constexpr int OPER = 2 * BOX;                // 32 tokens x 128 features
constexpr int STAGE_BYTES = 2 * OPER;        // operands i and j
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int SMEM = 1024 + BAR_OFF + 2 * 8 * STAGES;
static_assert(BOX % 1024 == 0, "swizzle atoms");

// WEIGHTED: w holds one byte a token (bool weights)
template <bool WEIGHTED>
__global__ void __launch_bounds__(NT, 2)
    hessian_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                      float* __restrict__ part, int n_tok,
                      const uint8_t* __restrict__ w) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw + 1023) & ~1023u;      // swizzle atoms
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int bi, bj, c0, n_ch;
  tile_of(blockIdx.x, &bi, &bj);
  chunks_of(n_tok, &c0, &n_ch);
  const int i0 = bi * TILE, j0 = bj * TILE;
  const bool diag = bi == bj;
  const uint32_t full = sbase + BAR_OFF, empty = full + 8 * STAGES;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, NW);
    }
    bar_init_fence();
  }
  __syncthreads();

  // chunk c of the range -> ring slot (thread 0 only)
  auto issue = [&](int c, int slot) {
    const uint32_t bar = full + 8 * slot, dst = sbase + slot * STAGE_BYTES;
    const int row = (c0 + c) * BT;
    bar_expect(bar, diag ? OPER : STAGE_BYTES);
    tma2d(dst, &map_x, i0, row, bar);
    tma2d(dst + BOX, &map_x, i0 + 64, row, bar);
    if (!diag) {
      tma2d(dst + OPER, &map_x, j0, row, bar);
      tma2d(dst + OPER + BOX, &map_x, j0 + 64, row, bar);
    }
  };
  if (tid == 0)
    for (int c = 0; c < STAGES && c < n_ch; ++c) issue(c, c);

  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  // ldmatrix.trans lane -> (token, feature offset) of its 8x8 matrix:
  // A (features x tokens) takes matrices (f0-7, t0-7), (f8-15, t0-7),
  // (f0-7, t8-15), (f8-15, t8-15); B (tokens x features) takes (t0-7,
  // f0-7), (t8-15, f0-7), (t0-7, f8-15), (t8-15, f8-15)
  const int a_t = (lane & 7) + ((lane >> 4) << 3), a_f = ((lane >> 3) & 1) * 8;
  const int b_t = lane & 15, b_f = (lane >> 4) * 8;
  // byte offset of (token t, feature f) within one operand's two boxes
  auto at = [](int t, int f) { return (f >> 6) * BOX + swz(t, (f & 63) >> 3); };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c = 0; c < n_ch; ++c) {
    const int slot = c % STAGES;
    bar_wait(full + 8 * slot, (c / STAGES) & 1);
    const uint32_t xa = sbase + slot * STAGE_BYTES;
    const uint32_t xb = diag ? xa : xa + OPER;
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4_t(a[mi], xa + at(kk * 16 + a_t, wm + mi * 16 + a_f));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, xb + at(kk * 16 + b_t, wn + np * 16 + b_f));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
      if (WEIGHTED) {          // bool weights: drop the 0-weight tokens
        const int t = (c0 + c) * BT + kk * 16 + 2 * (lane & 3);
        const uint32_t lo = token_mask(w, t, n_tok);
        const uint32_t hi = token_mask(w, t + 8, n_tok);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          b[ni][0] &= lo;
          b[ni][1] &= hi;
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float d[4];
          mma16816_0(d, a[mi], b[ni]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += d[e];
        }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + 8 * slot);   // this warp is done
    if (tid == 0 && c + STAGES < n_ch) {
      bar_wait(empty + 8 * slot, (c / STAGES) & 1);  // ... and every warp
      issue(c + STAGES, slot);
    }
    __syncwarp();
  }

  float* out = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                          (TILE * TILE);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm + mi * 16 + g, c = wn + ni * 8 + 2 * t4;
      *reinterpret_cast<float2*>(&out[r * TILE + c]) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(&out[(r + 8) * TILE + c]) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

}  // namespace tc

// --------------------------------------------------------------------
// second pass: sum the S partials in order, scale, mirror
// --------------------------------------------------------------------
__device__ __forceinline__ void store(float* __restrict__ h, size_t at,
                                      float v, float beta) {
  h[at] = beta == 0.f ? v : fmaf(beta, h[at], v);
}

// grid (tiles, (TS / 32)^2): one 32 x 32 sub-block of a tile per block
template <int TS>
__global__ void __launch_bounds__(NT)
    hessian_finish_kernel(const float* __restrict__ part, int split,
                          float* __restrict__ h, int m, float alpha2,
                          float beta, const float* __restrict__ coef) {
  constexpr int SUBS = TS / 32;
  if (coef != nullptr) {     // the weighted form: formed on the device
    alpha2 = coef[0];
    beta = coef[1];
  }
  const int tile = blockIdx.x, tiles = gridDim.x;
  int bi, bj;
  tile_of(tile, &bi, &bj);
  const int sr = blockIdx.y / SUBS, sc = blockIdx.y % SUBS;
  if (bi == bj && sr < sc) return;          // above a diagonal tile's diagonal
  __shared__ float tr[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int i0 = bi * TS + sr * 32, j0 = bj * TS + sc * 32;
  const size_t stride = (size_t)tiles * TS * TS;
  for (int r = ty; r < 32; r += NT / 32) {
    const size_t off =
        (size_t)tile * TS * TS + (size_t)(sr * 32 + r) * TS + sc * 32 + tx;
    float v = part[off];
    for (int q = 1; q < split; ++q) v += part[q * stride + off];
    v *= alpha2;
    tr[r][tx] = v;
    const int i = i0 + r, j = j0 + tx;
    if ((bi != bj || i >= j) && i < m && j < m)
      store(h, (size_t)i * m + j, v, beta);
  }
  __syncthreads();
  for (int r = ty; r < 32; r += NT / 32) {   // (j, i) = (j0 + r, i0 + tx)
    const int i = i0 + tx, j = j0 + r;
    if ((bi != bj || i > j) && i < m && j < m)
      store(h, (size_t)j * m + i, tr[tx][r], beta);
  }
}

// one block: s = sum w in a fixed order; denom = max(c + s, 1e-12);
// coef = (2 / denom, c / denom); c += s
__global__ void __launch_bounds__(NT)
    hessian_weights_kernel(const void* __restrict__ w, int w_kind, int n_tok,
                           float* __restrict__ count,
                           float* __restrict__ coef) {
  __shared__ float red[NT / 32];
  float s = 0.f;
  for (int t = threadIdx.x; t < n_tok; t += NT)
    s += fma_route::weight(w, w_kind, t);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < NT / 32; ++i) tot += red[i];
    const float c = *count, total = c + tot;
    const float denom = fmaxf(total, 1e-12f);
    coef[0] = 2.f / denom;
    coef[1] = c / denom;
    *count = total;
  }
}

// the FMA kernel's instance for the weights' kind
template <typename T>
void launch_fma(dim3 grid, cudaStream_t s, const T* x, float* scratch,
                int n_tok, int m, const void* w, int w_kind) {
  if (w_kind == 1)
    fma_route::hessian_fma_kernel<T, 1><<<grid, NT, 0, s>>>(x, scratch, n_tok,
                                                           m, w);
  else if (w_kind == 2)
    fma_route::hessian_fma_kernel<T, 2><<<grid, NT, 0, s>>>(x, scratch, n_tok,
                                                           m, w);
  else
    fma_route::hessian_fma_kernel<T, 0><<<grid, NT, 0, s>>>(x, scratch, n_tok,
                                                           m, nullptr);
}

int launch(const void* x, int x_bf16, int tc, int split, float* scratch,
           float* h, int n_tok, int m, float alpha, float beta,
           const void* w, int w_kind, const float* coef, cudaStream_t s) {
  const int ts = tc ? tc::TILE : fma_route::TILE;
  const int nb = (m + ts - 1) / ts;
  const dim3 grid(nb * (nb + 1) / 2, split);
  if (tc) {
    if (!x_bf16 || n_tok <= 0 || w_kind == 2)
      return (int)cudaErrorInvalidValue;
    static int smem_set[2][MAX_DEV] = {};
    cudaError_t err =
        w_kind ? allow_smem(tc::hessian_tc_kernel<true>, tc::SMEM,
                            smem_set[1], MAX_DEV)
               : allow_smem(tc::hessian_tc_kernel<false>, tc::SMEM,
                            smem_set[0], MAX_DEV);
    if (err != cudaSuccess) return (int)err;
    CUtensorMap map;
    memset(&map, 0, sizeof(map));
    if (!encode(&map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n_tok, m, BT,
                64, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    const uint8_t* wb = static_cast<const uint8_t*>(w);
    if (w_kind)
      tc::hessian_tc_kernel<true><<<grid, NT, tc::SMEM, s>>>(map, scratch,
                                                            n_tok, wb);
    else
      tc::hessian_tc_kernel<false><<<grid, NT, tc::SMEM, s>>>(map, scratch,
                                                             n_tok, nullptr);
  } else if (x_bf16) {
    launch_fma<__nv_bfloat16>(grid, s,
                              static_cast<const __nv_bfloat16*>(x), scratch,
                              n_tok, m, w, w_kind);
  } else {
    launch_fma<float>(grid, s, static_cast<const float*>(x), scratch, n_tok,
                      m, w, w_kind);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 fgrid(grid.x, (ts / 32) * (ts / 32));
  if (tc)
    hessian_finish_kernel<tc::TILE><<<fgrid, NT, 0, s>>>(
        scratch, split, h, m, 2.f * alpha, beta, coef);
  else
    hessian_finish_kernel<fma_route::TILE><<<fgrid, NT, 0, s>>>(
        scratch, split, h, m, 2.f * alpha, beta, coef);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n_tok, m) bf16 (x_bf16) or f32; tc selects the tensor-core route (bf16
// rows on 16 bytes); scratch holds split x tiles partial tiles of the
// route's tile edge (128 tensor cores, 64 FMA).
extern "C" int hessian_accum_launch(const void* x, int x_bf16, int tc,
                                    int split, float* scratch, float* h,
                                    int n_tok, int m, float alpha,
                                    float beta, void* stream) {
  return launch(x, x_bf16, tc, split, scratch, h, n_tok, m, alpha, beta,
                nullptr, 0, nullptr, static_cast<cudaStream_t>(stream));
}

// The weighted form: w (n_tok) one byte a token (w_kind 1, bool) or f32
// (w_kind 2, the FMA route only); count a device float; scratch holds the
// partials and two floats behind them for the coefficients.
extern "C" int hessian_accum_weighted_launch(const void* x, int x_bf16,
                                             int tc, int split,
                                             float* scratch, float* h,
                                             int n_tok, int m, const void* w,
                                             int w_kind, float* count,
                                             void* stream) {
  if (w_kind != 1 && w_kind != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ts = tc ? tc::TILE : fma_route::TILE;
  const int nb = (m + ts - 1) / ts;
  float* coef = scratch + (size_t)split * (nb * (nb + 1) / 2) * ts * ts;
  hessian_weights_kernel<<<1, NT, 0, s>>>(w, w_kind, n_tok, count, coef);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch(x, x_bf16, tc, split, scratch, h, n_tok, m, 1.f, 0.f, w,
                w_kind, coef, s);
}
