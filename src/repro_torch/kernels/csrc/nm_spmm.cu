// Packed 2:4 weight x activation product for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/nm_spmm.py::nm_spmm (tiled,
// large M) and ::nm_spmm_decode (skinny M with a fused bias + activation
// epilogue).  Computes y = act(x @ decompress_24(vals, idx) + bias) with
// x (M, K) f32 or bf16, vals (K/2, N) of x's dtype, idx (K/2, N) int8
// in-group positions 0..3, bias (N,) f32 / bf16 or none, y (M, N) f32.
//
// What bounds it on this card: at decode M (a handful of rows) the
// product is a weight stream, bound by device-memory bytes: vals (2 B a
// pair in bf16) + idx (1 B a pair), each read once.  At prefill M it is
// still far below the ~295 flop/byte ridge of the bf16 tensor cores, and
// this first version runs the f32 FMA pipe (no TF32: the f32 packed path
// must stay f32 math, as the reference's dense-equivalence requires).
//
// Design.  Each block owns an (BM, BN) output tile and loops over the
// whole K inside the block — blocks carry nothing between them, unlike
// the TPU grid's sequential k axis.  Per K tile it loads the packed
// vals/idx tile, decompresses it into shared memory as a dense (BK, BN)
// f32 tile by SUMMING each slot into its position (a padding slot points
// at position 0 with value 0 and must not overwrite a kept value there),
// stages the x tile as f32 beside it, and accumulates in f32 registers.
// The next tile's global loads are issued into registers before the
// current tile's FMAs, so their latency overlaps the compute.  The
// epilogue (bias, then none / silu / gelu-tanh) runs on the f32
// accumulator before the single store.
//
// Decode shapes use narrow tiles (BN = 8) so that N alone spreads the
// work over the 132 SMs (N = 1024 gives 128 blocks, N = 2816 gives 352);
// the block's threads then split each K tile into KS slices and combine
// the slices through shared memory in a fixed order, so results are
// deterministic.  Ragged M, N and K edges are masked in the kernel: the
// caller never pads the weights.  K must divide by 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float epilogue(float y, float b, int act) {
  y += b;
  if (act == 1) return y / (1.f + expf(-y));  // silu
  if (act == 2) {                              // gelu, tanh approximation
    const float c = 0.7978845608028654f;       // sqrt(2 / pi)
    return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * y * y * y)));
  }
  return y;
}

// BM x BN output tile, BK dense K rows per shared-memory tile, RPT output
// rows per thread; KS = threads sharing one output element (K slices).
template <typename T, int BM, int BN, int BK, int RPT>
__global__ void __launch_bounds__(NT)
    nm_spmm_kernel(const T* __restrict__ x, const T* __restrict__ vals,
                   const int8_t* __restrict__ idx,
                   const void* __restrict__ bias, int bias_bf16,
                   float* __restrict__ out, int M, int K, int N, int act) {
  constexpr int RG = BM / RPT;            // row groups
  constexpr int KS = NT / (BN * RG);      // K slices per tile
  constexpr int KPS = BK / KS;            // K rows per slice
  constexpr int GRP = BK / 4;             // 2:4 groups per tile
  constexpr int XPT = BM * BK / NT;       // x elements loaded per thread
  constexpr int WPT = GRP * BN / NT;      // (group, column) items per thread
  static_assert(BM % RPT == 0 && NT % (BN * RG) == 0, "thread layout");
  static_assert(BK % KS == 0 && (BM * BK) % NT == 0, "tile layout");
  static_assert((GRP * BN) % NT == 0, "decompress layout");
  static_assert(KS * BM * BN <= BM * (BK + 1), "slice sums fit in xs");

  __shared__ float xs[BM][BK + 1];        // +1: conflict-free row reads
  __shared__ float ws[BK][BN];            // dense decompressed weights

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int n_groups = K / 4;
  const int n_tiles = (K + BK - 1) / BK;

  float xr[XPT];
  float vr[WPT][2];
  int ir[WPT][2];

  auto load = [&](int t) {
    const int k0 = t * BK;
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int e = tid + NT * j;
      const int m = m0 + e / BK;
      const int k = k0 + e % BK;
      xr[j] = (m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int e = tid + NT * j;
      const int gk = k0 / 4 + e / BN;     // global 2:4 group
      const int n = n0 + e % BN;
      const bool ok = gk < n_groups && n < N;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const size_t src = (size_t)(2 * gk + s) * N + n;
        vr[j][s] = ok ? to_f(vals[src]) : 0.f;
        ir[j][s] = ok ? (int)idx[src] : -1;   // -1 matches no position
      }
    }
  };

  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < XPT; ++j) {
      const int e = tid + NT * j;
      xs[e / BK][e % BK] = xr[j];
    }
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int e = tid + NT * j;
      const int g = e / BN;
      const int c = e % BN;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ws[4 * g + r][c] = (ir[j][0] == r ? vr[j][0] : 0.f) +
                           (ir[j][1] == r ? vr[j][1] : 0.f);
      }
    }
  };

  const int c = tid % BN;                 // output column in the tile
  const int rg = (tid / BN) % RG;         // rows rg*RPT .. rg*RPT+RPT-1
  const int ks = tid / (BN * RG);         // K slice
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  if (n_tiles > 0) load(0);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();                      // previous tile's reads are done
    stage();
    __syncthreads();
    if (t + 1 < n_tiles) load(t + 1);     // in flight during the FMAs
#pragma unroll 8
    for (int kk = ks * KPS; kk < (ks + 1) * KPS; ++kk) {
      const float w = ws[kk][c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(xs[rg * RPT + i][kk], w, acc[i]);
    }
  }

  if (KS > 1) {        // combine K slices in a fixed order, through xs
    float* red = &xs[0][0];
    __syncthreads();                      // every slice is done with xs
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      red[(ks * BM + rg * RPT + i) * BN + c] = acc[i];
    __syncthreads();
    if (ks != 0) return;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < KS; ++q) s += red[(q * BM + rg * RPT + i) * BN + c];
      acc[i] = s;
    }
  }
  const int n = n0 + c;
  if (n >= N) return;
  const float b =
      bias == nullptr ? 0.f
      : bias_bf16     ? to_f(static_cast<const __nv_bfloat16*>(bias)[n])
                      : static_cast<const float*>(bias)[n];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + rg * RPT + i;
    if (m < M) out[(size_t)m * N + n] = epilogue(acc[i], b, act);
  }
}

template <typename T, int BM, int BN, int BK, int RPT>
void launch(const void* x, const void* vals, const void* idx,
            const void* bias, int bias_bf16, void* out, int M, int K, int N,
            int act, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  nm_spmm_kernel<T, BM, BN, BK, RPT><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(vals),
      static_cast<const int8_t*>(idx), bias, bias_bf16,
      static_cast<float*>(out), M, K, N, act);
}

template <typename T>
void decode(const void* x, const void* vals, const void* idx,
            const void* bias, int bias_bf16, void* out, int M, int K, int N,
            int act, cudaStream_t s) {
  if (M <= 8)
    launch<T, 8, 8, 256, 1>(x, vals, idx, bias, bias_bf16, out, M, K, N, act, s);
  else if (M <= 32)
    launch<T, 32, 8, 256, 4>(x, vals, idx, bias, bias_bf16, out, M, K, N, act, s);
  else
    launch<T, 64, 8, 128, 8>(x, vals, idx, bias, bias_bf16, out, M, K, N, act, s);
}

}  // namespace

extern "C" {

// Tiled product for large M (the reference's nm_spmm): no epilogue.
int nm_spmm_launch(const void* x, const void* vals, const void* idx,
                   void* out, int M, int K, int N, int is_bf16,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16, 64, 64, 64, 16>(x, vals, idx, nullptr, 0, out, M,
                                          K, N, 0, s);
  else
    launch<float, 64, 64, 64, 16>(x, vals, idx, nullptr, 0, out, M, K, N, 0,
                                  s);
  return (int)cudaGetLastError();
}

// Skinny-M product (M <= 128, the reference's nm_spmm_decode) with the
// fused epilogue: bias may be null (f32, or bf16 when bias_bf16); act 0
// none, 1 silu, 2 gelu-tanh.
int nm_spmm_decode_launch(const void* x, const void* vals, const void* idx,
                          const void* bias, int bias_bf16, void* out, int M,
                          int K, int N, int act, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    decode<__nv_bfloat16>(x, vals, idx, bias, bias_bf16, out, M, K, N, act, s);
  else
    decode<float>(x, vals, idx, bias, bias_bf16, out, M, K, N, act, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
