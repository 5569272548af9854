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
// pair in bf16) + idx (1 B a pair), each read once.  At the prefill
// chunk's M = 256 it is still bound by bytes (at attn.wq 0.94 us of
// bytes against 0.27 us of sparse bf16 operations), and so small that a
// launch lives on latency: what matters is that every SM streams its
// share of the packed weights with the copies in flight.
//
// Three kernels:
//
// * nm_spmm_tc_kernel — the tiled product in bf16 (M > 128 rows) on the
//   tensor cores.  A bf16 x bf16 product is exact in f32, so mma.sync
//   m16n8k16 (bf16 in, f32 accumulate) computes the reference's function
//   (it casts both to f32 and takes an f32 dot).  A block of 4 warps owns
//   a 64 x 64 output tile (each warp 32 x 32) and walks its K range in
//   64-deep tiles through a 3-stage shared-memory ring: one thread asks
//   the Tensor Memory Accelerator for the x tile, the packed vals tile and
//   the idx tile of a stage (2-D tensor maps; the hardware zero-fills the
//   ragged M, N and K edges) and an mbarrier reports their arrival, two
//   tiles ahead of the products.  Where some operand's rows do not start
//   on 16 bytes (K % 8, N % 8, or N % 16 for idx) the tiles come by
//   cp.async instead, 16 bytes a copy where the operand allows it, into
//   the same layout.  x and vals sit in
//   the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)), so
//   ldmatrix and the decompressing threads read them without bank
//   conflicts.  Each packed tile is decompressed in shared memory into a
//   dense bf16 (64, 64) tile by SUMMING each slot into its position (a
//   padding slot points at position 0 with value 0 and may share it with
//   a kept value; summing 0 is exact), double-buffered so that tile k+1
//   is decompressed while tile k's products run — one __syncthreads a
//   K tile.  Fragments come from ldmatrix (.trans for the dense tile,
//   whose rows are padded by 16 bytes).
//   At M = 256 the tile traffic, not the products, sets the pace: every
//   block streams its x and packed tiles from L2, so the grid is sized to
//   run in one wave.  The grid is (N/64) x (M/64) x S: the host splits K
//   into S = 2 or 4 ranges (each of at least 4 K tiles) while the grid
//   has fewer blocks than the card can hold at once and the larger grid
//   still fits (61 KB a block: three share an SM) — M = 256 gives 256
//   blocks at N = 1024 (S = 4) and 352 at N = 2816 (S = 2).  The S
//   blocks of one output tile form a thread-block cluster; each leaves
//   its f32 partial tile in its shared memory, and after a cluster
//   barrier block r sums rows r*64/S.. of all S partials through
//   distributed shared memory in the fixed order 0..S-1 and writes them
//   in 16-byte stores.  No atomics, no scratch: the same inputs give the
//   same bits.
// * nm_spmm_kernel — the same product in f32 (no TF32: the f32 packed
//   path must stay f32 math, as the reference's dense-equivalence
//   requires) and, with narrow tiles, the decode product of any dtype,
//   on the f32 FMA pipe.  Each block owns an (BM, BN) output tile and
//   loops over the whole K; per K tile it decompresses the packed tile
//   into shared memory as dense f32 (summing the slots, as above),
//   stages the x tile as f32 beside it, and accumulates in f32
//   registers while the next tile's global loads are in flight.  The
//   epilogue (bias, then none / silu / gelu-tanh) runs on the f32
//   accumulator before the single store.
//
// Decode shapes use narrow tiles (BN = 8) so that N alone spreads the
// work over the 132 SMs (N = 1024 gives 128 blocks, N = 2816 gives 352);
// the block's threads then split each K tile into KS slices and combine
// the slices through shared memory in a fixed order, so results are
// deterministic.  Ragged M, N and K edges are masked in the kernel: the
// caller never pads the weights.  K must divide by 4.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// --------------------------------------------------------------------
// tiled bf16 product on the tensor cores
// --------------------------------------------------------------------
namespace tc {

constexpr int BM = 64, BN = 64, BK = 64;  // output tile, K tile
constexpr int NTH = 128;                  // 4 warps, 32 x 32 each
constexpr int STAGES = 3;                 // ring depth
constexpr int PK = BK / 2;                // packed rows a K tile
constexpr int WLD = BN + 8;               // dense weight tile row (+16 B)
constexpr int RLD = BN + 8;               // f32 partial tile row
// a stage: the x tile (64 x 128 B, 128-byte swizzle), the vals tile
// (32 x 128 B, 128-byte swizzle), the idx tile (32 x 64 B)
constexpr int XS_OFF = 0, VS_OFF = BM * BK * 2, IS_OFF = VS_OFF + PK * BN * 2;
constexpr int STAGE_BYTES = IS_OFF + PK * BN;
constexpr int WS_BYTES = BK * WLD * 2;
constexpr int WS_OFF = STAGES * STAGE_BYTES;
constexpr int BAR_OFF = WS_OFF + 2 * WS_BYTES;
// 61 KB with the 1 KB that aligns the ring: three blocks share an SM.  The
// f32 partial tile reuses the ring.
constexpr int SMEM = 1024 + BAR_OFF + 8 * STAGES;
static_assert(STAGE_BYTES % 1024 == 0 && VS_OFF % 1024 == 0, "swizzle atoms");
static_assert(BM * RLD * 4 <= STAGES * STAGE_BYTES, "partial fits the ring");

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a 2-D box of a tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma2d(uint32_t dst, const CUtensorMap* map,
                                      int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// use_tma: the three tiles of a stage come by TMA (rows on 16 bytes);
// otherwise by cp.async, 16 bytes a copy where vec_* says the operand's
// rows allow it, else element by element — into the same layout.
__global__ void __launch_bounds__(NTH, 3)
    nm_spmm_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_i,
                      const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ vals,
                      const int8_t* __restrict__ idx, float* __restrict__ out,
                      int M, int K, int N, int use_tma, int vec_x, int vec_v,
                      int vec_i) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sbase = (raw + 1023) & ~1023u;       // swizzle atoms
  unsigned char* const smem = smem_raw + (sbase - raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int split = gridDim.z, s_rank = blockIdx.z;
  const int k_half = K / 2;
  const int n_kt = (K + BK - 1) / BK;
  const int t_begin = s_rank * n_kt / split;
  const int t_count = (s_rank + 1) * n_kt / split - t_begin;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const uint32_t bars = sbase + BAR_OFF;

  if (use_tma && tid == 0) {
    for (int st = 0; st < STAGES; ++st) bar_init(bars + 8 * st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // global tile t -> ring slot
  auto load = [&](int t, int slot) {
    const int k0 = t * BK, p0 = t * PK;
    unsigned char* st = smem + slot * STAGE_BYTES;
    if (use_tma) {
      if (tid == 0) {
        const uint32_t bar = bars + 8 * slot, dst = sbase + slot * STAGE_BYTES;
        bar_expect(bar, STAGE_BYTES);
        tma2d(dst + XS_OFF, &map_x, k0, m0, bar);
        tma2d(dst + VS_OFF, &map_v, n0, p0, bar);
        tma2d(dst + IS_OFF, &map_i, n0, p0, bar);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < BM * BK / 8 / NTH; ++j) {        // x: 8 bf16 a chunk
      const int c = tid + NTH * j, r = c / 8, ch = c % 8;
      const int m = m0 + r, k = k0 + ch * 8;
      unsigned char* d = st + XS_OFF + swz(r, ch);
      if (vec_x) {
        const int n_ok = m < M ? max(0, min(8, K - k)) : 0;
        cp16(d, n_ok ? x + (size_t)m * K + k : x, 2 * n_ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          reinterpret_cast<__nv_bfloat16*>(d)[e] =
              (m < M && k + e < K) ? x[(size_t)m * K + k + e] : zero;
      }
    }
#pragma unroll
    for (int j = 0; j < PK * BN / 8 / NTH; ++j) {        // vals: 8 bf16
      const int c = tid + NTH * j, r = c / 8, ch = c % 8;
      const int p = p0 + r, n = n0 + ch * 8;
      unsigned char* d = st + VS_OFF + swz(r, ch);
      if (vec_v) {
        const int n_ok = p < k_half ? max(0, min(8, N - n)) : 0;
        cp16(d, n_ok ? vals + (size_t)p * N + n : vals, 2 * n_ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          reinterpret_cast<__nv_bfloat16*>(d)[e] =
              (p < k_half && n + e < N) ? vals[(size_t)p * N + n + e] : zero;
      }
    }
    {                                                    // idx: 16 B
      const int r = tid / (BN / 16), col = (tid % (BN / 16)) * 16;
      const int p = p0 + r, n = n0 + col;
      int8_t* d = reinterpret_cast<int8_t*>(st + IS_OFF) + r * BN + col;
      if (vec_i) {
        const int n_ok = p < k_half ? max(0, min(16, N - n)) : 0;
        cp16(d, n_ok ? idx + (size_t)p * N + n : idx, n_ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          d[e] = (p < k_half && n + e < N) ? idx[(size_t)p * N + n + e] : 0;
      }
    }
  };
  static_assert(PK * BN / 16 == NTH, "one idx chunk a thread");

  // wait for local tile i (ring slot i % STAGES)
  auto arrive = [&](int i) {
    if (use_tma) bar_wait(bars + 8 * (i % STAGES), (i / STAGES) & 1);
  };

  // packed slot -> dense (BK, BN) bf16: each thread takes column pairs of
  // whole 2:4 groups and sums both slots into their positions
  auto decompress = [&](int slot, int buf) {
    const unsigned char* st = smem + slot * STAGE_BYTES;
    const int8_t* it = reinterpret_cast<const int8_t*>(st + IS_OFF);
    __nv_bfloat16(*w)[WLD] =
        reinterpret_cast<__nv_bfloat16(*)[WLD]>(smem + WS_OFF + buf * WS_BYTES);
#pragma unroll
    for (int j = 0; j < (BK / 4) * (BN / 2) / NTH; ++j) {
      const int e = tid + NTH * j, g = e / (BN / 2), c = (e % (BN / 2)) * 2;
      const int cb = (c % 8) * 2;                         // byte in chunk
      const __nv_bfloat162 v0 = *reinterpret_cast<const __nv_bfloat162*>(
          st + VS_OFF + swz(2 * g, c / 8) + cb);
      const __nv_bfloat162 v1 = *reinterpret_cast<const __nv_bfloat162*>(
          st + VS_OFF + swz(2 * g + 1, c / 8) + cb);
      const char2 i0 = *reinterpret_cast<const char2*>(&it[2 * g * BN + c]);
      const char2 i1 =
          *reinterpret_cast<const char2*>(&it[(2 * g + 1) * BN + c]);
      const float a0 = __bfloat162float(v0.x), a1 = __bfloat162float(v0.y);
      const float b0 = __bfloat162float(v1.x), b1 = __bfloat162float(v1.y);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float lo = (i0.x == r ? a0 : 0.f) + (i1.x == r ? b0 : 0.f);
        const float hi = (i0.y == r ? a1 : 0.f) + (i1.y == r ? b1 : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(&w[4 * g + r][c]) =
            __floats2bfloat162_rn(lo, hi);
      }
    }
  };

  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < t_count) load(t_begin + st, st);
    cp_commit();
  }
  cp_wait<STAGES - 2>();                 // tile 0 has landed
  if (t_count > 0) arrive(0);
  __syncthreads();
  if (t_count > 0) decompress(0, 0);

  for (int i = 0; i < t_count; ++i) {
    cp_wait<STAGES - 3>();               // tile i+1 has landed
    if (i + 1 < t_count) arrive(i + 1);
    __syncthreads();                     // ... and every warp is past i-1
    if (i + STAGES - 1 < t_count)
      load(t_begin + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_commit();
    if (i + 1 < t_count) decompress((i + 1) % STAGES, (i + 1) & 1);
    const uint32_t xt = sbase + (i % STAGES) * STAGE_BYTES + XS_OFF;
    const uint32_t wt = sbase + WS_OFF + (i & 1) * WS_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], xt + swz(wm + mi * 16 + (lane & 15),
                                kk * 2 + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, wt + ((kk * 16 + (lane & 15)) * WLD + wn + np * 16 +
                           (lane >> 4) * 8) * 2);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_wait<0>();
  __syncthreads();                       // the ring is free

  // the f32 partial tile goes to shared memory; then the split's S blocks
  // (one cluster) sum their partials in a fixed order
  float(*red)[RLD] = reinterpret_cast<float(*)[RLD]>(smem);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm + mi * 16 + g, c = wn + ni * 8 + 2 * t4;
      *reinterpret_cast<float2*>(&red[r][c]) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(&red[r + 8][c]) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  namespace cg = cooperative_groups;
  if (split > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
  const int rows = BM / split, r_lo = s_rank * rows;
  const bool vec_out = (N % 4) == 0;
  for (int e = tid; e < rows * (BN / 4); e += NTH) {
    const int r = r_lo + e / (BN / 4), c = (e % (BN / 4)) * 4;
    float4 sum = *reinterpret_cast<const float4*>(&red[r][c]);
    if (split > 1) {           // ranks 0, 1, .., S-1, whoever reduces
      sum = *reinterpret_cast<const float4*>(
          cg::this_cluster().map_shared_rank(&red[r][c], 0));
      for (int q = 1; q < split; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            cg::this_cluster().map_shared_rank(&red[r][c], q));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float* op = out + (size_t)m * N + n;
    if (vec_out && n + 4 <= N) {
      *reinterpret_cast<float4*>(op) = sum;
    } else {
      const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int q = 0; q < 4 && n + q < N; ++q) op[q] = sv[q];
    }
  }
  if (split > 1) cg::this_cluster().sync();  // partials stay until read
}

// once per device: the kernel's shared-memory limit raised to SMEM
// (setting it on every launch would stall the stream), and how many
// blocks of each cluster size can run at once
constexpr int MAX_DEV = 64;
cudaError_t configure(int* capacity) {   // capacity[0..2]: split 1, 2, 4
  static int cap[MAX_DEV][3] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEV) return cudaErrorInvalidDevice;
  if (cap[dev][0] == 0) {
    err = cudaFuncSetAttribute(
        nm_spmm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < 3; ++i) {
      const int split = 1 << i;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(1, 1, split);
      cfg.blockDim = dim3(NTH);
      cfg.dynamicSmemBytes = SMEM;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = split;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, nm_spmm_tc_kernel, &cfg);
      if (err != cudaSuccess) return err;
      cap[dev][i] = clusters * split;
    }
  }
  for (int i = 0; i < 3; ++i) capacity[i] = cap[dev][i];
  return cudaSuccess;
}

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime (no
// link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) tensor of elem-byte elements, boxes of
// (box_rows, box_cols); out-of-bounds elements read as zero
bool encode(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
            int elem, int rows, int cols, int box_rows, int box_cols,
            CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encoder()(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                   estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t run(const void* x, const void* vals, const void* idx,
                void* out, int M, int K, int N, cudaStream_t stream) {
  int capacity[3];
  const cudaError_t err = configure(capacity);
  if (err != cudaSuccess) return err;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int n_kt = (K + BK - 1) / BK;
  // split K (2, then 4) while the grid has fewer blocks than SMs can hold
  // at once, the larger grid still runs in one wave, and each split keeps
  // at least 4 K tiles
  int split = 1;
  for (int i = 1; i < 3; ++i) {
    const int next = 1 << i;
    if (tiles * split >= capacity[i - 1] || tiles * next > capacity[i] ||
        n_kt < 4 * next)
      break;
    split = next;
  }
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = al(x) && K % 8 == 0;
  const int vec_v = al(vals) && N % 8 == 0;
  const int vec_i = al(idx) && N % 16 == 0;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  int use_tma = vec_x && vec_v && vec_i && encoder() != nullptr;
  if (use_tma)
    use_tma =
        encode(&maps[0], x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BM,
               BK, CU_TENSOR_MAP_SWIZZLE_128B) &&
        encode(&maps[1], vals, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K / 2, N,
               PK, BN, CU_TENSOR_MAP_SWIZZLE_128B) &&
        encode(&maps[2], idx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2, N, PK,
               BN, CU_TENSOR_MAP_SWIZZLE_NONE);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, nm_spmm_tc_kernel, maps[0], maps[1],
                            maps[2], static_cast<const __nv_bfloat16*>(x),
                            static_cast<const __nv_bfloat16*>(vals),
                            static_cast<const int8_t*>(idx),
                            static_cast<float*>(out), M, K, N, use_tma, vec_x,
                            vec_v, vec_i);
}

}  // namespace tc

}  // namespace

extern "C" {

// Tiled product for large M (the reference's nm_spmm): no epilogue.  bf16
// runs on the tensor cores, f32 on the FMA pipe.
int nm_spmm_launch(const void* x, const void* vals, const void* idx,
                   void* out, int M, int K, int N, int is_bf16,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)tc::run(x, vals, idx, out, M, K, N, s);
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
