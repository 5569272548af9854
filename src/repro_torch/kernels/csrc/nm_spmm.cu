// Packed 2:4 weight x activation product for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/nm_spmm.py::nm_spmm (tiled,
// large M) and ::nm_spmm_decode (skinny M with a fused bias + activation
// epilogue).  Computes y = act(x @ decompress_24(vals, idx) + bias) with
// x (M, K) f32 or bf16, vals (K/2, N) of x's dtype, idx (K/2, N) int8
// in-group positions 0..3, bias (N,) f32 / bf16 or none, y (M, N) f32.
//
// What bounds it on this card: at decode M (M = 8 a step, 32 a prefill
// chunk) the product is a weight stream, bound by device-memory bytes:
// vals (2 B a pair in bf16) + idx (1 B a pair), each read once — 19.3 MB
// for the seven Qwen1.5-0.5B linears of a layer, 5.9 us at 3.35 TB/s,
// where the sparse products (at M = 8, 0.16 GFLOP) take 0.2 us of the
// tensor cores.  At the prefill chunk's M = 256 it is still bound by
// bytes (at attn.wq 0.94 us of bytes against 0.27 us of sparse bf16
// operations), and so small that a launch lives on latency: what matters
// is that every SM streams its share of the packed weights with the
// copies in flight.
//
// Three kernels on two routes (nm_spmm.last_kernel and
// nm_spmm_decode.last_kernel name the route a launch took):
//
// * nm_spmm_decode_tc_kernel — "tensor cores" for nm_spmm_decode: bf16,
//   M <= 128, rows of vals on 16 bytes and of idx and x on 8 (N % 8 == 0
//   and aligned pointers; nm_spmm.py::decode_plan decides).  A block of 8
//   warps owns 128 output columns and 8, 16 or 32 rows of x (MB = 1, 2, 4
//   batch fragments of 8: M <= 8, <= 16, else 32 rows a block and
//   ceil(M / 32) row blocks).  Each lane streams 8 consecutive columns of
//   one 2:4 group: 16 + 16 bytes of its two vals rows and 8 + 8 of its two
//   idx rows, so the 8 lanes on a row read 128 + 64 contiguous bytes —
//   whole sectors, in 16- and 8-byte read-once loads that ask the L2 for
//   256-byte sector groups — and keeps DEPTH = 4 such 16-deep K steps in
//   flight in registers, with x's fragments for them (8-byte loads of x,
//   which the previous kernel left in L2), issued before anything else.
//   It decompresses in registers: each slot's value goes to its position
//   of a 64-bit word of four bf16 and the two slots are ADDED (a padding
//   slot — value 0 at position 0 beside a kept value there — adds exactly
//   zero), giving the mma's A fragment directly: A rows are output
//   columns (16 a fragment; the lane's 8 columns are 4 fragments' rows g
//   and g + 8), and the k16 step's 16 k slots are permuted so that lane
//   (g, t) holds positions 0..3 of its own group t — the x fragment (B,
//   16 k x 8 batch rows) is then x row g, columns 4t..4t+3.  mma.sync
//   m16n8k16, bf16 in and f32 accumulate: a bf16 x bf16 product is exact
//   in f32, so this is the plain version's function.  K is split over the
//   block's 4 slices (two warps each, one per 64-column half) and over a
//   cluster of cs <= 16 blocks, the largest for which the card holds the
//   whole grid at once (cudaOccupancyMaxActiveClusters) with a K step for
//   every slice: at M = 8 on an H100, 8 strips x 9 at N = 1024 and 22 x 5
//   at N = 2816.  The partials are summed in a fixed order: the slices
//   through shared memory, 0..3; then each block pushes its sum of a part
//   of the tile into the block that finishes that part (st.async into its
//   shared memory, counted by that block's mbarrier — no cluster-wide
//   barrier after the products, only one at the start, split, to know that
//   every block runs), which adds the cluster's blocks 0..cs-1, applies the
//   epilogue (bias, then none / silu / gelu-tanh on the f32 sum) and
//   stores 16 bytes a lane: no atomics, the same inputs give the same
//   bits.  At M <= 8 the registers (<= 128) allow two blocks an SM.
// * nm_spmm_tc_kernel — "tensor cores" for nm_spmm, the tiled product in
//   bf16 (M > 128 rows).  A block of 4 warps owns
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
//   dense bf16 (64, 64) tile by SUMMING each slot into its position,
//   double-buffered so that tile k+1
//   is decompressed while tile k's products run — one __syncthreads a
//   K tile.  Fragments come from ldmatrix (.trans for the dense tile,
//   whose rows are padded by 16 bytes).  Every PROMOTE = 2 K tiles the
//   mma accumulator is added into an f32 total in registers and cleared:
//   the tensor cores' f32 accumulation does not round to nearest, and
//   over one chain of K = 24576 (Jamba's mlp.wo at M = 256, no split)
//   its error passed the f32 tolerance of the plain version.
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
// * nm_spmm_kernel — "f32 FMA": the tiled product and the decode product
//   in f32 (no TF32: the f32 packed path must stay f32 math, as the
//   reference's dense-equivalence requires), and the decode product of
//   bf16 rows that are not aligned for the tensor-core route, on the f32
//   FMA pipe.  Each block owns an (BM, BN) output tile and
//   loops over the whole K; per K tile it decompresses the packed tile
//   into shared memory as dense f32 (summing the slots, as above),
//   stages the x tile as f32 beside it, and accumulates in f32
//   registers while the next tile's global loads are in flight.  The
//   epilogue (bias, then none / silu / gelu-tanh) runs on the f32
//   accumulator before the single store.  Decode shapes use narrow
//   tiles (BN = 8) so that N alone spreads the work over the 132 SMs;
//   the block's threads then split each K tile into KS slices and
//   combine the slices through shared memory in a fixed order, so
//   results are deterministic.
//
// Ragged M, N and K edges are masked in the kernels: the caller never
// pads the weights.  K must divide by 4.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

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

using namespace sm90;

constexpr int BM = 64, BN = 64, BK = 64;  // output tile, K tile
constexpr int NTH = 128;                  // 4 warps, 32 x 32 each
constexpr int STAGES = 3;                 // ring depth
constexpr int PK = BK / 2;                // packed rows a K tile
constexpr int WLD = BN + 8;               // dense weight tile row (+16 B)
constexpr int RLD = BN + 8;               // f32 partial tile row
// K tiles the mma accumulator sums before it is added into the f32 total:
// the tensor cores' f32 accumulation does not round to nearest, and its
// error grows with the chain (past tolerance at K = 24576 in one chain)
constexpr int PROMOTE = 2;
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
    for (int st = 0; st < STAGES; ++st) bar_init(bars + 8 * st, 1);
    bar_init_fence();
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
  float acc[2][4][4], tot[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

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
    if ((i + 1) % PROMOTE == 0 || i + 1 == t_count) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[mi][ni][e] += acc[mi][ni][e];
            acc[mi][ni][e] = 0.f;
          }
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
          make_float2(tot[mi][ni][0], tot[mi][ni][1]);
      *reinterpret_cast<float2*>(&red[r + 8][c]) =
          make_float2(tot[mi][ni][2], tot[mi][ni][3]);
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

// --------------------------------------------------------------------
// skinny-M bf16 product (decode steps, prefill chunks) on the tensor cores
// --------------------------------------------------------------------
namespace dec {

using namespace sm90;

constexpr int BN = 128;        // output columns a block
constexpr int WN = 64;         // output columns a warp (8 a lane)
constexpr int RLD = BN + 4;    // f32 partial row (+16 B)
constexpr int MAX_DEV = 64;
constexpr int SMEM_LIMIT = 200 * 1024;   // dynamic shared memory allowed
constexpr int MAX_CLUSTER = 16;          // = nm_spmm.py DECODE_MAX_CLUSTER
constexpr int KS = 4;          // K slices a block, two warps each
constexpr int NTH = 64 * KS;
constexpr int DEPTH = 4;       // k16 steps in flight a lane

// one lane's share of a k16 step: 2:4 group (step * 4 + lane % 4), its two
// packed rows, 8 consecutive columns — 16 + 16 bytes of vals, 8 + 8 of idx
// — and its x fragments: columns 4t..4t+3 of the step's 16, rows g of the
// MB 8-row batch fragments
template <int MB>
struct Step {
  uint4 v0, v1;
  uint2 i0, i1;
  uint2 x[MB];
};

// a read-once load of the packed weights: not kept in L1, and the L2 asked
// for the whole 256-byte sector group (the lanes on the next rows want it)
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}
__device__ __forceinline__ uint2 ld_stream8(const void* p) {
  uint2 r;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0,%1}, [%2];\n"
               : "=r"(r.x), "=r"(r.y)
               : "l"(p));
  return r;
}

template <int MB>
__device__ __forceinline__ void load_step(
    Step<MB>& s, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ vals, const int8_t* __restrict__ idx,
    int step, int t, int n, int m_g, int M, int K, int N) {
  const int grp = step * 4 + t;
  if (grp < K / 4 && n < N) {
    const size_t r0 = (size_t)(2 * grp) * N + n;
    s.v0 = ld_stream16(vals + r0);
    s.v1 = ld_stream16(vals + r0 + N);
    s.i0 = ld_stream8(idx + r0);
    s.i1 = ld_stream8(idx + r0 + N);
  } else {                      // value 0 at position 0: adds nothing
    s.v0 = s.v1 = make_uint4(0, 0, 0, 0);
    s.i0 = s.i1 = make_uint2(0, 0);
  }
#pragma unroll
  for (int b = 0; b < MB; ++b) {
    const int m = m_g + 8 * b;
    s.x[b] = (m < M && grp < K / 4)
                 ? __ldg(reinterpret_cast<const uint2*>(x + (size_t)m * K +
                                                        4 * grp))
                 : make_uint2(0, 0);
  }
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  const __nv_bfloat162 r = __hadd2(x, y);
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

// the 8 columns' dense group rows as bf16 pairs: p01[c] = positions (0, 1),
// p23[c] = (2, 3).  Each slot's value goes to its position in a 64-bit
// word and the two slots are ADDED: a padding slot (value 0 at position 0)
// beside a kept value at position 0 adds exactly zero.
template <int MB>
__device__ __forceinline__ void decompress(const Step<MB>& s, uint32_t* p01,
                                           uint32_t* p23) {
  const uint32_t v0[4] = {s.v0.x, s.v0.y, s.v0.z, s.v0.w};
  const uint32_t v1[4] = {s.v1.x, s.v1.y, s.v1.z, s.v1.w};
  const uint32_t i0[2] = {s.i0.x, s.i0.y}, i1[2] = {s.i1.x, s.i1.y};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint64_t a = (v0[c >> 1] >> (16 * (c & 1))) & 0xffffu;
    const uint64_t b = (v1[c >> 1] >> (16 * (c & 1))) & 0xffffu;
    const int pa = (i0[c >> 2] >> (8 * (c & 3))) & 3;
    const int pb = (i1[c >> 2] >> (8 * (c & 3))) & 3;
    const uint64_t da = a << (16 * pa), db = b << (16 * pb);
    p01[c] = add_bf16x2((uint32_t)da, (uint32_t)db);
    p23[c] = add_bf16x2((uint32_t)(da >> 32), (uint32_t)(db >> 32));
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of the same shared-memory byte in block `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// 16 bytes into (another block's) shared memory, counted by its mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// shared memory of one block: the slices' f32 partials, the cluster's
// partials of this block's share of the output tile, and the mbarrier
// that counts their bytes (at most 84 KB)
struct Layout {
  int recv_off, bar_off, share, bytes;
};
__host__ __device__ inline Layout layout(int mb, int ks, int cs) {
  const int e = 8 * mb * (BN / 4);                 // float4s of the tile
  Layout l;
  l.recv_off = ks * 8 * mb * RLD * 4;
  l.share = (e + cs - 1) / cs;
  l.bar_off = l.recv_off + cs * l.share * 16;
  l.bytes = l.bar_off + 8;
  return l;
}

// y = act(x @ W + bias) for 8 * MB rows of x (blockIdx.y) and 128 columns
// (blockIdx.x / cs); the cluster's cs blocks split the k16 steps, the KS
// slices of a block split its share again.  At MB = 1 the registers allow
// two blocks an SM.
template <int MB>
__global__ void __launch_bounds__(NTH, MB == 1 ? 2 : 1)
    nm_spmm_decode_tc_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ vals,
                             const int8_t* __restrict__ idx,
                             const void* __restrict__ bias, int bias_bf16,
                             float* __restrict__ out, int M, int K, int N,
                             int act, int cs) {
  constexpr int ROWS = 8 * MB;
  constexpr int E = ROWS * (BN / 4);    // float4s of the output tile
  static_assert(E <= MB * NTH, "MB passes of the block cover any share");
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(MB, KS, cs);
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int strip = blockIdx.x / cs, q = blockIdx.x % cs;
  const int m0 = blockIdx.y * ROWS;
  const int steps = (K / 4 + 3) / 4;
  const int s0 = q * steps / cs, nb = (q + 1) * steps / cs - s0;
  const int half = warp & 1, sl = warp >> 1;
  const int w0 = s0 + sl * nb / KS, wn = s0 + (sl + 1) * nb / KS - w0;
  const int n = strip * BN + half * WN + 8 * g;
  const uint32_t bar = sbase + lay.bar_off;

  // up to DEPTH k16 steps of packed weights and x in flight a lane, the
  // first thing the block does
  Step<MB> buf[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (d < wn)
      load_step(buf[d], x, vals, idx, w0 + d, t, n, m0 + g, M, K, N);

  // this block's share of the output tile, [e_lo, e_hi) in float4s (one
  // per lane and pass, MB passes), and the bias of its columns
  const int e_lo = q * lay.share, e_hi = min(E, e_lo + lay.share);
  float bv[MB][4];
#pragma unroll
  for (int it = 0; it < MB; ++it) {
    const int e = e_lo + tid + it * NTH;
    const int col = strip * BN + (e % (BN / 4)) * 4;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      bv[it][u] =
          bias == nullptr || e >= e_hi || col >= N ? 0.f
          : bias_bf16
              ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col + u])
              : static_cast<const float*>(bias)[col + u];
  }

  if (tid == 0) {
    bar_init(bar, 1);
    bar_init_fence();
  }
  // the cluster's barrier completes once every block has started and
  // initialised its mbarrier: only then may a block write into another's
  // shared memory
  if (cs > 1) cluster_arrive_relaxed();

  float acc[4][MB][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][b][e] = 0.f;

  for (int base = 0; base < wn; base += DEPTH) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int i = base + d;
      if (i < wn) {
        // the mma's k slots (2t, 2t+1, 2t+8, 2t+9) are positions 0..3 of
        // the lane's group: A row g = column 8g + 2j, row g + 8 = 8g + 2j + 1;
        // B holds x row g, columns 4t..4t+3 of the step
        uint32_t p01[8], p23[8], bx[MB][2];
        decompress(buf[d], p01, p23);
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          bx[b][0] = buf[d].x[b].x;
          bx[b][1] = buf[d].x[b].y;
        }
        if (i + DEPTH < wn)
          load_step(buf[d], x, vals, idx, w0 + i + DEPTH, t, n, m0 + g, M, K,
                    N);
#pragma unroll
        for (int b = 0; b < MB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t a[4] = {p01[2 * j], p01[2 * j + 1], p23[2 * j],
                                   p23[2 * j + 1]};
            mma16816(acc[j][b], a, bx[b]);
          }
      }
    }
  }

  // slice partials [KS][ROWS][RLD]: lane (g, t) holds rows 2t, 2t+1 of each
  // 8-row batch fragment at columns 8g..8g+7 of its warp's half
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int b = 0; b < MB; ++b) {
    float* p = red + (sl * ROWS + b * 8 + 2 * t) * RLD + half * WN + 8 * g;
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[0][b][0], acc[0][b][2], acc[1][b][0], acc[1][b][2]);
    *reinterpret_cast<float4*>(p + 4) =
        make_float4(acc[2][b][0], acc[2][b][2], acc[3][b][0], acc[3][b][2]);
    *reinterpret_cast<float4*>(p + RLD) =
        make_float4(acc[0][b][1], acc[0][b][3], acc[1][b][1], acc[1][b][3]);
    *reinterpret_cast<float4*>(p + RLD + 4) =
        make_float4(acc[2][b][1], acc[2][b][3], acc[3][b][1], acc[3][b][3]);
  }
  __syncthreads();
  if (cs > 1) cluster_wait();           // every block of the cluster runs
  // this block's share of the tile takes one float4 from each block of the
  // cluster, counted in bytes by the mbarrier
  if (tid == 0) bar_expect(bar, e_hi > e_lo ? (e_hi - e_lo) * cs * 16 : 0);
  // the block's partial = its slices 0..KS-1 in order, pushed into slot q
  // of the receiver of the block that finishes that part of the tile
  const uint32_t recv = sbase + lay.recv_off;
  for (int e = tid; e < E; e += NTH) {
    const float* p = red + (e / (BN / 4)) * RLD + (e % (BN / 4)) * 4;
    float4 s = *reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int k = 1; k < KS; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(p + k * ROWS * RLD);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int owner = e / lay.share;
    st_async(mapa(recv + (q * lay.share + e - owner * lay.share) * 16, owner),
             s, mapa(bar, owner));
  }
  bar_wait(bar, 0);                     // the cluster's partials are in

  // ranks 0..cs-1 summed in order, then bias, activation and one store
  const float4* rv = reinterpret_cast<const float4*>(smem + lay.recv_off);
#pragma unroll
  for (int it = 0; it < MB; ++it) {
    const int e = e_lo + tid + it * NTH;
    if (e >= e_hi) continue;
    float4 v[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < cs) v[k] = rv[k * lay.share + e - e_lo];
    float4 s = v[0];
#pragma unroll
    for (int k = 1; k < MAX_CLUSTER; ++k)
      if (k < cs) {
        s.x += v[k].x;
        s.y += v[k].y;
        s.z += v[k].z;
        s.w += v[k].w;
      }
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const int m = m0 + r, col = strip * BN + c;
    if (m >= M || col >= N) continue;   // N % 8 == 0: col + 3 < N
    const float4 y = make_float4(
        epilogue(s.x, bv[it][0], act), epilogue(s.y, bv[it][1], act),
        epilogue(s.z, bv[it][2], act), epilogue(s.w, bv[it][3], act));
    *reinterpret_cast<float4*>(out + (size_t)m * N + col) = y;
  }
}

// once per device: the shared-memory limit raised and clusters above 8
// allowed for each instance
template <int MB>
cudaError_t configure() {
  static int done[MAX_DEV] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEV) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(nm_spmm_decode_tc_kernel<MB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(nm_spmm_decode_tc_kernel<MB>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    done[dev] = 1;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t config(dim3 grid, int nth, int smem, int cs,
                          cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(nth);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// how many clusters of cs blocks the card runs at once, one block an SM
// (blocks counted at the shared-memory limit)
template <int MB>
cudaError_t clusters(int cs, int* n) {
  cudaError_t err = configure<MB>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(dim3(cs), NTH, SMEM_LIMIT, cs, 0, attr);
  return cudaOccupancyMaxActiveClusters(n, nm_spmm_decode_tc_kernel<MB>, &cfg);
}

template <int MB>
cudaError_t run(const void* x, const void* vals, const void* idx,
                const void* bias, int bias_bf16, void* out, int M, int K,
                int N, int act, int cs, cudaStream_t stream) {
  cudaError_t err = configure<MB>();
  if (err != cudaSuccess) return err;
  const int smem = layout(MB, KS, cs).bytes;
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(dim3((N + BN - 1) / BN * cs, (M + 8 * MB - 1) / (8 * MB)),
             NTH, smem, cs, stream, attr);
  return cudaLaunchKernelEx(&cfg, nm_spmm_decode_tc_kernel<MB>,
                            static_cast<const __nv_bfloat16*>(x),
                            static_cast<const __nv_bfloat16*>(vals),
                            static_cast<const int8_t*>(idx), bias, bias_bf16,
                            static_cast<float*>(out), M, K, N, act, cs);
}

}  // namespace dec

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
// none, 1 silu, 2 gelu-tanh.  tc: the bf16 tensor-core route with mb 8-row
// batch fragments a block and K split over a cluster of cs blocks (the
// plan of nm_spmm.py::decode_plan); otherwise the FMA kernel.
int nm_spmm_decode_launch(const void* x, const void* vals, const void* idx,
                          const void* bias, int bias_bf16, void* out, int M,
                          int K, int N, int act, int is_bf16, int tc, int mb,
                          int cs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (!is_bf16 || cs < 1 || cs > dec::MAX_CLUSTER)
      return (int)cudaErrorInvalidValue;
    if (mb == 1)
      return (int)dec::run<1>(x, vals, idx, bias, bias_bf16, out, M, K, N,
                              act, cs, s);
    if (mb == 2)
      return (int)dec::run<2>(x, vals, idx, bias, bias_bf16, out, M, K, N,
                              act, cs, s);
    if (mb == 4)
      return (int)dec::run<4>(x, vals, idx, bias, bias_bf16, out, M, K, N,
                              act, cs, s);
    return (int)cudaErrorInvalidValue;
  }
  if (is_bf16)
    decode<__nv_bfloat16>(x, vals, idx, bias, bias_bf16, out, M, K, N, act, s);
  else
    decode<float>(x, vals, idx, bias, bias_bf16, out, M, K, N, act, s);
  return (int)cudaGetLastError();
}

// How many clusters of cs tensor-core decode blocks (mb batch fragments)
// the card runs at once: the host's cluster sizing (nm_spmm.py).
int nm_spmm_decode_clusters(int mb, int cs, int* n) {
  *n = 0;
  if (mb == 1) return (int)dec::clusters<1>(cs, n);
  if (mb == 2) return (int)dec::clusters<2>(cs, n);
  if (mb == 4) return (int)dec::clusters<4>(cs, n);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
