// Full-sequence attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attn
// (_flash_kernel): causal or non-causal softmax attention with an f32
// output, never materialising the (T, T) score matrix, optionally over a
// sliding window (causal only: query t sees keys s with t - window < s <=
// t, the reference's causal_mask, which its model computes in jnp for
// attn_local layers), or with a bidirectional prefix (causal only: every
// query also sees the keys s < prefix, the reference's causal_mask(
// prefix_len=) of the prefix-LM, whose image positions see each other).
// Here it reads the model's own layouts through strides: q (B, T, H, hd)
// and k, v (B, S, KV, hd) with head h reading kv head h / (H / KV)
// (grouped-query attention), the last dimension contiguous; S = T when
// causal, any S otherwise (an encoder-decoder's cross-attention: T decoder
// queries over S encoder keys).  The (BH, T, D) signature of the TPU
// kernel is the case H = KV = 1, S = T.  The output is (B, T, H, hd) f32,
// contiguous, so the caller's reshape to (B, T, H * hd) is free.
//
// What bounds it on this card: a causal call does 2 B H T^2 hd flops
// (QK^T and PV over the lower triangle) against 3 B T H hd input elements
// and B T H hd f32 outputs — at the prune path's stacked capture (128 x
// 2048, 16 heads, hd 64) some 500 flops a byte, so it is bound by
// operations: 1.112 ms on the bf16 tensor cores (69 us at B = 8).
//
// Design.  The TPU kernel carries acc / m / l across a sequential kv grid
// axis in VMEM; here the kv axis is a loop inside the block.  One block
// owns one (b, h, query tile); the running max m and sum l of each query
// row stay in registers, in f32, and are rescaled once per key tile.
// Scores are kept in base 2 (scaled by log2(e) / sqrt(hd)), so every
// exponential is one exp2f.  A causal block's loop ends at its diagonal
// tile, and the first query tiles scheduled are the longest ones.  A row
// whose keys are all masked keeps m = -inf and produces zeros, never NaN
// (the guard of the reference's _sdpa_online).  A window starts a
// block's kv loop at the tile holding its first row's oldest key, skips
// (per warp) the tiles wholly before its rows' bands, and masks the
// band's lower edge as the causal mask does its upper edge; a row always
// sees its own key, and a tile wholly masked for a row leaves its m, l
// and O as they were (exp2 of -inf is 0, and -inf - -inf never arises).
// A prefix extends a causal block's loop to the prefix's last key when
// that lies past its diagonal, starts a windowed loop at key 0, and keeps
// the prefix's keys live in every skip and mask test (a tile wholly inside
// the prefix needs no mask); no row is ever fully masked then.  The query
// and key lengths are separate throughout, so a non-causal call takes any
// S.  The ragged last query and kv tiles are masked, never padded.  No
// atomics: the same inputs give the same bits.  Offsets are 64-bit: a
// stacked calibration q holds 268 M elements.
//
// Three kernels, chosen per call on the host:
//
// * flash_attn_wgmma_kernel — bf16 q/k/v with hd 64 (the model's) and rows
//   on 16 bytes: Hopper's warpgroup MMA (wgmma, bf16 in, f32 accumulate).
//   A block of two warpgroups owns 128 query rows (64 each), so every K/V
//   tile brought into shared memory serves 128 rows.  The 64-key K and V
//   tiles stream through a ring of 3 stages filled by 16-byte cp.async
//   copies, two tiles ahead of the products, with one __syncthreads a
//   tile; keys past T are zero-filled by the copies' source size.  Q, K
//   and V sit in shared memory in wgmma's 128-byte swizzle (no padding,
//   no bank conflicts), so QK^T reads both operands through descriptors
//   and PV reads V through one, transposed.  S lands in wgmma's
//   accumulator layout, which is also the A-operand register layout of
//   PV, so P never leaves registers.  P is split into two bf16 halves
//   (hi = bf16(p), lo = bf16(p - hi)) and both are multiplied by V, so
//   the probabilities keep ~16 bits, as the reference's f32 online
//   softmax keeps them (not the 8 of a bf16 rounding).  Only a tile that
//   holds a key past T or past one of the warpgroup's rows pays for the
//   mask; a warpgroup whose rows all precede the tile skips it.
// * flash_attn_mma_kernel — bf16 with hd 32, 128 or 256: the same block
//   of 128 rows (8 warps of 16) and the same ring, on mma.sync m16n8k16,
//   K's B fragments from ldmatrix (two k-steps a load) and V's from
//   ldmatrix.trans, shared rows padded by 16 bytes.  At hd 256 (gemma) a
//   thread's O accumulator is 128 registers, so Q's A fragments are read
//   from a shared Q tile by ldmatrix a k-step at a time and the key tile
//   is 32 wide (MmaTile): a kernel that is right first, not yet a fast one.
// * flash_attn_kernel — everything else (f32, other head dims or
//   alignments, hd up to 256), on the f32 FMA pipe with 64-row query
//   tiles: each query row is held by TPR = HDP / 32 neighbouring threads,
//   each owning 32 of the head's dimensions in interleaved float4 chunks
//   (no bank conflicts), a partial dot product per key summed over the
//   row's lanes by shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int DPT = 32;   // head dimensions per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// HDP: the head dimension rounded up to 32, 64, 128 or 256; BK: kv rows
// per shared-memory tile (K and V tiles together stay within 32 KB of
// static shared memory: BK 16 at HDP 256).
template <typename T, int HDP, int BK>
__global__ void __launch_bounds__(BQ * (HDP / DPT))
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ out,
                      int n_tok, int n_key, int n_head, int group, int hd,
                      int64_t q_sb, int64_t q_st, int64_t q_sh,
                      int64_t k_sb, int64_t k_st, int64_t k_sh,
                      int64_t v_sb, int64_t v_st, int64_t v_sh,
                      int causal, int window, int prefix, float qscale) {
  constexpr int TPR = HDP / DPT;       // threads per query row
  constexpr int NT = BQ * TPR;
  constexpr int NC = DPT / 4;          // float4 chunks per thread
  __shared__ __align__(16) float ks[BK][HDP];
  __shared__ __align__(16) float vs[BK][HDP];

  const int bh = blockIdx.x;
  const int b = bh / n_head, h = bh % n_head, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = q0 + row;

  // this thread's dims: chunk c holds d = (c * TPR + part) * 4 + e
  float qr[DPT], acc[DPT];
  const T* qp = q + (int64_t)b * q_sb + (int64_t)qi * q_st + (int64_t)h * q_sh;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (c * TPR + part) * 4 + e;
      qr[c * 4 + e] = (qi < n_tok && d < hd) ? to_f(qp[d]) * qscale : 0.f;
      acc[c * 4 + e] = 0.f;
    }
  float m = -CUDART_INF_F, l = 0.f;

  const T* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;
  // a causal block ends at its last row's key, or past the prefix
  const int k_end = causal ? min(n_key, max(q0 + BQ, prefix)) : n_key;
  // a window's band: the block's first row sees keys from q0 - window + 1
  // (and every row the prefix's keys from 0)
  const int k_beg =
      window && !prefix ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = k_beg; k0 < k_end; k0 += BK) {
    // stage the tile as f32; neighbouring threads read neighbouring dims
    for (int i = threadIdx.x; i < BK * HDP; i += NT) {
      const int j = i / HDP, d = i % HDP, key = k0 + j;
      const bool ok = key < n_key && d < hd;
      ks[j][d] = ok ? to_f(kb[(int64_t)key * k_st + d]) : 0.f;
      vs[j][d] = ok ? to_f(vb[(int64_t)key * v_st + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&ks[j][(c * TPR + part) * 4]);
        a = fmaf(qr[c * 4 + 0], kk.x, a);
        a = fmaf(qr[c * 4 + 1], kk.y, a);
        a = fmaf(qr[c * 4 + 2], kk.z, a);
        a = fmaf(qr[c * 4 + 3], kk.w, a);
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      const int key = k0 + j;
      const bool live =
          key < n_key && (key < prefix || ((!causal || key <= qi) &&
                                           (!window || key > qi - window)));
      s[j] = live ? a : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = m == -CUDART_INF_F ? 0.f : exp2f(m - m_safe);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = exp2f(s[j] - m_safe);     // 0 for a masked key
      l += p;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[j][(c * TPR + part) * 4]);
        acc[c * 4 + 0] = fmaf(p, vv.x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = fmaf(p, vv.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(p, vv.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(p, vv.w, acc[c * 4 + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (qi >= n_tok) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* op = out + (((int64_t)b * n_tok + qi) * n_head + h) * hd;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = (c * TPR + part) * 4;
    if (d < hd)
      *reinterpret_cast<float4*>(op + d) =
          make_float4(acc[c * 4 + 0] * inv, acc[c * 4 + 1] * inv,
                      acc[c * 4 + 2] * inv, acc[c * 4 + 3] * inv);
  }
}

// --------------------------------------------------------------------
// tensor-core kernel (bf16)
// --------------------------------------------------------------------
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the hi / lo bf16 halves of a probability pair, packed
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(p0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(p1);
  hi = pack2(h0, h1);
  lo = pack2(p0 - __bfloat162float(h0), p1 - __bfloat162float(h1));
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

constexpr int MMA_BQ = 128;     // query rows per block: 8 warps of 16
constexpr int MMA_NT = 256;
constexpr int MMA_BK = 64;      // keys per tile

// The K / V ring: 3 stages (2 at hd 128, whose block holds one SM alone).
// hd 256: a warp's f32 O accumulator alone takes 128 registers a thread,
// so Q stays in shared memory (one ldmatrix.x4 a k-step instead of 64
// fragment registers) and the key tile is 32 wide (16 score registers):
// 3 stages of K and V (99 KB) beside the 128-row Q tile (66 KB).
template <int HD>
struct MmaTile {
  static constexpr int LD = HD + 8;             // padded row (+16 bytes)
  static constexpr int BK = HD == 256 ? 32 : MMA_BK;
  static constexpr int STAGES = HD == 128 ? 2 : 3;
  static constexpr bool Q_SMEM = HD == 256;
  static constexpr int TILE = BK * LD;          // elements of one K tile
  static constexpr int Q_OFF = STAGES * 2 * TILE;
  static constexpr int SMEM = (Q_OFF + (Q_SMEM ? MMA_BQ * LD : 0)) * 2;
};

// hd 32: registers capped at 128 so that two blocks share an SM
template <int HD>
__global__ void __launch_bounds__(MMA_NT, HD >= 128 ? 1 : 2)
    flash_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          float* __restrict__ out, int n_tok, int n_key,
                          int n_head, int group, int64_t q_sb, int64_t q_st,
                          int64_t q_sh,
                          int64_t k_sb, int64_t k_st, int64_t k_sh,
                          int64_t v_sb, int64_t v_st, int64_t v_sh,
                          int causal, int window, int prefix, float sscale) {
  using Tile = MmaTile<HD>;
  constexpr int BK = Tile::BK, LD = Tile::LD, STAGES = Tile::STAGES;
  constexpr int KS = HD / 16;     // k-steps of QK^T
  constexpr int ND = HD / 8;      // 8-wide output column tiles
  constexpr int CH = HD / 8;      // 16-byte chunks per row
  constexpr int NKT = BK / 8;     // 8-key score tiles
  constexpr int NPV = BK / 16;    // 16-key steps of PV
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* const smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // slot st: K tile at smem + 2 st TILE, V tile right after it

  const int bh = blockIdx.x;
  const int b = bh / n_head, h = bh % n_head, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_BQ;  // longest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int w0 = q0 + warp * 16;                      // the warp's rows
  const int r0 = w0 + g, r1 = r0 + 8;                 // this thread's rows

  const __nv_bfloat16* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const __nv_bfloat16* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;
  const int k_end = causal ? min(n_key, max(q0 + MMA_BQ, prefix)) : n_key;
  const int n_tiles = (k_end + BK - 1) / BK;
  // a window's band: the block's first row sees keys from q0 - window + 1
  const int j_beg = window && !prefix ? max(0, q0 - window + 1) / BK : 0;

  // tile j -> ring slot: 16-byte copies, keys past T zero-filled
  auto load = [&](int j, int slot) {
    __nv_bfloat16* ks = smem + 2 * slot * Tile::TILE;
    __nv_bfloat16* vs = ks + Tile::TILE;
#pragma unroll
    for (int i = threadIdx.x; i < BK * CH; i += MMA_NT) {
      const int r = i / CH, c = (i % CH) * 8, key = j * BK + r;
      const bool ok = key < n_key;
      cp16(ks + r * LD + c, ok ? kb + (int64_t)key * k_st + c : kb,
           ok ? 16 : 0);
      cp16(vs + r * LD + c, ok ? vb + (int64_t)key * v_st + c : vb,
           ok ? 16 : 0);
    }
  };
  const __nv_bfloat16* qb = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
  if constexpr (Tile::Q_SMEM) {
    // the Q tile joins the first tile's copies; rows past T zero-filled
    __nv_bfloat16* qs = smem + Tile::Q_OFF;
#pragma unroll
    for (int i = threadIdx.x; i < MMA_BQ * CH; i += MMA_NT) {
      const int r = i / CH, c = (i % CH) * 8, row = q0 + r;
      const bool ok = row < n_tok;
      cp16(qs + r * LD + c, ok ? qb + (int64_t)row * q_st + c : qb,
           ok ? 16 : 0);
    }
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (j_beg + st < n_tiles) load(j_beg + st, st);
    cp_commit();
  }

  // Q as A fragments (loaded while the first tiles are in flight): reg 0
  // (row g, cols 2t..), 1 (row g+8), 2 (row g, cols 8+2t..), 3 (row g+8,
  // cols 8+2t..) of each 16-column k-step; at hd 256 ldmatrix reads them
  // from shared memory a k-step at a time
  uint32_t qa[Tile::Q_SMEM ? 1 : KS][4];
  if constexpr (!Tile::Q_SMEM) {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = (r & 1) ? r1 : r0;
        const int col = kk * 16 + (r >> 1) * 8 + tig * 2;
        const __nv_bfloat16* p = qb + (int64_t)row * q_st + col;
        qa[kk][r] = row < n_tok ? pack2(p[0], p[1]) : pack2(zero, zero);
      }
  }
  // lane l addresses row (l & 15), column block (l >> 4) of a k-step's
  // 16 x 16 A tile: the four 8 x 8 matrices land as regs 0..3 above
  const uint32_t qs_lane = static_cast<uint32_t>(__cvta_generic_to_shared(
      smem + Tile::Q_OFF + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8));

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int j = j_beg; j < n_tiles; ++j) {
    const int it = j - j_beg;         // the ring turns from the band's start
    cp_wait<STAGES - 2>();            // tile j has landed
    __syncthreads();                  // ... and every warp is past j-1
    if (j + STAGES - 1 < n_tiles)
      load(j + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_commit();
    const int k0 = j * BK;
    // a warp whose rows all lie past T, all precede the tile's keys, or
    // all see the window end before the tile starts (no prefix key in it)
    if (w0 >= n_tok ||
        (k0 >= prefix && ((causal && k0 > w0 + 15) ||
                          (window && k0 + BK - 1 <= w0 - window))))
      continue;
    const __nv_bfloat16* ks = smem + 2 * (it % STAGES) * Tile::TILE;
    const __nv_bfloat16* vs = ks + Tile::TILE;

    // S = Q K^T for this warp's 16 rows and the tile's keys; one
    // ldmatrix.x4 gives the B fragments of two k-steps of one key tile
    float s[NKT][4];
    if constexpr (Tile::Q_SMEM) {
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        uint32_t a0[4], a1[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(a0[0]), "=r"(a0[1]), "=r"(a0[2]), "=r"(a0[3])
            : "r"(qs_lane + (uint32_t)(kk * 32)));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(a1[0]), "=r"(a1[1]), "=r"(a1[2]), "=r"(a1[3])
            : "r"(qs_lane + (uint32_t)(kk * 32 + 32)));
#pragma unroll
        for (int nt = 0; nt < NKT; ++nt) {
          const uint32_t addr = static_cast<uint32_t>(
              __cvta_generic_to_shared(ks + (nt * 8 + (lane & 7)) * LD +
                                       kk * 16 + (lane >> 3) * 8));
          uint32_t b4[4];
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
              "[%4];\n"
              : "=r"(b4[0]), "=r"(b4[1]), "=r"(b4[2]), "=r"(b4[3])
              : "r"(addr));
          mma16816(s[nt], a0, b4[0], b4[1]);
          mma16816(s[nt], a1, b4[2], b4[3]);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 2) {
          const uint32_t addr = static_cast<uint32_t>(
              __cvta_generic_to_shared(ks + (nt * 8 + (lane & 7)) * LD +
                                       kk * 16 + (lane >> 3) * 8));
          uint32_t b4[4];
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
              "[%4];\n"
              : "=r"(b4[0]), "=r"(b4[1]), "=r"(b4[2]), "=r"(b4[3])
              : "r"(addr));
          mma16816(s[nt], qa[kk], b4[0], b4[1]);
          mma16816(s[nt], qa[kk + 1], b4[2], b4[3]);
        }
      }
    }
    // raw scores here; the scale joins the exponent below (one fma).  The
    // mask only where some key of the tile is past S, or lies past the
    // prefix and past one of the warp's rows or before their windows
    if (k0 + BK > n_key ||
        (k0 + BK > prefix && ((causal && k0 + BK - 1 > w0) ||
                              (window && k0 <= w0 + 15 - window)))) {
#pragma unroll
      for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + nt * 8 + tig * 2 + e;
          const bool in = key < n_key, pre = key < prefix;
          if (!in || (!pre && ((causal && key > r0) ||
                               (window && key <= r0 - window))))
            s[nt][e] = -CUDART_INF_F;
          if (!in || (!pre && ((causal && key > r1) ||
                               (window && key <= r1 - window))))
            s[nt][2 + e] = -CUDART_INF_F;
        }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {     // the row's 4 lanes
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    // the new maxima in base-2 units (0 while a row has no live key)
    const float z0 = n0 == -CUDART_INF_F ? 0.f : n0 * sscale;
    const float z1 = n1 == -CUDART_INF_F ? 0.f : n1 * sscale;
    const float a0 = m0 == -CUDART_INF_F ? 0.f : exp2f(fmaf(m0, sscale, -z0));
    const float a1 = m1 == -CUDART_INF_F ? 0.f : exp2f(fmaf(m1, sscale, -z1));
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }
    m0 = n0;
    m1 = n1;

    // O += P V, 16 keys at a time; S's accumulator layout is P's A layout
    const uint32_t vs_base = static_cast<uint32_t>(__cvta_generic_to_shared(
        vs + (lane & 15) * LD + (lane >> 4) * 8));
#pragma unroll
    for (int jj = 0; jj < NPV; ++jj) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(s[2 * jj][e], sscale, e < 2 ? -z0 : -z1));
        p[4 + e] = exp2f(fmaf(s[2 * jj + 1][e], sscale, e < 2 ? -z0 : -z1));
      }
      l0 += p[0] + p[1] + p[4] + p[5];
      l1 += p[2] + p[3] + p[6] + p[7];
      uint32_t hi[4], lo[4];
      split2(p[0], p[1], hi[0], lo[0]);      // row g,   keys 16jj + 2t
      split2(p[2], p[3], hi[1], lo[1]);      // row g+8, keys 16jj + 2t
      split2(p[4], p[5], hi[2], lo[2]);      // row g,   keys 16jj + 8 + 2t
      split2(p[6], p[7], hi[3], lo[3]);      // row g+8, keys 16jj + 8 + 2t
#pragma unroll
      for (int d = 0; d < ND; d += 2) {
        uint32_t v0, v1, v2, v3;
        const uint32_t addr =
            vs_base + (uint32_t)((jj * 16 * LD + d * 8) * 2);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
            : "r"(addr));
        mma16816(o[d], hi, v0, v1);
        mma16816(o[d], lo, v0, v1);
        mma16816(o[d + 1], hi, v2, v3);
        mma16816(o[d + 1], lo, v2, v3);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = d * 8 + tig * 2;
    if (r0 < n_tok)
      *reinterpret_cast<float2*>(
          out + (((int64_t)b * n_tok + r0) * n_head + h) * HD + col) =
          make_float2(o[d][0] * i0, o[d][1] * i0);
    if (r1 < n_tok)
      *reinterpret_cast<float2*>(
          out + (((int64_t)b * n_tok + r1) * n_head + h) * HD + col) =
          make_float2(o[d][2] * i1, o[d][3] * i1);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       float* out, int n_b, int n_tok, int n_key, int n_head,
                       int n_kv, const int64_t* st, int causal, int window,
                       int prefix, cudaStream_t s) {
  constexpr int smem = MmaTile<HD>::SMEM;
  // the shared-memory limit, raised once per device (setting it on every
  // launch would stall the stream)
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(flash_attn_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  const dim3 grid(n_b * n_head, (n_tok + MMA_BQ - 1) / MMA_BQ);
  const float sscale = 1.4426950408889634f / sqrtf((float)HD);
  flash_attn_mma_kernel<HD><<<grid, MMA_NT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, n_tok, n_key, n_head,
      n_head / n_kv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, window, prefix, sscale);
  return cudaGetLastError();
}

// --------------------------------------------------------------------
// warpgroup (wgmma) kernel: bf16, hd 64
// --------------------------------------------------------------------
// Q, K and V tiles are stored as the 128-byte swizzle atom of wgmma: a
// row of 64 bf16 is 128 bytes, its 16-byte chunk c at chunk c ^ (row % 8),
// 8-row groups 1024 bytes apart.  Q and K are QK^T's A and B operands,
// K-major; V is PV's B operand, MN-major (transposed).  P's hi / lo halves
// are PV's A operand in registers, in mma.sync's fragment layout, which
// wgmma shares.
constexpr int WG_TILE = 64 * 64 * 2;            // bytes of one K or V tile
constexpr int WG_STAGES = 3;
constexpr int WG_Q = WG_STAGES * 2 * WG_TILE;   // the 128-row Q tile
constexpr int WG_SMEM = WG_Q + 2 * WG_TILE + 1024;        // + alignment

__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);    // start address
  // both byte offsets 1024 (8 rows): the stride between 8-row groups; the
  // other offset is unused while a tile is one atom wide (64 bf16)
  d |= (uint64_t)(1024 >> 4) << 16;                 // leading byte offset
  d |= (uint64_t)(1024 >> 4) << 32;                 // stride byte offset
  d |= (uint64_t)1 << 62;                           // 128-byte swizzle
  return d;
}

// d (64 x 64 f32, this warpgroup) += a (64 x 16 bf16, registers) * B
// (16 x 64 bf16 through desc, MN-major)
__device__ __forceinline__ void wgmma64_rs(float* d, const uint32_t* a,
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// d (64 x 64 f32) = or += A (64 x 16 bf16 through desc_a, K-major) * B
// (16 x 64 bf16 through desc_b, K-major)
__device__ __forceinline__ void wgmma64_ss(float* d, uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence_operand(float* d, int n) {
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(MMA_NT, 2)
    flash_attn_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            float* __restrict__ out, int n_tok, int n_key,
                            int n_head, int group, int64_t q_sb, int64_t q_st,
                            int64_t q_sh, int64_t k_sb, int64_t k_st,
                            int64_t k_sh, int64_t v_sb, int64_t v_st,
                            int64_t v_sh, int causal, int window, int prefix,
                            float sscale) {
  constexpr int HD = 64, BK = MMA_BK, STAGES = WG_STAGES;
  extern __shared__ __align__(128) unsigned char wg_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_raw));
  const uint32_t sbase = (raw + 1023) & ~1023u;       // atoms on 1024 bytes
  unsigned char* const smem = wg_raw + (sbase - raw);
  // slot st: K tile at sbase + 2 st WG_TILE, V tile right after it; Q at
  // sbase + WG_Q

  const int bh = blockIdx.x;
  const int b = bh / n_head, h = bh % n_head, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_BQ;  // longest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wg0 = q0 + (warp / 4) * 64;               // the warpgroup's rows
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;     // this thread's rows

  const __nv_bfloat16* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const __nv_bfloat16* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;
  const int k_end = causal ? min(n_key, max(q0 + MMA_BQ, prefix)) : n_key;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int j_beg = window && !prefix ? max(0, q0 - window + 1) / BK : 0;

  auto load = [&](int j, int slot) {
    unsigned char* ks = smem + 2 * slot * WG_TILE;
    unsigned char* vs = ks + WG_TILE;
#pragma unroll
    for (int i = threadIdx.x; i < BK * 8; i += MMA_NT) {
      const int r = i / 8, c = i % 8, key = j * BK + r;
      const bool ok = key < n_key;
      const int off = r * 128 + ((c ^ (r & 7)) << 4);
      cp16(ks + off, ok ? kb + (int64_t)key * k_st + c * 8 : kb, ok ? 16 : 0);
      cp16(vs + off, ok ? vb + (int64_t)key * v_st + c * 8 : vb, ok ? 16 : 0);
    }
  };
  // the Q tile joins tile 0's copies; rows past T are zero-filled
  const __nv_bfloat16* qb = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
#pragma unroll
  for (int i = threadIdx.x; i < MMA_BQ * 8; i += MMA_NT) {
    const int r = i / 8, c = i % 8, row = q0 + r;
    const bool ok = row < n_tok;
    cp16(smem + WG_Q + r * 128 + ((c ^ (r & 7)) << 4),
         ok ? qb + (int64_t)row * q_st + c * 8 : qb, ok ? 16 : 0);
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (j_beg + st < n_tiles) load(j_beg + st, st);
    cp_commit();
  }
  const uint32_t qs = sbase + WG_Q + (warp / 4) * WG_TILE;  // this group's

  float o[32];          // (row g | g+8) x 8-column chunk d: o[4 d + e]
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int j = j_beg; j < n_tiles; ++j) {
    const int it = j - j_beg;         // the ring turns from the band's start
    cp_wait<STAGES - 2>();            // tile j has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                  // ... and every warp is past j-1
    if (j + STAGES - 1 < n_tiles)
      load(j + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_commit();
    const int k0 = j * BK;
    // a warpgroup whose rows all lie past T, all precede the keys, or all
    // see the window end before the tile starts (no prefix key in it)
    if (wg0 >= n_tok ||
        (k0 >= prefix && ((causal && k0 > wg0 + 63) ||
                          (window && k0 + BK - 1 <= wg0 - window))))
      continue;
    const uint32_t ks = sbase + 2 * (it % STAGES) * WG_TILE;
    const uint32_t vs = ks + WG_TILE;

    float s[32];        // S = Q K^T: (row g | g+8) x key chunk nt: s[4 nt + e]
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma64_ss(s, wg_desc(qs + kk * 32), wg_desc(ks + kk * 32), kk);
    wg_commit_wait();
    wg_fence_operand(s, 32);

    if (k0 + BK > n_key ||
        (k0 + BK > prefix && ((causal && k0 + BK - 1 > wg0) ||
                              (window && k0 <= wg0 + 63 - window)))) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + nt * 8 + tig * 2 + e;
          const bool in = key < n_key, pre = key < prefix;
          if (!in || (!pre && ((causal && key > r0) ||
                               (window && key <= r0 - window))))
            s[4 * nt + e] = -CUDART_INF_F;
          if (!in || (!pre && ((causal && key > r1) ||
                               (window && key <= r1 - window))))
            s[4 * nt + 2 + e] = -CUDART_INF_F;
        }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {     // the row's 4 lanes
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float z0 = n0 == -CUDART_INF_F ? 0.f : n0 * sscale;
    const float z1 = n1 == -CUDART_INF_F ? 0.f : n1 * sscale;
    const float a0 = m0 == -CUDART_INF_F ? 0.f : exp2f(fmaf(m0, sscale, -z0));
    const float a1 = m1 == -CUDART_INF_F ? 0.f : exp2f(fmaf(m1, sscale, -z1));
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      o[4 * d] *= a0;
      o[4 * d + 1] *= a0;
      o[4 * d + 2] *= a1;
      o[4 * d + 3] *= a1;
    }
    m0 = n0;
    m1 = n1;

    // P's hi / lo halves as A fragments, 16 keys (two chunks) a k-step
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(s[8 * jj + e], sscale, e < 2 ? -z0 : -z1));
        p[4 + e] = exp2f(fmaf(s[8 * jj + 4 + e], sscale, e < 2 ? -z0 : -z1));
      }
      l0 += p[0] + p[1] + p[4] + p[5];
      l1 += p[2] + p[3] + p[6] + p[7];
      split2(p[0], p[1], hi[jj][0], lo[jj][0]);
      split2(p[2], p[3], hi[jj][1], lo[jj][1]);
      split2(p[4], p[5], hi[jj][2], lo[jj][2]);
      split2(p[6], p[7], hi[jj][3], lo[jj][3]);
    }
    wg_fence_operand(o, 32);
    wg_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const uint64_t dv = wg_desc(vs + jj * 16 * 128);
      wgmma64_rs(o, hi[jj], dv);
      wgmma64_rs(o, lo[jj], dv);
    }
    wg_commit_wait();
    wg_fence_operand(o, 32);
  }
  cp_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float i1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int col = d * 8 + tig * 2;
    if (r0 < n_tok)
      *reinterpret_cast<float2*>(
          out + (((int64_t)b * n_tok + r0) * n_head + h) * HD + col) =
          make_float2(o[4 * d] * i0, o[4 * d + 1] * i0);
    if (r1 < n_tok)
      *reinterpret_cast<float2*>(
          out + (((int64_t)b * n_tok + r1) * n_head + h) * HD + col) =
          make_float2(o[4 * d + 2] * i1, o[4 * d + 3] * i1);
  }
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         float* out, int n_b, int n_tok, int n_key,
                         int n_head, int n_kv, const int64_t* st, int causal,
                         int window, int prefix, cudaStream_t s) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(flash_attn_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WG_SMEM);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  const dim3 grid(n_b * n_head, (n_tok + MMA_BQ - 1) / MMA_BQ);
  const float sscale = 1.4426950408889634f / sqrtf(64.f);
  flash_attn_wgmma_kernel<<<grid, MMA_NT, WG_SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, n_tok, n_key, n_head,
      n_head / n_kv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, window, prefix, sscale);
  return cudaGetLastError();
}

// The tensor-core kernels take bf16 rows of hd 32, 64, 128 or 256 whose K
// and V rows start on 16 bytes (their 16-byte cp.async copies) and whose
// q rows start on 4 bytes (the mma.sync kernel's 32-bit fragment loads;
// the wgmma kernel at hd 64 and the mma.sync kernel at hd 256 copy q as
// K, so they also need q on 16 bytes).
bool mma_ok(const void* q, const void* k, const void* v, int hd,
            const int64_t* st) {
  if (hd != 32 && hd != 64 && hd != 128 && hd != 256) return false;
  const bool q16 = hd == 64 || hd == 256;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
      16 || reinterpret_cast<uintptr_t>(q) % 4)
    return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] % (q16 ? 8 : 2)) return false;
  if (q16 && reinterpret_cast<uintptr_t>(q) % 16) return false;
  for (int i = 3; i < 9; ++i)
    if (st[i] % 8) return false;
  return true;
}

template <typename T, int HDP, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, float* out,
                   int n_b, int n_tok, int n_key, int n_head, int n_kv,
                   int hd, const int64_t* st, int causal, int window,
                   int prefix, cudaStream_t s) {
  const dim3 grid(n_b * n_head, (n_tok + BQ - 1) / BQ);
  // log2(e) / sqrt(hd): scores in base 2, one exp2f each
  const float qscale = 1.4426950408889634f / sqrtf((float)hd);
  flash_attn_kernel<T, HDP, BK><<<grid, BQ * (HDP / DPT), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, n_tok, n_key, n_head, n_head / n_kv, hd,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      window, prefix, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, float* out,
                     int n_b, int n_tok, int n_key, int n_head, int n_kv,
                     int hd, const int64_t* st, int causal, int window,
                     int prefix, cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 32, 64>(q, k, v, out, n_b, n_tok, n_key, n_head,
                             n_kv, hd, st, causal, window, prefix, s);
  if (hd <= 64)
    return launch<T, 64, 64>(q, k, v, out, n_b, n_tok, n_key, n_head,
                             n_kv, hd, st, causal, window, prefix, s);
  if (hd <= 128)
    return launch<T, 128, 32>(q, k, v, out, n_b, n_tok, n_key, n_head,
                              n_kv, hd, st, causal, window, prefix, s);
  return launch<T, 256, 16>(q, k, v, out, n_b, n_tok, n_key, n_head, n_kv,
                            hd, st, causal, window, prefix, s);
}

}  // namespace

// strides: q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh (elements).
// n_tok query rows against n_key keys (equal when causal).  window: 0 for
// none, else (causal only) query t sees keys s with t - window < s <= t.
// prefix: 0 for none, else (causal only) every query also sees the keys
// s < prefix (the prefix-LM's bidirectional prefix).  Returns a CUDA error
// code; *used_mma says which kernel ran.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 float* out, int n_b, int n_tok, int n_key,
                                 int n_head, int n_kv, int hd,
                                 const int64_t* strides, int causal,
                                 int window, int prefix, int bf16,
                                 int* used_mma, void* stream) {
  *used_mma = 0;
  if (n_b == 0 || n_tok == 0) return 0;
  if (window < 0 || prefix < 0 || n_key < 0 || (causal && n_key != n_tok))
    return static_cast<int>(cudaErrorInvalidValue);
  // a prefix that covers every key masks nothing: the non-causal loop
  if (causal && prefix >= n_tok) causal = 0;
  // without a causal mask the window and the prefix mask nothing; a window
  // that covers every key masks nothing either: the unwindowed loop
  if (!causal) window = prefix = 0;
  if (window >= n_tok) window = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16 && mma_ok(q, k, v, hd, strides)) {
    *used_mma = 1;
    switch (hd) {
      case 32:
        err = launch_mma<32>(q, k, v, out, n_b, n_tok, n_key, n_head, n_kv,
                             strides, causal, window, prefix, s);
        break;
      case 64:
        err = launch_wgmma(q, k, v, out, n_b, n_tok, n_key, n_head, n_kv,
                           strides, causal, window, prefix, s);
        break;
      case 128:
        err = launch_mma<128>(q, k, v, out, n_b, n_tok, n_key, n_head, n_kv,
                              strides, causal, window, prefix, s);
        break;
      default:
        err = launch_mma<256>(q, k, v, out, n_b, n_tok, n_key, n_head, n_kv,
                              strides, causal, window, prefix, s);
    }
  } else if (bf16) {
    err = dispatch<__nv_bfloat16>(q, k, v, out, n_b, n_tok, n_key, n_head,
                                  n_kv, hd, strides, causal, window, prefix,
                                  s);
  } else {
    err = dispatch<float>(q, k, v, out, n_b, n_tok, n_key, n_head, n_kv, hd,
                          strides, causal, window, prefix, s);
  }
  return static_cast<int>(err);
}
