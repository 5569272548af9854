// Full-sequence attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attn
// (_flash_kernel): causal or non-causal softmax attention with an f32
// output, never materialising the (T, T) score matrix.  Here it reads the
// model's own layouts through strides: q (B, T, H, hd) and k, v
// (B, T, KV, hd) with head h reading kv head h / (H / KV) (grouped-query
// attention), the last dimension contiguous; the (BH, T, D) signature of
// the TPU kernel is the case H = KV = 1.  The output is (B, T, H, hd) f32,
// contiguous, so the caller's reshape to (B, T, H * hd) is free.
//
// What bounds it on this card: a causal call does 2 B H T^2 hd flops
// (QK^T and PV over the lower triangle) against 3 B T H hd input elements
// and B T H hd f32 outputs — at the prune path's (8 x 2048, 16 heads,
// hd 64) some 500 flops a byte, so it is bound by operations: 69 us on
// the bf16 tensor cores.
//
// Design.  The TPU kernel carries acc / m / l across a sequential kv grid
// axis in VMEM; here the kv axis is a loop inside the block.  One block
// owns one (b, h, 64-row query tile) and stages each 64-key K and V tile
// in shared memory; the running max m and sum l of each query row stay in
// registers, in f32, and are rescaled once per tile.  Scores are kept in
// base 2 (scaled by log2(e) / sqrt(hd)), so every exponential is one
// exp2f.  A causal block's loop ends at its diagonal tile; keys past T and
// above the diagonal are masked to -inf, and the first query tiles
// scheduled are the longest ones.  A row whose keys are all masked keeps
// m = -inf and produces zeros, never NaN (the guard of the reference's
// _sdpa_online).  The ragged last query and kv tiles are masked, never
// padded.  No atomics: the same inputs give the same bits.  Offsets are
// 64-bit: a stacked calibration q holds 268 M elements.
//
// Two kernels, chosen per call on the host:
//
// * flash_attn_mma_kernel — bf16 q/k/v with hd 32, 64 or 128, 16-byte
//   aligned rows (the model's layout): tensor cores through mma.sync
//   m16n8k16 (bf16 in, f32 accumulate).  Each of the 4 warps owns 16
//   query rows; S = Q K^T lands in the mma's accumulator layout, which is
//   also the A-operand layout of P V, so P never leaves registers.  P is
//   split into two bf16 halves (hi = bf16(p), lo = bf16(p - hi)) and both
//   are multiplied by V, so the probabilities keep ~16 bits, as the
//   reference's f32 online softmax keeps them (not the 8 of a bf16
//   rounding).  V's B fragments come from ldmatrix.trans; shared rows
//   are padded by 16 bytes so neither K's 32-bit loads nor ldmatrix
//   conflict on banks.
// * flash_attn_kernel — everything else (f32, other head dims or
//   alignments), on the f32 FMA pipe: each query row is held by
//   TPR = HDP / 32 neighbouring threads, each owning 32 of the head's
//   dimensions in interleaved float4 chunks (no bank conflicts), a
//   partial dot product per key summed over the row's lanes by shuffles.

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

// HDP: the head dimension rounded up to 32, 64 or 128; BK: kv rows per
// shared-memory tile (K and V tiles together stay within 32 KB).
template <typename T, int HDP, int BK>
__global__ void __launch_bounds__(BQ * (HDP / DPT))
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ out,
                      int n_tok, int n_head, int group, int hd,
                      int64_t q_sb, int64_t q_st, int64_t q_sh,
                      int64_t k_sb, int64_t k_st, int64_t k_sh,
                      int64_t v_sb, int64_t v_st, int64_t v_sh,
                      int causal, float qscale) {
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
  const int k_end = causal ? min(n_tok, q0 + BQ) : n_tok;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // stage the tile as f32; neighbouring threads read neighbouring dims
    for (int i = threadIdx.x; i < BK * HDP; i += NT) {
      const int j = i / HDP, d = i % HDP, key = k0 + j;
      const bool ok = key < n_tok && d < hd;
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
      const bool live = key < n_tok && (!causal || key <= qi);
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

template <int HD>
__global__ void __launch_bounds__(128)
    flash_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          float* __restrict__ out, int n_tok, int n_head,
                          int group, int64_t q_sb, int64_t q_st, int64_t q_sh,
                          int64_t k_sb, int64_t k_st, int64_t k_sh,
                          int64_t v_sb, int64_t v_st, int64_t v_sh,
                          int causal, float sscale) {
  constexpr int BK = 64;          // keys per tile
  constexpr int LD = HD + 8;      // padded shared row (16 bytes more)
  constexpr int KS = HD / 16;     // k-steps of QK^T
  constexpr int ND = HD / 8;      // 8-wide output column tiles
  constexpr int CH = HD / 8;      // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 ks[BK][LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK][LD];

  const int bh = blockIdx.x;
  const int b = bh / n_head, h = bh % n_head, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;     // this thread's rows

  // Q as A fragments: reg 0 (row g, cols 2t..), 1 (row g+8), 2 (row g,
  // cols 8+2t..), 3 (row g+8, cols 8+2t..) of each 16-column k-step
  const __nv_bfloat16* qb =
      q + (int64_t)b * q_sb + (int64_t)h * q_sh;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? r1 : r0;
      const int col = kk * 16 + (r >> 1) * 8 + tig * 2;
      const __nv_bfloat16* p = qb + (int64_t)row * q_st + col;
      qa[kk][r] = row < n_tok ? pack2(p[0], p[1]) : pack2(zero, zero);
    }

  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  const __nv_bfloat16* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const __nv_bfloat16* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;
  const uint32_t vs_base = static_cast<uint32_t>(__cvta_generic_to_shared(
      &vs[lane & 15][(lane >> 4) * 8]));
  const int k_end = causal ? min(n_tok, q0 + BQ) : n_tok;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    for (int i = threadIdx.x; i < BK * CH; i += 128) {
      const int j = i / CH, c = (i % CH) * 8, key = k0 + j;
      uint4 kk4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (key < n_tok) {
        kk4 = *reinterpret_cast<const uint4*>(kb + (int64_t)key * k_st + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (int64_t)key * v_st + c);
      }
      *reinterpret_cast<uint4*>(&ks[j][c]) = kk4;
      *reinterpret_cast<uint4*>(&vs[j][c]) = vv4;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kr = &ks[nt * 8 + g][kk * 16 + tig * 2];
        mma16816(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + nt * 8 + tig * 2 + e;
        const bool in = key < n_tok;
        s[nt][e] = (in && (!causal || key <= r0)) ? s[nt][e] * sscale
                                                  : -CUDART_INF_F;
        s[nt][2 + e] = (in && (!causal || key <= r1))
                           ? s[nt][2 + e] * sscale
                           : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {     // the row's 4 lanes
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float z0 = n0 == -CUDART_INF_F ? 0.f : n0;
    const float z1 = n1 == -CUDART_INF_F ? 0.f : n1;
    const float a0 = m0 == -CUDART_INF_F ? 0.f : exp2f(m0 - z0);
    const float a1 = m1 == -CUDART_INF_F ? 0.f : exp2f(m1 - z1);
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[2 * j][e] - (e < 2 ? z0 : z1));
        p[4 + e] = exp2f(s[2 * j + 1][e] - (e < 2 ? z0 : z1));
      }
      l0 += p[0] + p[1] + p[4] + p[5];
      l1 += p[2] + p[3] + p[6] + p[7];
      uint32_t hi[4], lo[4];
      split2(p[0], p[1], hi[0], lo[0]);      // row g,   keys 16j + 2t
      split2(p[2], p[3], hi[1], lo[1]);      // row g+8, keys 16j + 2t
      split2(p[4], p[5], hi[2], lo[2]);      // row g,   keys 16j + 8 + 2t
      split2(p[6], p[7], hi[3], lo[3]);      // row g+8, keys 16j + 8 + 2t
#pragma unroll
      for (int d = 0; d < ND; d += 2) {
        uint32_t v0, v1, v2, v3;
        const uint32_t addr =
            vs_base + (uint32_t)((j * 16 * LD + d * 8) * 2);
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
    __syncthreads();
  }

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
                       float* out, int n_b, int n_tok, int n_head, int n_kv,
                       const int64_t* st, int causal, cudaStream_t s) {
  const dim3 grid(n_b * n_head, (n_tok + BQ - 1) / BQ);
  const float sscale = 1.4426950408889634f / sqrtf((float)HD);
  flash_attn_mma_kernel<HD><<<grid, 128, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, n_tok, n_head,
      n_head / n_kv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, sscale);
  return cudaGetLastError();
}

// The tensor-core kernel takes bf16 rows of hd 32, 64 or 128 whose K and
// V rows start on 16 bytes (its 16-byte tile loads).
bool mma_ok(const void* k, const void* v, int hd, const int64_t* st) {
  if (hd != 32 && hd != 64 && hd != 128) return false;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
      16)
    return false;
  for (int i = 3; i < 9; ++i)
    if (st[i] % 8) return false;
  return true;
}

template <typename T, int HDP, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, float* out,
                   int n_b, int n_tok, int n_head, int n_kv, int hd,
                   const int64_t* st, int causal, cudaStream_t s) {
  const dim3 grid(n_b * n_head, (n_tok + BQ - 1) / BQ);
  // log2(e) / sqrt(hd): scores in base 2, one exp2f each
  const float qscale = 1.4426950408889634f / sqrtf((float)hd);
  flash_attn_kernel<T, HDP, BK><<<grid, BQ * (HDP / DPT), 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, n_tok, n_head, n_head / n_kv, hd,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, float* out,
                     int n_b, int n_tok, int n_head, int n_kv, int hd,
                     const int64_t* st, int causal, cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 32, 64>(q, k, v, out, n_b, n_tok, n_head, n_kv, hd, st,
                             causal, s);
  if (hd <= 64)
    return launch<T, 64, 64>(q, k, v, out, n_b, n_tok, n_head, n_kv, hd, st,
                             causal, s);
  return launch<T, 128, 32>(q, k, v, out, n_b, n_tok, n_head, n_kv, hd, st,
                            causal, s);
}

}  // namespace

// strides: q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh (elements).
// Returns a CUDA error code; *used_mma says which kernel ran.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 float* out, int n_b, int n_tok, int n_head,
                                 int n_kv, int hd, const int64_t* strides,
                                 int causal, int bf16, int* used_mma,
                                 void* stream) {
  *used_mma = 0;
  if (n_b == 0 || n_tok == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16 && mma_ok(k, v, hd, strides)) {
    *used_mma = 1;
    err = hd == 32    ? launch_mma<32>(q, k, v, out, n_b, n_tok, n_head, n_kv,
                                       strides, causal, s)
          : hd == 64  ? launch_mma<64>(q, k, v, out, n_b, n_tok, n_head,
                                       n_kv, strides, causal, s)
                      : launch_mma<128>(q, k, v, out, n_b, n_tok, n_head,
                                        n_kv, strides, causal, s);
  } else if (bf16) {
    err = dispatch<__nv_bfloat16>(q, k, v, out, n_b, n_tok, n_head, n_kv, hd,
                                  strides, causal, s);
  } else {
    err = dispatch<float>(q, k, v, out, n_b, n_tok, n_head, n_kv, hd,
                          strides, causal, s);
  }
  return static_cast<int>(err);
}
