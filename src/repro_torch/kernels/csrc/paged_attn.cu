// One step of paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py::paged_attn, in
// both its bf16/f32 variant and its int8-page variant.  q (B, KV, G, hd);
// k/v pages (P, page_size, KV, hd) f32, bf16 or int8 with per-(page,
// token, kv-head) f32 scales (P, page_size, KV); block_tables (B, P_max)
// int32 physical page ids; lengths (B,) int32.  Output (B, KV, G, hd) f32.
//
// What bounds it on this card: device-memory bytes.  Each live KV row is
// read once and used for G query heads (G = 1 for Qwen1.5-0.5B), so the
// arithmetic is a few flops per byte.
//
// Design.  One block per (request, kv head).  The block reads its own
// block-table row (the TPU's scalar prefetch has no counterpart) and
// loops over LIVE pages only, [max(0, len - window), len) — the TPU grid
// issued copies for dead pages too.  Per page it stages the head's K and
// V rows in shared memory as f32 (int8 rows multiplied by their scale at
// load), computes the G x page_size scores one warp per key row (lanes
// split head_dim, shuffle reduction), and folds them into an f32 online
// softmax: running max m, running sum l and the (G, hd) accumulator,
// scale 1/sqrt(hd) applied to q.  Masked keys score -1e30 exactly as the
// reference does; every live page holds at least one unmasked key.  A
// request of length 0 visits no page and writes exact zeros (0 / 1e-30).
// Nothing assumes G >= 8: the (g, d) accumulator elements are spread
// over the threads, whatever G is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int NWARPS = NT / 32;
constexpr int MAX_ACC = 8;       // G * hd <= NT * MAX_ACC
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename QT, typename PT>
__global__ void __launch_bounds__(NT)
    paged_attn_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                      const PT* __restrict__ vp,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ lengths,
                      float* __restrict__ out, int KV, int G, int hd, int ps,
                      int p_max, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // (G, hd), pre-scaled
  float* ks = qs + G * hd;               // (ps, hd)
  float* vs = ks + ps * hd;              // (ps, hd)
  float* sc = vs + ps * hd;              // (G, ps) scores, then probs
  float* m_run = sc + G * ps;            // (G,)
  float* l_run = m_run + G;              // (G,)
  float* alpha = l_run + G;              // (G,)

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int len = lengths[b];
  const size_t head = ((size_t)b * KV + kvh) * G * hd;
  const bool quantized = k_scale != nullptr;

  for (int e = tid; e < G * hd; e += NT) qs[e] = to_f(q[head + e]) * scale;
  if (tid < G) {
    m_run[tid] = NEG_INF;
    l_run[tid] = 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int j = 0; j < MAX_ACC; ++j) acc[j] = 0.f;

  const int lo = window > 0 ? max(0, len - window) : 0;
  const int p_hi = min((len + ps - 1) / ps, p_max);
  __syncthreads();

  for (int p = lo / ps; p < p_hi; ++p) {
    const int page = block_tables[(size_t)b * p_max + p];
    for (int e = tid; e < ps * hd; e += NT) {
      const int t = e / hd;
      const size_t row = (size_t)page * ps + t;
      const size_t src = (row * KV + kvh) * hd + e % hd;
      float kv = to_f(kp[src]);
      float vv = to_f(vp[src]);
      if (quantized) {
        kv *= k_scale[row * KV + kvh];
        vv *= v_scale[row * KV + kvh];
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    __syncthreads();

    for (int it = warp; it < G * ps; it += NWARPS) {
      const int g = it / ps;
      const int t = it % ps;
      float part = 0.f;
      for (int d = lane; d < hd; d += 32)
        part = fmaf(qs[g * hd + d], ks[t * hd + d], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) {
        const int kpos = p * ps + t;
        const bool ok = kpos < len && kpos >= lo;
        sc[it] = ok ? part : NEG_INF;
      }
    }
    __syncthreads();

    if (tid < G) {
      const int g = tid;
      const float m_prev = m_run[g];
      float m_cur = NEG_INF;
      for (int t = 0; t < ps; ++t) m_cur = fmaxf(m_cur, sc[g * ps + t]);
      const float m_new = fmaxf(m_prev, m_cur);
      float lsum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float pr = expf(sc[g * ps + t] - m_new);
        sc[g * ps + t] = pr;
        lsum += pr;
      }
      const float a = expf(m_prev - m_new);
      alpha[g] = a;
      l_run[g] = l_run[g] * a + lsum;
      m_run[g] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < MAX_ACC; ++j) {
      const int e = tid + NT * j;
      if (e < G * hd) {
        const int g = e / hd;
        const int d = e % hd;
        float s = 0.f;
        for (int t = 0; t < ps; ++t) s = fmaf(sc[g * ps + t], vs[t * hd + d], s);
        acc[j] = acc[j] * alpha[g] + s;
      }
    }
    __syncthreads();                     // the next page reuses ks/vs/sc
  }

#pragma unroll
  for (int j = 0; j < MAX_ACC; ++j) {
    const int e = tid + NT * j;
    if (e < G * hd) out[head + e] = acc[j] / fmaxf(l_run[e / hd], 1e-30f);
  }
}

template <typename QT, typename PT>
void launch(const void* q, const void* kp, const void* vp,
            const void* k_scale, const void* v_scale, const void* bt,
            const void* lengths, void* out, int B, int KV, int G, int hd,
            int ps, int p_max, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (G * hd + 2 * ps * hd + G * ps + 3 * G);
  dim3 grid(KV, B);
  paged_attn_kernel<QT, PT><<<grid, NT, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(bt),
      static_cast<const int*>(lengths), static_cast<float*>(out), KV, G, hd,
      ps, p_max, window, rsqrtf((float)hd));
}

}  // namespace

extern "C" {

// q_kind / page_kind: 0 f32, 1 bf16, 2 int8 (pages only; scales required).
// window <= 0 means no window.  Returns cudaGetLastError().
int paged_attn_launch(const void* q, const void* k_pages, const void* v_pages,
                      const void* k_scale, const void* v_scale,
                      const void* block_tables, const void* lengths,
                      void* out, int B, int KV, int G, int hd, int ps,
                      int p_max, int window, int q_kind, int page_kind,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G * hd > NT * MAX_ACC) return (int)cudaErrorInvalidValue;
#define ARGS q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, \
             out, B, KV, G, hd, ps, p_max, window, s
  if (q_kind == 0 && page_kind == 0)
    launch<float, float>(ARGS);
  else if (q_kind == 1 && page_kind == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(ARGS);
  else if (q_kind == 0 && page_kind == 2)
    launch<float, int8_t>(ARGS);
  else if (q_kind == 1 && page_kind == 2)
    launch<__nv_bfloat16, int8_t>(ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
