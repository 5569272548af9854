// One step of paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py::paged_attn, in
// both its bf16/f32 variant and its int8-page variant.  q (B, KV, G, hd);
// k/v pages (P, page_size, KV, hd) f32, bf16 or int8 with per-(page,
// token, kv-head) f32 scales (P, page_size, KV); block_tables (B, P_max)
// int32 physical page ids; lengths (B,) int32.  Output (B, KV, G, hd) f32.
//
// What bounds it on this card: at decode sizes, latency.  The bytes are
// each live K/V row read once (a few MB at batch 8), a fraction of a
// microsecond at 3.35 TB/s; what a step waits on is the chain of
// dependent loads (length, block table, page rows) and the reduction.
//
// Design (flash-decoding over a thread-block cluster).  The pages of one
// (request, kv head) are split over the S blocks of a cluster
// (grid (S, KV x head blocks, B)); S, the pages a split holds and the
// query heads a block holds come from the host's plan
// (kernels/paged_attn.py::plan), which reads shapes only, never lengths.
// Inside a block a lane group of L lanes (a power of two) holds one K/V
// row, E elements a lane (16 bytes of bf16 or int8, 32 of f32), and the
// 128 threads hold NW x 32 / L rows at once.  The block table ids of the
// first rows are loaded beside the length and q, before anything waits.
// Each lane then copies its own slices of its rows with 16-byte cp.async
// into a private stretch of shared memory — a ring of at most two stages
// of `rows` rows — so a stage waits on nothing but the lane's own copies:
// no __syncthreads in the key loop.  A row's score is the lane group's dot
// product, the shuffle rounds of a stage's rows taken together; each group
// keeps its own running (m, l, acc) in registers for the block's heads, in
// base 2 (q pre-scaled by log2(e) / sqrt(hd), exp2f), one exp per row and
// one per stage.  At the end the groups of a warp merge by shuffles, the
// warps of a block through shared memory (one __syncthreads), each
// weighted by 2^(m - max m), and the S blocks of a cluster in rank 0:
// after one split cluster barrier (arrived at the start) every other rank
// pushes its partial into rank 0's shared memory with st.async, counted
// by rank 0's mbarrier, and exits; rank 0 merges the S partials in rank
// order — a fixed order, so the same inputs give the same bits.  Only
// keys in [len - window, len) are scored (the reference scores the rest
// at -1e30, which weighs exactly 0 next to a live key); a split, group or
// warp that sees none keeps m = -inf and l = 0 and weighs 0 in a merge.
// A request with no live key (an idle slot, length 0) writes exact zeros.
// Rows whose slices are not 16-byte aligned (hd not a multiple of E, or
// an offset page pointer) take the same path with scalar loads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 128;          // threads per block
constexpr int NW = NT / 32;
constexpr int ROWS_MAX = 8;      // rows a lane group stages per ring stage
constexpr int MAX_SPLIT = 8;     // blocks of a cluster (portable size)
constexpr int MAX_DEV = 16;
constexpr int SMEM_MAX = 227 * 1024;

// elements of a K/V row one lane holds
template <typename PT>
struct Lane {
  static constexpr int E = sizeof(PT) == 1 ? 16 : 8;
  static constexpr int CH = E * (int)sizeof(PT) / 16;   // 16-byte chunks
  static constexpr int PER = 16 / (int)sizeof(PT);      // elements a chunk
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// 4 bytes global -> shared, zero-filled past src_bytes
__device__ __forceinline__ void cp4(void* dst, const void* src,
                                    int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }
// floats of one head's partial as rank 0 receives it: acc[hd], then m and
// l on 8 bytes
__host__ __device__ inline int row_len(int hd) { return ((hd + 1) & ~1) + 2; }

// dynamic shared memory of one block, in bytes: the K and V ring, the
// int8 scales' ring, the warps' partials, the cluster's partials as rank 0
// receives them and its mbarrier
struct Layout {
  int scales, warps, recv, bar, bytes;
};
__host__ __device__ inline Layout layout(int lane_bytes, int heads, int hd,
                                         int rows, int stages, bool quant,
                                         int split) {
  Layout l;
  const int ring = stages * rows * NT;
  l.scales = align16(ring * lane_bytes * 2);
  l.warps = l.scales + (quant ? align16(ring * 4 * 2) : 0);
  l.recv = l.warps + align16(NW * heads * (hd + 2) * 4);
  l.bar = l.recv + (split > 1 ? align16(split * heads * row_len(hd) * 4) : 0);
  l.bytes = l.bar + 16;
  return l;
}

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* lengths;
  float* out;
  int KV, G, hd, ps, p_max, window;
  int split, pages, rows, stages, lanes, vec;
  float scale;            // log2(e) / sqrt(hd): scores in base 2
};

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
// 4 / 8 bytes into another block's shared memory, counted by its mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float v0, float v1,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(v0), "f"(v1), "r"(bar)
      : "memory");
}

// 2^(m - M): the weight of a partial whose running max is m, 0 if empty
__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.f : exp2f(m - M);
}

template <typename QT, typename PT, int GB>
__global__ void __launch_bounds__(NT) paged_attn_kernel(const Args a) {
  constexpr int E = Lane<PT>::E, CH = Lane<PT>::CH, PER = Lane<PT>::PER;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool quant = a.ks != nullptr;
  const Layout lay = layout(E * (int)sizeof(PT), GB, a.hd, a.rows, a.stages,
                            quant, a.split);
  const int ring = a.stages * a.rows * NT;
  uint4* kst = reinterpret_cast<uint4*>(smem);   // [stage*rows+k][c][tid]
  uint4* vst = kst + ring * CH;
  float* kss = reinterpret_cast<float*>(smem + lay.scales);  // [slot][tid]
  float* vss = kss + ring;
  float* wacc = reinterpret_cast<float*>(smem + lay.warps);  // [w][g][hd]
  float* wml = wacc + NW * GB * a.hd;                        // [w][g][m, l]
  // rank 0's receive buffer: [rank][g][row_len] = acc, m, l
  float* recv = reinterpret_cast<float*>(smem + lay.recv);
  const uint32_t bar =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem + lay.bar));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.lanes, rpw = 32 / L, groups = NW * rpw;
  const int grp = lane / L, gl = lane % L, gid = warp * rpw + grp;
  const int hd = a.hd, ps = a.ps, KV = a.KV, p_max = a.p_max;
  const int S = a.split;
  const int head_blocks = (a.G + GB - 1) / GB;
  const int kvh = blockIdx.y / head_blocks;
  const int g0 = (blockIdx.y % head_blocks) * GB;
  const int gn = min(GB, a.G - g0);
  const int b = blockIdx.z;
  const int rank = S > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t head0 = ((size_t)b * KV + kvh) * a.G + g0;   // first q row
  float* out = a.out + head0 * hd;

  const int len = __ldg(a.lengths + b);
  const QT* q = static_cast<const QT*>(a.q);
  float qf[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = gl * E + e;
      qf[g][e] = g < gn && d < hd
                     ? to_f(q[(head0 + g) * hd + d]) * a.scale
                     : 0.f;
    }
  // the split's rows: key positions [row0, row0 + nrow); lane group gid
  // holds rows gid, gid + groups, ..., K of them, `rows` a ring stage.  A
  // stage's block table ids need no length: stage 0's are loaded beside
  // the length and q, before anything waits
  const int nrow = a.pages * ps;
  const int row0 = rank * nrow;
  const int K = (nrow + groups - 1) / groups;
  const int nb = (K + a.rows - 1) / a.rows;
  const int* btr = a.bt + (size_t)b * p_max + rank * a.pages;
  const int dq = groups / ps, dr = groups % ps;   // a step in (page, slot)
  int i_pg = gid / ps, i_t = gid % ps, i_ri = gid; // the next row fetched
  int page[ROWS_MAX], t[ROWS_MAX], ri[ROWS_MAX];   // the fetched stage
  auto fetch = [&]() {
#pragma unroll
    for (int k = 0; k < ROWS_MAX; ++k) {
      if (k >= a.rows) break;
      ri[k] = i_ri;
      t[k] = i_t;
      page[k] = i_ri < nrow && row0 + i_ri < p_max * ps ? __ldg(btr + i_pg)
                                                         : 0;
      i_ri += groups;
      i_pg += dq;
      i_t += dr;
      if (i_t >= ps) i_t -= ps, ++i_pg;
    }
  };
  fetch();

  const int lo = a.window > 0 ? max(0, len - a.window) : 0;
  const int hi = min(len, p_max * ps);
  if (lo >= hi) {          // no live key (an idle slot): exact zeros; every
    if (rank == 0)         // rank of the cluster exits here
      for (int e = tid; e < gn * hd; e += NT) out[e] = 0.f;
    return;
  }
  if (S > 1) {
    if (rank == 0 && tid == 0) {
      sm90::bar_init(bar, 1);
      sm90::bar_init_fence();
    }
    // completes once every block of the cluster has started (and rank 0
    // has initialised its mbarrier): only then is rank 0 written to
    cluster_arrive_relaxed();
  }

  // each fetched row's slice of K and V (and its scales) into stage st of
  // the lane's ring
  const PT* kp = static_cast<const PT*>(a.kp) + kvh * hd + gl * E;
  const PT* vp = static_cast<const PT*>(a.vp) + kvh * hd + gl * E;
  const size_t rs = (size_t)KV * hd;                // elements a token row
  const bool lane_in = gl * E < hd;
  auto copy = [&](int st) {
#pragma unroll
    for (int k = 0; k < ROWS_MAX; ++k) {
      if (k >= a.rows) break;
      const int kpos = row0 + ri[k];
      const bool live = ri[k] < nrow && kpos >= lo && kpos < hi;
      const bool mine = live && lane_in;
      const size_t row = (size_t)page[k] * ps + t[k];
      const int slot = st * a.rows + k;
      if (a.vec) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          sm90::cp16(&kst[(slot * CH + c) * NT + tid],
                     mine ? kp + row * rs + c * PER : kp, mine ? 16 : 0);
          sm90::cp16(&vst[(slot * CH + c) * NT + tid],
                     mine ? vp + row * rs + c * PER : vp, mine ? 16 : 0);
        }
      } else {
        const PT zero = static_cast<PT>(0.f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const bool in = mine && gl * E + e < hd;
          reinterpret_cast<PT*>(&kst[(slot * CH + e / PER) * NT + tid])
              [e % PER] = in ? kp[row * rs + e] : zero;
          reinterpret_cast<PT*>(&vst[(slot * CH + e / PER) * NT + tid])
              [e % PER] = in ? vp[row * rs + e] : zero;
        }
      }
      if (quant) {
        const size_t si = row * KV + kvh;
        cp4(&kss[slot * NT + tid], live ? a.ks + si : a.ks, live ? 4 : 0);
        cp4(&vss[slot * NT + tid], live ? a.vs + si : a.vs, live ? 4 : 0);
      }
    }
    sm90::cp_commit();
  };
  // one staged row slice as f32 (int8 times its scale)
  auto row_f = [&](const uint4* src, const float* sc, int slot,
                   float (&x)[E]) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const uint4 u = src[(slot * CH + c) * NT + tid];
      const PT* p = reinterpret_cast<const PT*>(&u);
#pragma unroll
      for (int e = 0; e < PER; ++e) x[c * PER + e] = to_f(p[e]);
    }
    if (quant) {
      const float s = sc[slot * NT + tid];
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] *= s;
    }
  };

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  copy(0);
  for (int j = 0; j < nb; ++j) {
    if (j + 1 < nb) {                   // the next stage goes in flight
      fetch();
      copy((j + 1) & 1);
    } else {
      sm90::cp_commit();
    }
    sm90::cp_wait<1>();                 // this lane's stage j has landed
    const int st = j & 1;
    // the stage's scores (each row's dot product, then the shuffle rounds
    // of all rows together), one rescale, then the weighted rows
    float s[GB][ROWS_MAX], mb[GB];
#pragma unroll
    for (int k = 0; k < ROWS_MAX; ++k) {
      if (k >= a.rows) break;
      float x[E];
      row_f(kst, kss, st * a.rows + k, x);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int e = 0; e < E; e += 2) {
          p0 = fmaf(qf[g][e], x[e], p0);
          p1 = fmaf(qf[g][e + 1], x[e + 1], p1);
        }
        s[g][k] = p0 + p1;
      }
    }
    for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < ROWS_MAX; ++k) {
        if (k >= a.rows) break;
#pragma unroll
        for (int g = 0; g < GB; ++g)
          s[g][k] += __shfl_xor_sync(0xffffffffu, s[g][k], off);
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) mb[g] = -INFINITY;
#pragma unroll
    for (int k = 0; k < ROWS_MAX; ++k) {
      if (k >= a.rows) break;
      const int r = gid + (j * a.rows + k) * groups;
      if (r < nrow && row0 + r >= lo && row0 + r < hi)
#pragma unroll
        for (int g = 0; g < GB; ++g) mb[g] = fmaxf(mb[g], s[g][k]);
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mn = fmaxf(m[g], mb[g]);
      if (mn != m[g]) {                 // mn > m[g]: a live row is higher
        const float alpha = weight(m[g], mn);
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
        m[g] = mn;
      }
    }
#pragma unroll
    for (int k = 0; k < ROWS_MAX; ++k) {
      if (k >= a.rows) break;
      const int r = gid + (j * a.rows + k) * groups;
      if (!(r < nrow && row0 + r >= lo && row0 + r < hi)) continue;
      float x[E];
      row_f(vst, vss, st * a.rows + k, x);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float p = exp2f(s[g][k] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, x[e], acc[g][e]);
      }
    }
  }
  sm90::cp_wait<0>();

  // the lane groups of a warp (same gl, same elements): the max by
  // shuffles, each group rescaled to it, then butterfly sums — the same
  // bits in every group
  for (int g = 0; g < GB; ++g) {
    float M = m[g];
    for (int off = L; off < 32; off <<= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float w = weight(m[g], M);
    l[g] *= w;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] *= w;
    m[g] = M;
    for (int off = L; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (gl * E + e < hd)
          wacc[(warp * GB + g) * hd + gl * E + e] = acc[g][e];
      if (gl == 0) {
        wml[(warp * GB + g) * 2] = m[g];
        wml[(warp * GB + g) * 2 + 1] = l[g];
      }
    }
  }
  __syncthreads();

  // the block's partial: the warps weighted to their common max and
  // summed in order; one block a request writes the output, the ranks of
  // a cluster other than 0 push theirs into rank 0's shared memory
  const int rl = row_len(hd), ml = rl - 2;
  uint32_t slot0 = 0, bar0 = 0;         // this rank's slot, rank 0's mbarrier
  if (S > 1) {
    cluster_wait();                     // rank 0's mbarrier is ready
    slot0 = mapa(static_cast<uint32_t>(
                     __cvta_generic_to_shared(recv + rank * GB * rl)), 0);
    bar0 = mapa(bar, 0);
  }
  for (int e = tid; e < gn * hd; e += NT) {
    const int g = e / hd, d = e % hd;
    float mw[NW], M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      mw[w] = wml[(w * GB + g) * 2];
      M = fmaxf(M, mw[w]);
    }
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = weight(mw[w], M);
      Ls += wml[(w * GB + g) * 2 + 1] * c;
      A += wacc[(w * GB + g) * hd + d] * c;
    }
    if (S == 1) {
      out[e] = Ls > 0.f ? A / Ls : 0.f;
    } else if (rank > 0) {
      st_async(slot0 + (g * rl + d) * 4, A, bar0);
      if (d == 0) st_async(slot0 + (g * rl + ml) * 4, M, Ls, bar0);
    } else {
      recv[g * rl + d] = A;
      if (d == 0) recv[g * rl + ml] = M, recv[g * rl + ml + 1] = Ls;
    }
  }
  if (S == 1 || rank > 0) return;

  // rank 0: the cluster's S partials, weighted to their common max and
  // summed in rank order
  if (tid == 0) sm90::bar_expect(bar, (S - 1) * gn * (hd + 2) * 4);
  __syncthreads();                      // rank 0's own partial is written
  sm90::bar_wait(bar, 0);               // and the other ranks' have landed
  for (int e = tid; e < gn * hd; e += NT) {
    const int g = e / hd, d = e % hd;
    float mr[MAX_SPLIT], M = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < S) {
        mr[r] = recv[(r * GB + g) * rl + ml];
        M = fmaxf(M, mr[r]);
      }
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < S) {
        const float c = weight(mr[r], M);
        Ls += recv[(r * GB + g) * rl + ml + 1] * c;
        A += recv[(r * GB + g) * rl + d] * c;
      }
    out[e] = Ls > 0.f ? A / Ls : 0.f;
  }
}

template <typename QT, typename PT, int GB>
cudaError_t run(const Args& a, int B, cudaStream_t stream) {
  static int done[MAX_DEV] = {};
  cudaError_t err = sm90::allow_smem(paged_attn_kernel<QT, PT, GB>, SMEM_MAX,
                                     done, MAX_DEV);
  if (err != cudaSuccess) return err;
  const int smem = layout(Lane<PT>::E * (int)sizeof(PT), GB, a.hd, a.rows,
                          a.stages, a.ks != nullptr, a.split)
                       .bytes;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.split, a.KV * ((a.G + GB - 1) / GB), B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, paged_attn_kernel<QT, PT, GB>, a);
}

// the instance for (q kind, page kind, heads a block)
cudaError_t dispatch(int q_kind, int page_kind, int heads, const Args& a,
                     int B, cudaStream_t s) {
#define PA_HEADS(QT, PT)                                 \
  if (heads == 1) return run<QT, PT, 1>(a, B, s);        \
  if (heads == 2) return run<QT, PT, 2>(a, B, s);        \
  if (heads == 4) return run<QT, PT, 4>(a, B, s);        \
  return cudaErrorInvalidValue;
  if (q_kind == 0 && page_kind == 0) { PA_HEADS(float, float) }
  if (q_kind == 1 && page_kind == 1) { PA_HEADS(__nv_bfloat16, __nv_bfloat16) }
  if (q_kind == 0 && page_kind == 2) { PA_HEADS(float, int8_t) }
  if (q_kind == 1 && page_kind == 2) { PA_HEADS(__nv_bfloat16, int8_t) }
#undef PA_HEADS
  return cudaErrorInvalidValue;
}

bool valid(const Args& a) {
  const int L = a.lanes;
  return a.split >= 1 && a.split <= MAX_SPLIT && a.pages >= 1 &&
         a.rows >= 1 && a.rows <= ROWS_MAX && (a.stages == 1 || a.stages == 2) &&
         L >= 1 && L <= 32 && (L & (L - 1)) == 0;
}

}  // namespace

extern "C" {

// q_kind / page_kind: 0 f32, 1 bf16, 2 int8 (pages only; scales required).
// window <= 0 means no window.  The layout — split (blocks of a cluster),
// pages (per split), heads (query heads a block: 1, 2 or 4), rows (a lane
// group's rows a ring stage), stages (1 or 2), lanes (a K/V row's lanes),
// vec (16-byte copies) — is paged_attn.py::plan's.  Returns the launch's
// error code.
int paged_attn_launch(const void* q, const void* k_pages, const void* v_pages,
                      const void* k_scale, const void* v_scale,
                      const void* block_tables, const void* lengths,
                      void* out, int B, int KV, int G, int hd, int ps,
                      int p_max, int window, int q_kind, int page_kind,
                      int split, int pages, int heads, int rows, int stages,
                      int lanes, int vec, void* stream) {
  const Args a = {q,     k_pages, v_pages, static_cast<const float*>(k_scale),
                  static_cast<const float*>(v_scale),
                  static_cast<const int*>(block_tables),
                  static_cast<const int*>(lengths), static_cast<float*>(out),
                  KV,    G,       hd,      ps,
                  p_max, window,  split,   pages,
                  rows,  stages,  lanes,   vec,
                  1.44269504088896341f / sqrtf((float)hd)};
  if (!valid(a) || (page_kind == 2) != (k_scale != nullptr) ||
      lanes * (page_kind == 2 ? 16 : 8) < hd)   // a row's lanes hold it all
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(q_kind, page_kind, heads, a, B,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
