// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (horovod_tpu/ops/pallas/flash_attention.py, reached through
// `flash_paged_decode`): one query position per sequence attends over the
// sequence's K/V pages in block-table order, with the online (m, l, acc)
// softmax in f32, positions >= length masked (lengths clamped to
// [0, n_max * page]), pages past the length never read, GQA heads grouped
// as h / (H / KVH), and the output normalized (an empty sequence gives
// exact zeros through the 1e-30 floor on l).
//
// Bound: memory. Each sequence's K and V rows are read once, which is
// sum_b length_b * KVH * D * 2 * sizeof(T) bytes, against about four
// flops per element read; at 3.35 TB/s that is the least time the card can
// take. What the design does about it:
//   - the TPU's sequential page grid axis is split over blocks: each block
//     takes one chunk of `chunk` positions (128 from the wrapper) of one
//     (sequence, KV head), so a long sequence is read by many SMs at once
//     instead of one; it writes the chunk's partial softmax state (m, l,
//     acc) to an f32 scratch, and a second kernel merges the chunks of
//     each (sequence, query head) in chunk order. No atomics, so results
//     are bitwise the same from run to run. The grid is sized from
//     n_max * page, which the host knows; blocks whose chunk starts at or
//     past the sequence's length (read on the card) exit at once, so the
//     host never reads the lengths;
//   - one block per KV head serves its whole group of G = H / KVH query
//     heads (up to 8 at once; a larger group is split into sub-groups of
//     the largest of 8, 4, 2, 1 dividing it): each K/V row is read once per
//     sub-group, once for every G <= 8;
//   - many 16-byte loads in flight: a row of D elements is split over D/8
//     lanes of a warp, 8 elements (16 B of bf16) a lane, neighbouring lanes
//     on neighbouring addresses; each lane group issues the loads of 4 rows
//     (2 for the largest groups) before any arithmetic, so at the flagship's
//     D = 64 a block has its whole 128-row chunk (32 KB of K and V) in
//     flight. Plain vector loads, not TMA: the rows of one KV head in a
//     page are KVH * D elements apart and each page is found through the
//     block table, so a chunk is a gather, not a box;
//   - the scores are in the log2 domain (q scaled by scale * log2(e) once)
//     and the exponentials are ex2.approx.ftz.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using hvd_sm90::ex2;
using hvd_sm90::kLog2e;

constexpr int kThreads = 256;
constexpr int kVec = 8;            // elements per lane per row

// 16 bytes of bf16 (8 elements) or 32 bytes of f32, loaded raw; converted
// to floats only after every load of a round is issued.
template <typename T>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void get(float* out) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void get(float* out) const {
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

// Grid (n_chunks * n_sub, KVH, B), kThreads threads: block (x, kvh, b)
// takes positions [c * chunk, (c + 1) * chunk) of sequence b, c = x %
// n_chunks, for query heads kvh * G + (x / n_chunks) * kG + [0, kG). A lane
// group of `group_lanes` lanes (a power of two >= D / kVec) owns one K/V
// row at a time, kU rows per round; lanes past D / kVec idle in the dot
// products. Writes part[(b, h, c)] = (acc[0..D), m, l), m and the scores
// in log2 units, for every chunk that starts below the length.
template <typename T, int kG, int kU>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages,
                          const int32_t* __restrict__ block_tables,
                          const int32_t* __restrict__ lengths,
                          float* __restrict__ part, int H, int KVH, int D,
                          int page, int n_max, int chunk, int n_chunks,
                          float scale2, int group_lanes) {
  const int c = blockIdx.x % n_chunks, sub = blockIdx.x / n_chunks;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_ctx = n_max * page;
  const int length = min(max(lengths[b], 0), n_ctx);
  const int p0 = c * chunk;
  if (p0 >= length) return;   // the whole block: nothing of it is read
  const int p1 = min(p0 + chunk, length);
  const int h0 = kvh * (H / KVH) + sub * kG;

  const int tid = threadIdx.x;
  const int lane_in_group = tid & (group_lanes - 1);
  const int group = tid / group_lanes;
  const int n_groups = kThreads / group_lanes;
  const int d0 = lane_in_group * kVec;
  const bool lane_active = d0 < D;

  float qv[kG][kVec];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    Row8<T> r;
    if (lane_active)
      r.load(q + ((size_t)b * H + h0 + g) * D + d0);
    else
      r.zero();
    r.get(qv[g]);
#pragma unroll
    for (int i = 0; i < kVec; ++i) qv[g][i] *= scale2;
  }

  float m[kG], l[kG], acc[kG][kVec];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  const int32_t* bt = block_tables + (size_t)b * n_max;
  const size_t row_stride = (size_t)KVH * D;
  const size_t head_off = (size_t)kvh * D + d0;

  // The trip count depends only on the block's chunk, so every lane of
  // every warp runs the same rounds and reaches the same shuffles.
  for (int base = p0; base < p1; base += n_groups * kU) {
    Row8<T> kr[kU], vr[kU];
    bool valid[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int pos = base + u * n_groups + group;
      valid[u] = pos < p1;
      if (valid[u] && lane_active) {
        const int phys = bt[pos / page];
        const size_t off =
            ((size_t)phys * page + (pos % page)) * row_stride + head_off;
        kr[u].load(k_pages + off);
        vr[u].load(v_pages + off);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
    float s[kU][kG];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[kVec];
      kr[u].get(kf);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float part_dot = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          part_dot = fmaf(qv[g][i], kf[i], part_dot);
        for (int o = group_lanes >> 1; o > 0; o >>= 1)
          part_dot += __shfl_xor_sync(0xffffffffu, part_dot, o);
        s[u][g] = valid[u] ? part_dot : -INFINITY;
      }
    }
    float p[kU][kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < kU; ++u) m_new = fmaxf(m_new, s[u][g]);
      // m == -inf: nothing accumulated yet (alpha 0); a row that is not
      // valid contributes p = 0. No exp of (-inf) - (-inf) is taken.
      const float alpha = m[g] == -INFINITY ? 0.f : ex2(m[g] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        p[u][g] = valid[u] ? ex2(s[u][g] - m_new) : 0.f;
        p_sum += p[u][g];
      }
      l[g] = fmaf(l[g], alpha, p_sum);
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[kVec];
      vr[u].get(vf);
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          acc[g][i] = fmaf(p[u][g], vf[i], acc[g][i]);
    }
  }

  // Merge the lane groups' states, one query head at a time, in group
  // order, and write the chunk's partial.
  __shared__ float sm_m[kThreads];
  __shared__ float sm_l[kThreads];
  __shared__ float sm_acc[kThreads * kVec];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g > 0) __syncthreads();   // the previous head's merge has read
    if (lane_in_group == 0) {
      sm_m[group] = m[g];
      sm_l[group] = l[g];
    }
    if (lane_active) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) sm_acc[group * D + d0 + i] = acc[g][i];
    }
    __syncthreads();
    if (tid < D) {
      float mx = -INFINITY;
      for (int j = 0; j < n_groups; ++j) mx = fmaxf(mx, sm_m[j]);
      float o = 0.f, lt = 0.f;
      for (int j = 0; j < n_groups; ++j) {
        const float wj = sm_m[j] == -INFINITY ? 0.f : ex2(sm_m[j] - mx);
        o = fmaf(sm_acc[j * D + tid], wj, o);
        lt = fmaf(sm_l[j], wj, lt);
      }
      float* out = part + (((size_t)b * H + h0 + g) * n_chunks + c) * (D + 2);
      out[tid] = o;
      if (tid == 0) {
        out[D] = lt;
        out[D + 1] = mx;   // finite: the chunk has a row below the length
      }
    }
  }
}

// Grid (H, B), D threads: the chunks of (b, h) below the length, merged in
// chunk order, normalized -> out[b, h, :].
__global__ void __launch_bounds__(256)
paged_decode_merge_kernel(const float* __restrict__ part,
                          const int32_t* __restrict__ lengths,
                          float* __restrict__ out, int H, int D, int chunk,
                          int n_chunks, int n_ctx) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int length = min(max(lengths[b], 0), n_ctx);
  const int n = (length + chunk - 1) / chunk;
  const float* p = part + ((size_t)b * H + h) * n_chunks * (D + 2);
  float mx = -INFINITY;
  for (int c = 0; c < n; ++c) mx = fmaxf(mx, p[c * (D + 2) + D + 1]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < n; ++c) {
    const float w = ex2(p[c * (D + 2) + D + 1] - mx);
    l = fmaf(p[c * (D + 2) + D], w, l);
    o = fmaf(p[c * (D + 2) + d], w, o);
  }
  out[((size_t)b * H + h) * D + d] = o / fmaxf(l, 1e-30f);
}

template <typename T, int kG>
void launch_split(const dim3& grid, cudaStream_t s, const void* q,
                  const void* k_pages, const void* v_pages,
                  const void* block_tables, const void* lengths, float* part,
                  int H, int KVH, int D, int page, int n_max, int chunk,
                  int n_chunks, float scale2, int group_lanes) {
  // Rows in flight per lane group: fewer for the widest query groups,
  // whose q and accumulators take the registers.
  constexpr int kU = kG * sizeof(T) <= 8 ? 4 : 2;
  paged_decode_split_kernel<T, kG, kU><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(lengths), part, H, KVH, D, page, n_max,
      chunk, n_chunks, scale2, group_lanes);
}

template <typename T>
void launch_split_g(int kg, const dim3& grid, cudaStream_t s, const void* q,
                    const void* k_pages, const void* v_pages,
                    const void* block_tables, const void* lengths,
                    float* part, int H, int KVH, int D, int page, int n_max,
                    int chunk, int n_chunks, float scale2,
                    int group_lanes) {
#define HVD_SPLIT(G)                                                        \
  launch_split<T, G>(grid, s, q, k_pages, v_pages, block_tables, lengths,   \
                     part, H, KVH, D, page, n_max, chunk, n_chunks, scale2, \
                     group_lanes)
  switch (kg) {
    case 8: HVD_SPLIT(8); break;
    case 4: HVD_SPLIT(4); break;
    case 2: HVD_SPLIT(2); break;
    default: HVD_SPLIT(1); break;
  }
#undef HVD_SPLIT
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. `part` is f32 scratch of
// B * H * ceil(n_max * page / chunk) * (D + 2) floats, allocated by the
// caller; its contents on entry do not matter. Two launches on `stream`
// (split, merge). Returns cudaGetLastError() after them (0 on success).
extern "C" int hvd_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* lengths, void* out, void* part,
                                int B, int H, int KVH, int D, int page,
                                int n_max, int chunk, float scale, int dtype,
                                void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 ||
      D % kVec != 0 || D > kThreads || page <= 0 || n_max <= 0 ||
      chunk <= 0 || B > 65535 || KVH > 65535 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_ctx = (long long)n_max * page;
  if (n_ctx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_chunks = (int)((n_ctx + chunk - 1) / chunk);
  const int G = H / KVH;
  int kg = 8;
  while (G % kg != 0) kg >>= 1;
  const long long n_x = (long long)n_chunks * (G / kg);
  if (n_x > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int group_lanes = 1;
  while (group_lanes * kVec < D) group_lanes <<= 1;
  const dim3 grid((unsigned)n_x, KVH, B);
  const float scale2 = scale * kLog2e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    launch_split_g<__nv_bfloat16>(kg, grid, s, q, k_pages, v_pages,
                                  block_tables, lengths, p, H, KVH, D, page,
                                  n_max, chunk, n_chunks, scale2,
                                  group_lanes);
  else
    launch_split_g<float>(kg, grid, s, q, k_pages, v_pages, block_tables,
                          lengths, p, H, KVH, D, page, n_max, chunk,
                          n_chunks, scale2, group_lanes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_decode_merge_kernel<<<dim3(H, B), D, 0, s>>>(
      p, static_cast<const int32_t*>(lengths), static_cast<float*>(out), H,
      D, chunk, n_chunks, (int)n_ctx);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
