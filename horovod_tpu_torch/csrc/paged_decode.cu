// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_decode_kernel`
// (horovod_tpu/ops/pallas/flash_attention.py, reached through
// `flash_paged_decode`): one query position per sequence attends over the
// sequence's K/V pages in block-table order, with the online (m, l, acc)
// softmax in f32, positions >= length masked, pages past the length never
// read, GQA heads grouped as h / (H / KVH), and the output normalized in
// the kernel (an empty sequence gives exact zeros through the 1e-30 floor
// on l).
//
// Bound: memory. Each sequence's K and V rows are read once, which is
// sum_b length_b * KVH * D * 2 * sizeof(T) bytes, against about four
// flops per element read; at 3.35 TB/s that is the least time the card can
// take. What the design does about it:
//   - no gather copy: each block reads its own block-table row and loads
//     K/V rows straight from their pool pages;
//   - 16-byte loads: a row of D elements is split over D/8 lanes of one
//     warp, 8 elements (16 B of bf16) per lane, so neighbouring lanes read
//     neighbouring addresses;
//   - four rows in flight per lane group before any arithmetic, to keep
//     more loads outstanding per warp;
//   - the TPU's sequential page grid axis becomes a loop inside the block,
//     and the per-group softmax states merge once, in shared memory, at
//     the end.
// Simple layout: one block of 256 threads per (query head, sequence), so a
// KV head shared by several query heads is read once per query head. One
// block per KV head serving its whole query group, and splitting long
// sequences over several blocks, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;     // elements per lane per row
constexpr int kUnroll = 4;  // rows in flight per lane group

template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
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
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

// grid (H, B), block kThreads. A lane group of `group_lanes` lanes (a
// power of two, >= D / kVec) owns one K/V row at a time; lanes past D / kVec
// idle in the dot product.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ out, int H, int KVH, int D, int page,
                    int n_max, float scale, int group_lanes) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int lane_in_group = tid & (group_lanes - 1);
  const int group = tid / group_lanes;
  const int n_groups = kThreads / group_lanes;
  const int d0 = lane_in_group * kVec;
  const bool lane_active = d0 < D;

  const int n_ctx = n_max * page;
  int length = lengths[b];
  length = length < 0 ? 0 : (length > n_ctx ? n_ctx : length);

  float qv[kVec];
  if (lane_active) {
    Vec8<T>::load(q + ((size_t)b * H + h) * D + d0, qv);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) qv[i] = 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;

  const int32_t* bt = block_tables + (size_t)b * n_max;
  const size_t row_stride = (size_t)KVH * D;
  const size_t head_off = (size_t)kvh * D + d0;
  const int rows_per_iter = n_groups * kUnroll;

  // The trip count depends only on the block's length, so every lane of
  // every warp runs the same iterations and reaches the same shuffles.
  for (int base = 0; base < length; base += rows_per_iter) {
    float kr[kUnroll][kVec];
    float vr[kUnroll][kVec];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * n_groups + group;
      valid[u] = pos < length;
      if (valid[u] && lane_active) {
        const int phys = bt[pos / page];
        const size_t off =
            ((size_t)phys * page + (pos % page)) * row_stride + head_off;
        Vec8<T>::load(k_pages + off, kr[u]);
        Vec8<T>::load(v_pages + off, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          kr[u][i] = 0.f;
          vr[u][i] = 0.f;
        }
      }
    }
    float s[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) part += qv[i] * kr[u][i];
      for (int o = group_lanes >> 1; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      s[u] = valid[u] ? part * scale : -INFINITY;
      m_new = fmaxf(m_new, s[u]);
    }
    // m == -inf: nothing accumulated yet (alpha 0); a row that is not
    // valid contributes p = 0. No exp of (-inf) - (-inf) is ever taken.
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    float p[kUnroll];
    float p_sum = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u] = valid[u] ? expf(s[u] - m_new) : 0.f;
      p_sum += p[u];
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) a += p[u] * vr[u][i];
      acc[i] = a;
    }
    m = m_new;
  }

  // Merge the lane groups' partial softmax states.
  __shared__ float sm_m[kThreads];
  __shared__ float sm_l[kThreads];
  __shared__ float sm_acc[kThreads * kVec];
  if (lane_in_group == 0) {
    sm_m[group] = m;
    sm_l[group] = l;
  }
  if (lane_active) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) sm_acc[group * D + d0 + i] = acc[i];
  }
  __syncthreads();
  if (tid < D) {
    float mx = -INFINITY;
    for (int g = 0; g < n_groups; ++g) mx = fmaxf(mx, sm_m[g]);
    float l_tot = 0.f, o = 0.f;
    for (int g = 0; g < n_groups; ++g) {
      const float w = (sm_m[g] == -INFINITY) ? 0.f : expf(sm_m[g] - mx);
      l_tot += sm_l[g] * w;
      o += sm_acc[g * D + tid] * w;
    }
    out[((size_t)b * H + h) * D + tid] = o / fmaxf(l_tot, 1e-30f);
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int hvd_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* lengths, void* out, int B, int H,
                                int KVH, int D, int page, int n_max,
                                float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || D <= 0 ||
      D % kVec != 0 || D > kThreads || page <= 0 || n_max <= 0 ||
      B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  int group_lanes = 1;
  while (group_lanes * kVec < D) group_lanes <<= 1;
  const dim3 grid(H, B);
  const dim3 block(kThreads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    paged_decode_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages),
        static_cast<const int32_t*>(block_tables),
        static_cast<const int32_t*>(lengths), static_cast<float*>(out), H,
        KVH, D, page, n_max, scale, group_lanes);
  } else if (dtype == 1) {
    paged_decode_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages),
        static_cast<const int32_t*>(block_tables),
        static_cast<const int32_t*>(lengths), static_cast<float*>(out), H,
        KVH, D, page, n_max, scale, group_lanes);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
