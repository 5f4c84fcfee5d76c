// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (horovod_tpu/ops/pallas/
// flash_attention.py, reached through `flash_block_attend`). Same contract:
// q [B, Sq, H, D], k/v [B, Sk, H, D] in bf16 or f32 -> UNNORMALIZED
// o = sum_j exp(s_ij - m_i) v_j in f32 [B, Sq, H, D] plus the row stats
// m (running max) and l (running sum) in f32 [B, H, Sq], with the causal
// mask taken at global positions q_offset + i >= k_offset + j. A row that
// sees no key gives m = -1e30, l = 0 and o = 0 exactly (every
// exp(NEG_INF - NEG_INF) is guarded), so ring attention can merge partials.
//
// Bound: operations. Causal, the kernel does 4 * B * H * D * Sq * Sk / 2
// flops against (3 Sk + Sq) * B * H * D inputs read once, far above the
// card's ~295 flops per byte. What the design does about it:
//   - the TPU's sequential K grid axis (m, l, acc carried in VMEM) becomes a
//     loop inside one block that owns one (b*h, 64-row q tile); m, l and the
//     output accumulator stay in registers for the whole loop, and blocks
//     run in no order;
//   - the loop stops at the last K tile any row of the q tile can see, so
//     the causal forward does about half the work; q tiles are issued
//     heaviest first;
//   - q, k and v are read in their own dtype straight from the [B, S, H, D]
//     strides (16-byte loads, no transpose copy) and converted to f32 once
//     per tile in shared memory; every product accumulates in f32;
//   - any S: the ragged edge of the last tile is masked, not padded.
// Two implementations of the same contract:
//   - bf16 with D <= 64 (the flagship): tensor cores, mma.sync m16n8k16
//     with f32 accumulation; the probabilities P enter the P . V product
//     rounded to bf16 (as the JAX jnp reference's p.astype(v.dtype) does),
//     while m and l stay f32. 4 warps, 16 q rows each.
//   - f32, or D > 64: f32 FMAs on shared-memory tiles, 4 x 4 outputs a
//     thread, 256 threads.
// wgmma, TMA and a pipelined K/V ring are later work.

#include "flash_common.cuh"

namespace hvd_flash {
namespace {

template <typename T, int kDP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int H,
                 int Sq, int Sk, int D, int q_offset, int k_offset,
                 float scale, int causal) {
  constexpr int kLd = kDP + 1;
  constexpr int kNJ = kDP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sP = sV + kTile * kLd;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t rs = (size_t)H * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Sk * H + h) * D;
  const T* vb = v + ((size_t)b * Sk * H + h) * D;

  load_tile<T, kDP>(sQ, qb, q0, Sq, rs, D);
  const int n_kt = visible_k_tiles(q0, Sq, Sk, q_offset, k_offset, causal);

  float m[4], l[4], acc[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's sK, sV, sP are consumed
    load_tile<T, kDP>(sK, kb, k0, Sk, rs, D);
    load_tile<T, kDP>(sV, vb, k0, Sk, rs, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_abt<kLd>(s, sQ, sK, D, tx, ty);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qg = q_offset + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool ok = c < Sk && (!causal || qg >= k_offset + c);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            s[i][j] <= kMaskedBelow ? 0.f : expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * kLdS + tx + 16 * j] = p;
        rsum += p;
      }
      const float alpha = m[i] <= kMaskedBelow ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(rsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_pv<kDP>(acc, sP, sV, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    float* orow = o + ((size_t)(b * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int n = tx + 16 * j;
      if (n < D) orow[n] = acc[i][j];
    }
    if (tx == 0) {
      m_out[(size_t)bh * Sq + r] = m[i];
      l_out[(size_t)bh * Sq + r] = l[i];
    }
  }
}


// Tensor-core version for bf16, D <= 64: 4 warps, warp w owns q rows
// q0 + 16 w .. + 15; each thread holds rows g and g + 8 of its warp's
// slice (g = lane / 4) and the column pairs 2t, 2t + 1 of every 8-column
// score tile (t = lane % 4), so a row's max and sum are two shuffles
// within a quad.
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int H, int Sq, int Sk, int D, int q_offset, int k_offset,
                     float scale, int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kLdH];
  __shared__ __align__(16) bf16 sK[kTile * kLdH];
  __shared__ __align__(16) bf16 sVt[kTile * kLdH];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)H * D;
  const bf16* kb = k + ((size_t)b * Sk * H + h) * D;
  const bf16* vb = v + ((size_t)b * Sk * H + h) * D;
  const int n_kk = (D + 15) / 16;

  copy_tile_bf16(sQ, q + ((size_t)b * Sq * H + h) * D, q0, Sq, rs, D);
  __syncthreads();
  uint32_t qa[4][4];
  load_a_frags(qa, sQ, warp * 16, n_kk, g, t);

  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int n_kt = visible_k_tiles(q0, Sq, Sk, q_offset, k_offset, causal);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int nd = 0; nd < 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's sK and sVt are consumed
    copy_tile_bf16(sK, kb, k0, Sk, rs, D);
    copy_tile_bf16_t(sVt, vb, k0, Sk, rs, D);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    mma_abt(s, qa, sK, n_kk, g, t);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int c = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = c < Sk &&
                        (!causal || q_offset + r0 + 8 * half >= k_offset + c);
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
        mx[half] = fmaxf(mx[half], s[nt][e]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = m[i] <= kMaskedBelow ? 0.f : expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const float p =
            s[nt][e] <= kMaskedBelow ? 0.f : expf(s[nt][e] - m[half]);
        s[nt][e] = p;
        psum[half] += p;
      }
    // l stays a per-thread partial sum (the quad's lanes rescale alike);
    // the quad's partials are added once, at the end.
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + psum[i];
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
    mma_sv(acc, s, sVt, D, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= Sq) continue;
    float* orow = o + ((size_t)(b * Sq + r) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const int d = nd * 8 + 2 * t;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(acc[nd][2 * i], acc[nd][2 * i + 1]);
    }
    if (t == 0) {
      m_out[(size_t)bh * Sq + r] = m[i];
      l_out[(size_t)bh * Sq + r] = l[i];
    }
  }
}

template <typename T, int kDP>
int launch(const void* q, const void* k, const void* v, void* o, void* m,
           void* l, int B, int H, int Sq, int Sk, int D, int q_offset,
           int k_offset, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<kDP>(3, 1, 0);
  auto kernel = flash_fwd_kernel<T, kDP>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), H, Sq, Sk, D, q_offset,
      k_offset, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace hvd_flash

// dtype: 0 = bfloat16, 1 = float32. o [B, Sq, H, D], m and l [B, H, Sq],
// all f32. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* m, void* l, int B, int H, int Sq,
                             int Sk, int D, int q_offset, int k_offset,
                             float scale, int causal, int dtype,
                             void* stream) {
  using namespace hvd_flash;
  if (bad_args(B, H, Sq, Sk, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0 && D <= 64) {
    const dim3 grid((Sq + kTile - 1) / kTile, B * H);
    flash_fwd_mma_kernel<<<grid, kMmaThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<float*>(o),
        static_cast<float*>(m), static_cast<float*>(l), H, Sq, Sk, D,
        q_offset, k_offset, scale, causal);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    return launch<__nv_bfloat16, 128>(q, k, v, o, m, l, B, H, Sq, Sk, D,
                                      q_offset, k_offset, scale, causal, s);
  }
  return D <= 64 ? launch<float, 64>(q, k, v, o, m, l, B, H, Sq, Sk, D,
                                     q_offset, k_offset, scale, causal, s)
                 : launch<float, 128>(q, k, v, o, m, l, B, H, Sq, Sk, D,
                                      q_offset, k_offset, scale, causal, s);
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
