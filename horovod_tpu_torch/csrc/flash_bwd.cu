// Flash-attention backward for Hopper (sm_90a): two kernels.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (horovod_tpu/ops/pallas/flash_attention.py, reached through
// `flash_bwd_block`). Same contract: gradients of normalized attention for
// one K/V block against the GLOBAL row stats lse = m + log(max(l, 1e-30))
// and dD = rowsum(do * o), both f32 [B, H, Sq] (dD is computed outside, in
// PyTorch):
//   P_ij  = exp(scale * q_i . k_j - lse_i)   (0 where causally masked)
//   dS_ij = P_ij (do_i . v_j - dD_i)
//   dq_i  = scale * sum_j dS_ij k_j           (hvd_flash_bwd_dq)
//   dk_j  = scale * sum_i dS_ij q_i           (hvd_flash_bwd_dkv)
//   dv_j  = sum_i P_ij do_i                   (hvd_flash_bwd_dkv)
// with the causal mask at global positions q_offset + i >= k_offset + j.
// q/k/v/do in bf16 or f32 -> dq/dk/dv in f32 [B, S, H, D].
//
// Bound: operations. The dq kernel does three products over the visible
// tiles (s, dp, dq), the dk/dv kernel four (s, dp, dv, dk), each recomputing
// s from q and k instead of reading a saved [Sq, Sk] tensor. What the
// design does about it:
//   - no atomics: the dq kernel owns one (b*h, q tile) and loops over the K
//     tiles that tile can see; the dk/dv kernel owns one (b*h, k tile) and
//     loops over the q tiles that can see it. Every sum stays inside one
//     block, so the gradients are the same from run to run;
//   - the causal skip of the forward, on both sides;
//   - P comes from the saved lse (no second max/sum pass), and the
//     accumulators stay in registers across the loop;
//   - inputs are read in their own dtype from the [B, S, H, D] strides and
//     converted to f32 once per tile in shared memory.
// Two implementations of each kernel, as in flash_fwd.cu: tensor cores
// (mma.sync m16n8k16, f32 accumulation) for bf16 with D <= 64, where P and
// dS enter their products rounded to bf16; f32 FMAs on shared-memory tiles
// for f32 or D > 64.

#include "flash_common.cuh"

namespace hvd_flash {
namespace {

template <typename T, int kDP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dD, float* __restrict__ dq,
                    int H, int Sq, int Sk, int D, int q_offset, int k_offset,
                    float scale, int causal) {
  constexpr int kLd = kDP + 1;
  constexpr int kNJ = kDP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * kLd;
  float* sK = sDO + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sS = sV + kTile * kLd;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t rs = (size_t)H * D;
  const T* kb = k + ((size_t)b * Sk * H + h) * D;
  const T* vb = v + ((size_t)b * Sk * H + h) * D;

  load_tile<T, kDP>(sQ, q + ((size_t)b * Sq * H + h) * D, q0, Sq, rs, D);
  load_tile<T, kDP>(sDO, dout + ((size_t)b * Sq * H + h) * D, q0, Sq, rs, D);
  float lse_r[4], dd_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
    dd_r[i] = r < Sq ? dD[(size_t)bh * Sq + r] : 0.f;
  }
  const int n_kt = visible_k_tiles(q0, Sq, Sk, q_offset, k_offset, causal);

  float acc[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's sK, sV, sS are consumed
    load_tile<T, kDP>(sK, kb, k0, Sk, rs, D);
    load_tile<T, kDP>(sV, vb, k0, Sk, rs, D);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    tile_abt<kLd>(s, sQ, sK, D, tx, ty);
    tile_abt<kLd>(dp, sDO, sV, D, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qg = q_offset + q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool ok = c < Sk && (!causal || qg >= k_offset + c);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sS[(ty + 16 * i) * kLdS + tx + 16 * j] = p * (dp[i][j] - dd_r[i]);
      }
    }
    __syncthreads();
    tile_pv<kDP>(acc, sS, sK, tx, ty);  // dq += dS . k
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    float* row = dq + ((size_t)(b * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int n = tx + 16 * j;
      if (n < D) row[n] = acc[i][j] * scale;
    }
  }
}

// Tiles are transposed against the dq kernel: thread rows are keys
// (ty + 16 i of the block's k tile), thread columns are queries.
template <typename T, int kDP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dD, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Sq, int Sk, int D,
                     int q_offset, int k_offset, float scale, int causal) {
  constexpr int kLd = kDP + 1;
  constexpr int kNJ = kDP / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * kLd;
  float* sQ = sV + kTile * kLd;
  float* sDO = sQ + kTile * kLd;
  float* sP = sDO + kTile * kLd;
  float* sS = sP + kTile * kLdS;
  float* sLse = sS + kTile * kLdS;
  float* sDD = sLse + kTile;

  const int k0 = blockIdx.x * kTile;  // causal: tile 0 has the most work
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t rs = (size_t)H * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* db = dout + ((size_t)b * Sq * H + h) * D;

  load_tile<T, kDP>(sK, k + ((size_t)b * Sk * H + h) * D, k0, Sk, rs, D);
  load_tile<T, kDP>(sV, v + ((size_t)b * Sk * H + h) * D, k0, Sk, rs, D);

  // The first q tile holding a row that can see this k tile's first key.
  const int n_qt = (Sq + kTile - 1) / kTile;
  int qt_begin = 0;
  if (causal) {
    const int r0 = k_offset + k0 - q_offset;
    if (r0 > 0) qt_begin = r0 / kTile;
  }

  float gk[4][kNJ], gv[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      gk[i][j] = 0.f;
      gv[i][j] = 0.f;
    }

  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's sQ, sDO, sP, sS are consumed
    load_tile<T, kDP>(sQ, qb, q0, Sq, rs, D);
    load_tile<T, kDP>(sDO, db, q0, Sq, rs, D);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      sLse[threadIdx.x] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
      sDD[threadIdx.x] = r < Sq ? dD[(size_t)bh * Sq + r] : 0.f;
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st[i][j] = 0.f;
        dpt[i][j] = 0.f;
      }
    tile_abt<kLd>(st, sK, sQ, D, tx, ty);   // s^T
    tile_abt<kLd>(dpt, sV, sDO, D, tx, ty); // dp^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = tx + 16 * j;
        const int r = q0 + rl;
        const bool ok = c < Sk && r < Sq &&
                        (!causal || q_offset + r >= k_offset + c);
        const float p = ok ? expf(st[i][j] * scale - sLse[rl]) : 0.f;
        sP[(ty + 16 * i) * kLdS + rl] = p;
        sS[(ty + 16 * i) * kLdS + rl] = p * (dpt[i][j] - sDD[rl]);
      }
    }
    __syncthreads();
    // dv += P^T . do, dk += dS^T . q
#pragma unroll 4
    for (int rr = 0; rr < kTile; ++rr) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = sP[(ty + 16 * i) * kLdS + rr];
        ds[i] = sS[(ty + 16 * i) * kLdS + rr];
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float dov = sDO[rr * kLd + tx + 16 * j];
        const float qv = sQ[rr * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gv[i][j] = fmaf(p[i], dov, gv[i][j]);
          gk[i][j] = fmaf(ds[i], qv, gk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + c) * H + h) * D;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int n = tx + 16 * j;
      if (n < D) {
        dk[off + n] = gk[i][j] * scale;
        dv[off + n] = gv[i][j];
      }
    }
  }
}


// Tensor-core dq for bf16, D <= 64: warp w owns q rows q0 + 16 w .. + 15
// (fragment layout as in flash_fwd.cu).
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dD, float* __restrict__ dq,
                        int H, int Sq, int Sk, int D, int q_offset,
                        int k_offset, float scale, int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kLdH];   // q, then k^T
  __shared__ __align__(16) bf16 sDO[kTile * kLdH];
  __shared__ __align__(16) bf16 sK[kTile * kLdH];
  __shared__ __align__(16) bf16 sV[kTile * kLdH];
  bf16* sKt = sQ;

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
  copy_tile_bf16(sDO, dout + ((size_t)b * Sq * H + h) * D, q0, Sq, rs, D);
  __syncthreads();
  uint32_t qa[4][4], da[4][4];
  load_a_frags(qa, sQ, warp * 16, n_kk, g, t);
  load_a_frags(da, sDO, warp * 16, n_kk, g, t);

  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    lse_r[i] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
    dd_r[i] = r < Sq ? dD[(size_t)bh * Sq + r] : 0.f;
  }
  const int n_kt = visible_k_tiles(q0, Sq, Sk, q_offset, k_offset, causal);
  float acc[8][4];
#pragma unroll
  for (int nd = 0; nd < 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // fragments built / the previous tile is consumed
    copy_tile_bf16(sK, kb, k0, Sk, rs, D);
    copy_tile_bf16_t(sKt, kb, k0, Sk, rs, D);
    copy_tile_bf16(sV, vb, k0, Sk, rs, D);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = 0.f;
        dp[nt][e] = 0.f;
      }
    mma_abt(s, qa, sK, n_kk, g, t);
    mma_abt(dp, da, sV, n_kk, g, t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int c = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = c < Sk &&
                        (!causal || q_offset + r0 + 8 * half >= k_offset + c);
        const float p = ok ? expf(s[nt][e] * scale - lse_r[half]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dd_r[half]);  // dS
      }
    mma_sv(acc, s, sKt, D, g, t);  // dq += dS . k
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= Sq) continue;
    float* row = dq + ((size_t)(b * Sq + r) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const int d = nd * 8 + 2 * t;
      if (d < D)
        *reinterpret_cast<float2*>(row + d) = make_float2(
            acc[nd][2 * i] * scale, acc[nd][2 * i + 1] * scale);
    }
  }
}

// Tensor-core dk/dv for bf16, D <= 64: warp w owns key rows
// k0 + 16 w .. + 15; score tiles are transposed (rows keys, columns
// queries), so lse and dD are read per column from shared memory.
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dD,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Sq, int Sk, int D, int q_offset,
                         int k_offset, float scale, int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kLdH];    // k first, then q
  __shared__ __align__(16) bf16 sDO[kTile * kLdH];   // v first, then do
  __shared__ __align__(16) bf16 sQt[kTile * kLdH];
  __shared__ __align__(16) bf16 sDOt[kTile * kLdH];
  __shared__ float sLse[kTile];
  __shared__ float sDD[kTile];

  const int k0 = blockIdx.x * kTile;  // causal: tile 0 has the most work
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)H * D;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
  const bf16* db = dout + ((size_t)b * Sq * H + h) * D;
  const int n_kk = (D + 15) / 16;

  copy_tile_bf16(sQ, k + ((size_t)b * Sk * H + h) * D, k0, Sk, rs, D);
  copy_tile_bf16(sDO, v + ((size_t)b * Sk * H + h) * D, k0, Sk, rs, D);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, sQ, warp * 16, n_kk, g, t);
  load_a_frags(va, sDO, warp * 16, n_kk, g, t);

  const int c0 = k0 + warp * 16 + g;  // this thread's keys: c0 and c0 + 8
  const int n_qt = (Sq + kTile - 1) / kTile;
  int qt_begin = 0;
  if (causal) {
    const int r0 = k_offset + k0 - q_offset;
    if (r0 > 0) qt_begin = r0 / kTile;
  }
  float gk[8][4], gv[8][4];
#pragma unroll
  for (int nd = 0; nd < 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      gk[nd][e] = 0.f;
      gv[nd][e] = 0.f;
    }

  for (int qt = qt_begin; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // fragments built / the previous tile is consumed
    copy_tile_bf16(sQ, qb, q0, Sq, rs, D);
    copy_tile_bf16_t(sQt, qb, q0, Sq, rs, D);
    copy_tile_bf16(sDO, db, q0, Sq, rs, D);
    copy_tile_bf16_t(sDOt, db, q0, Sq, rs, D);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      sLse[threadIdx.x] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
      sDD[threadIdx.x] = r < Sq ? dD[(size_t)bh * Sq + r] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[nt][e] = 0.f;
        dpt[nt][e] = 0.f;
      }
    mma_abt(st, ka, sQ, n_kk, g, t);    // s^T = k . q^T
    mma_abt(dpt, va, sDO, n_kk, g, t);  // dp^T = v . do^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 8 * (e >> 1);
        const int rl = nt * 8 + 2 * t + (e & 1);
        const int r = q0 + rl;
        const bool ok = c < Sk && r < Sq &&
                        (!causal || q_offset + r >= k_offset + c);
        const float p = ok ? expf(st[nt][e] * scale - sLse[rl]) : 0.f;
        st[nt][e] = p;                              // P^T
        dpt[nt][e] = p * (dpt[nt][e] - sDD[rl]);    // dS^T
      }
    mma_sv(gv, st, sDOt, D, g, t);   // dv += P^T . do
    mma_sv(gk, dpt, sQt, D, g, t);   // dk += dS^T . q
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c0 + 8 * i;
    if (c >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + c) * H + h) * D;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const int d = nd * 8 + 2 * t;
      if (d < D) {
        *reinterpret_cast<float2*>(dk + off + d) = make_float2(
            gk[nd][2 * i] * scale, gk[nd][2 * i + 1] * scale);
        *reinterpret_cast<float2*>(dv + off + d) =
            make_float2(gv[nd][2 * i], gv[nd][2 * i + 1]);
      }
    }
  }
}

template <typename T, int kDP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dD, void* dq, int B, int H, int Sq,
              int Sk, int D, int q_offset, int k_offset, float scale,
              int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<kDP>(4, 1, 0);
  auto kernel = flash_bwd_dq_kernel<T, kDP>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dD),
      static_cast<float*>(dq), H, Sq, Sk, D, q_offset, k_offset, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T, int kDP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dD, void* dk, void* dv, int B,
               int H, int Sq, int Sk, int D, int q_offset, int k_offset,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<kDP>(4, 2, 2 * kTile);
  auto kernel = flash_bwd_dkv_kernel<T, kDP>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sk + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dD),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk, D,
      q_offset, k_offset, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace hvd_flash

// dtype: 0 = bfloat16, 1 = float32 (q, k, v and dout alike); lse and dD f32
// [B, H, Sq]; dq f32 [B, Sq, H, D]. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dD, void* dq, int B, int H,
                                int Sq, int Sk, int D, int q_offset,
                                int k_offset, float scale, int causal,
                                int dtype, void* stream) {
  using namespace hvd_flash;
  if (bad_args(B, H, Sq, Sk, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0 && D <= 64) {
    const dim3 grid((Sq + kTile - 1) / kTile, B * H);
    flash_bwd_dq_mma_kernel<<<grid, kMmaThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dD),
        static_cast<float*>(dq), H, Sq, Sk, D, q_offset, k_offset, scale,
        causal);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, dD, dq, B, H,
                                         Sq, Sk, D, q_offset, k_offset,
                                         scale, causal, s);
  }
  return D <= 64 ? launch_dq<float, 64>(q, k, v, dout, lse, dD, dq, B, H, Sq,
                                        Sk, D, q_offset, k_offset, scale,
                                        causal, s)
                 : launch_dq<float, 128>(q, k, v, dout, lse, dD, dq, B, H,
                                         Sq, Sk, D, q_offset, k_offset, scale,
                                         causal, s);
}

// As hvd_flash_bwd_dq; dk and dv f32 [B, Sk, H, D].
extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dD, void* dk, void* dv, int B,
                                 int H, int Sq, int Sk, int D, int q_offset,
                                 int k_offset, float scale, int causal,
                                 int dtype, void* stream) {
  using namespace hvd_flash;
  if (bad_args(B, H, Sq, Sk, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0 && D <= 64) {
    const dim3 grid((Sk + kTile - 1) / kTile, B * H);
    flash_bwd_dkv_mma_kernel<<<grid, kMmaThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(dD),
        static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk, D,
        q_offset, k_offset, scale, causal);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, dD, dk, dv, B,
                                          H, Sq, Sk, D, q_offset, k_offset,
                                          scale, causal, s);
  }
  return D <= 64 ? launch_dkv<float, 64>(q, k, v, dout, lse, dD, dk, dv, B, H,
                                         Sq, Sk, D, q_offset, k_offset, scale,
                                         causal, s)
                 : launch_dkv<float, 128>(q, k, v, dout, lse, dD, dk, dv, B,
                                          H, Sq, Sk, D, q_offset, k_offset,
                                          scale, causal, s);
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
