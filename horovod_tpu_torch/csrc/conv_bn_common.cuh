// GEMM machinery shared by the fused 1x1-conv + batch-norm kernels
// (conv_bn_fwd.cu, conv_bn_bwd.cu).
//
// All three products of the pair are one tiled GEMM, out[R, C] =
// sum_k A[r, k] B[c, k], over a reduction range of k:
//   forward  Y    = relu(X inv + shift) . W      (R = M, C = N, k over K)
//   backward dX   = dy_eff . W^T                 (R = M, C = K, k over N)
//            dW   = relu(X inv + shift)^T dy_eff (R = K, C = N, k over M)
// A block owns a 128 x 128 output tile and walks the reduction in chunks of
// 32. Each chunk of both operands is staged in shared memory with the
// reduction index contiguous (tile[o][k]); an operand whose source keeps
// the reduction index in its rows (the dW product) is transposed while it
// is staged. The staging applies the elementwise transform of the operand
// in f32 (the BN prologue, or the BN-statistics correction of dy) and
// rounds the result to the operand dtype, so the products see exactly the
// rounded values the plain versions feed their matrix products. Elements
// outside the source are zero after the transform.
//
// Two compute paths over the same staging:
//   - bf16: tensor cores, mma.sync m16n8k16 (bf16 x bf16 -> f32); 8 warps as
//     4 (rows) x 2 (cols), each warp a 32 x 64 tile;
//   - f32: FMAs, 256 threads as 16 x 16, each thread 8 x 8 outputs at rows
//     ty + 16 i and columns tx + 16 j.
// Per-column sums of an epilogue (BN statistics, d_inv, d_shift) are
// reduced over the block's rows by shuffles and shared memory in a fixed
// order and written as one partial row per row tile; reduce_partials sums
// the partial rows in a fixed order. No float atomics: results are the same
// from run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hvd_convbn {

constexpr int kBM = 128;          // output rows of a block tile
constexpr int kBN = 128;          // output columns of a block tile
constexpr int kBK = 32;           // reduction chunk
constexpr int kThreads = 256;
constexpr int kLdH = kBK + 8;     // bf16 tile row: 80 bytes, conflict-free
                                  // 32-bit fragment loads, 16-byte aligned
constexpr int kLdF = kBK + 1;     // f32 tile row

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// v[i] = p[i] for i < n, zero from n on (n <= 8; n <= 0 reads nothing). One
// 16-byte load (two for f32) when the eight elements are whole and aligned.
template <typename T>
__device__ __forceinline__ void read8(const T* p, int n, float (&v)[8]) {
  if (n >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    if constexpr (std::is_same<T, bf16>::value) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < n ? to_f(p[i]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Operand sources: load8(r, c, v) gives source elements (r, c .. c + 7) after
// the operand's transform, zero outside [0, rows) x [0, cols). Products and
// sums are written with the _rn intrinsics (no FMA contraction), so they
// round as the plain PyTorch versions' separate operations do.
// ---------------------------------------------------------------------------

// A row-major matrix as it is (W or W^T).
template <typename T>
struct SrcPlain {
  const T* p;
  int rows, cols;
  __device__ __forceinline__ void load8(int r, int c, float (&v)[8]) const {
    const int n = r < rows ? min(8, cols - c) : 0;
    read8(p + (size_t)r * cols + c, n, v);
  }
};

// The conv input X [M, K] with the optional BN prologue
// relu(x * inv + shift) (inv, shift per column, f32).
template <typename T>
struct SrcAct {
  const T* x;
  const float* inv;
  const float* shift;
  int rows, cols, prologue;
  __device__ __forceinline__ void load8(int r, int c, float (&v)[8]) const {
    const int n = r < rows ? min(8, cols - c) : 0;
    read8(x + (size_t)r * cols + c, n, v);
    if (prologue) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = i < n ? fmaxf(__fadd_rn(__fmul_rn(v[i], inv[c + i]),
                                       shift[c + i]), 0.f)
                     : 0.f;
    }
  }
};

// dy_eff = dy + ds1 + 2 ds2 y [M, N]: the cotangent of y plus those of the
// BN statistics s1 = sum(y) and s2 = sum(y^2) (ds1, ds2 per column, f32).
template <typename T>
struct SrcDyEff {
  const T* dy;
  const T* y;
  const float* ds1;
  const float* ds2;
  int rows, cols;
  __device__ __forceinline__ void load8(int r, int c, float (&v)[8]) const {
    const int n = r < rows ? min(8, cols - c) : 0;
    float yv[8];
    read8(dy + (size_t)r * cols + c, n, v);
    read8(y + (size_t)r * cols + c, n, yv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = i < n ? __fadd_rn(__fadd_rn(v[i], ds1[c + i]),
                               __fmul_rn(2.f * ds2[c + i], yv[i]))
                   : 0.f;
  }
};

// ---------------------------------------------------------------------------
// Staging: one reduction chunk of an operand into dst[o * kLd + k], o the
// output index (o0 + o) and k the reduction index (k0 + k). kTrans = false:
// the source's rows are output indices; true: its rows are reduction
// indices (staged transposed). 512 pieces of 8 source columns, 2 a thread.
// Transposed, the lanes of a warp take the 32 reduction rows of one piece,
// so each of their 8 scalar stores covers 64 consecutive bytes of shared
// memory (conflict-free); lanes taking the pieces of one row would all
// store into one bank (o * kLdH is a multiple of 32 words for o % 8 == 0).
// ---------------------------------------------------------------------------

template <typename S>
__device__ __forceinline__ void store8(S* dst, const float (&v)[8]) {
  if constexpr (std::is_same<S, bf16>::value) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = v[i];
  }
}

template <bool kTrans, int kLd, typename S, typename Src>
__device__ __forceinline__ void stage(S* dst, const Src& src, int o0, int k0) {
  constexpr int kPieces = kBM * kBK / 8;
  for (int e = threadIdx.x; e < kPieces; e += kThreads) {
    float v[8];
    if constexpr (!kTrans) {
      const int o = e / (kBK / 8), k = (e % (kBK / 8)) * 8;
      src.load8(o0 + o, k0 + k, v);
      store8(dst + o * kLd + k, v);
    } else {
      const int k = e % kBK, o = (e / kBK) * 8;
      src.load8(k0 + k, o0 + o, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[(o + i) * kLd + k] = from_f<S>(v[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core compute (bf16). Fragment layouts (PTX ISA, mma.m16n8k16), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                     a3 = (g+8, 2t+8..);
//   B (16 x 8, col):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g);
//   C (16 x 8):       c0, c1 = (g, 2t), (g, 2t+1); c2, c3 = (g+8, 2t), (g+8, 2t+1).
// Both staged tiles keep k contiguous, so every fragment register is one
// 32-bit shared-memory load.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[mi][ni] += A . B^T over one staged chunk for warp (wm, wn); n8 tiles
// from n_ni on lie past the output's last column and are skipped.
__device__ __forceinline__ void mma_chunk(float (&acc)[2][8][4], const bf16* sA,
                                          const bf16* sB, int wm, int wn,
                                          int n_ni, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const bf16* p = sA + (wm * 32 + mi * 16 + g) * kLdH + kk + 2 * t;
      a[mi][0] = lds32(p);
      a[mi][1] = lds32(p + 8 * kLdH);
      a[mi][2] = lds32(p + 8);
      a[mi][3] = lds32(p + 8 * kLdH + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      if (ni >= n_ni) continue;
      const bf16* p = sB + (wn * 64 + ni * 8 + g) * kLdH + kk + 2 * t;
      const uint32_t b0 = lds32(p), b1 = lds32(p + 8);
      mma_16816(acc[0][ni], a[0], b0, b1);
      mma_16816(acc[1][ni], a[1], b0, b1);
    }
  }
}

// acc[i][j] += A . B^T over one staged f32 chunk (thread rows ty + 16 i,
// columns tx + 16 j). A reads are half-warp broadcasts; B reads fall in 16
// distinct banks (odd row length).
__device__ __forceinline__ void fma_chunk(float (&acc)[8][8], const float* sA,
                                          const float* sB, int tx, int ty) {
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = sA[(ty + 16 * i) * kLdF + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = sB[(tx + 16 * j) * kLdF + k];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// The GEMM kernel. Grid (row tiles, column tiles, reduction splits); split z
// covers reduction indices [z * red_chunk, min(red_total, (z + 1) * red_chunk)).
// Epi (per output element, inside the output only):
//   epi.put(r, c, acc, st1, st2) stores the element and sets its
//   contributions to two per-column sums; when epi.stats() the block writes
//   the sums over its rows to epi.p1/p2[blockIdx.x * cols + c].
// ---------------------------------------------------------------------------

template <typename T, bool kTransA, bool kTransB, class SrcA, class SrcB,
          class Epi>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(SrcA srcA, SrcB srcB, Epi epi, int rows, int cols, int red_total,
            int red_chunk) {
  const int r0 = blockIdx.x * kBM, c0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * red_chunk;
  const int k_end = min(red_total, k_begin + red_chunk);

  if constexpr (std::is_same<T, bf16>::value) {
    __shared__ __align__(16) bf16 sA[kBM * kLdH];
    __shared__ __align__(16) bf16 sB[kBN * kLdH];
    __shared__ float red[2][4][kBN];  // column sums of the 4 row-warps
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    const int n_ni = max(0, min(8, (cols - c0 - wn * 64 + 7) / 8));
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
      stage<kTransA, kLdH>(sA, srcA, r0, k0);
      stage<kTransB, kLdH>(sB, srcB, c0, k0);
      __syncthreads();
      mma_chunk(acc, sA, sB, wm, wn, n_ni, g, t);
      __syncthreads();
    }
    // epilogue: per-thread column sums over its 4 rows, then over the 8
    // lanes of a column (g), then over the 4 row-warps in shared memory.
    float cs[2][8][2];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + wm * 32 + mi * 16 + g + 8 * (e >> 1);
          const int c = c0 + wn * 64 + ni * 8 + 2 * t + (e & 1);
          float a = 0.f, b = 0.f;
          if (r < rows && c < cols) epi.put(r, c, acc[mi][ni][e], a, b);
          s1[e & 1] += a;
          s2[e & 1] += b;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cs[0][ni][h] = s1[h];
        cs[1][ni][h] = s2[h];
      }
    }
    if (epi.stats()) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = cs[s][ni][h];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g == 0) red[s][wm][wn * 64 + ni * 8 + 2 * t + h] = v;
          }
      __syncthreads();
      if (threadIdx.x < kBN && c0 + threadIdx.x < cols) {
        const int c = threadIdx.x;
        float v1 = 0.f, v2 = 0.f;
        for (int w = 0; w < 4; ++w) {
          v1 += red[0][w][c];
          v2 += red[1][w][c];
        }
        epi.p1[(size_t)blockIdx.x * cols + c0 + c] = v1;
        epi.p2[(size_t)blockIdx.x * cols + c0 + c] = v2;
      }
    }
  } else {
    __shared__ float sA[kBM * kLdF];
    __shared__ float sB[kBN * kLdF];
    // column sums of the 16 thread rows, in sA once the loop is done
    static_assert(2 * 16 * kBN <= kBM * kLdF, "sA holds the column sums");
    float (*red)[16][kBN] = reinterpret_cast<float (*)[16][kBN]>(sA);
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
      stage<kTransA, kLdF>(sA, srcA, r0, k0);
      stage<kTransB, kLdF>(sB, srcB, c0, k0);
      __syncthreads();
      fma_chunk(acc, sA, sB, tx, ty);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s1 = 0.f, s2 = 0.f;
      const int c = c0 + tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + ty + 16 * i;
        float a = 0.f, b = 0.f;
        if (r < rows && c < cols) epi.put(r, c, acc[i][j], a, b);
        s1 += a;
        s2 += b;
      }
      if (epi.stats()) {
        red[0][ty][tx + 16 * j] = s1;
        red[1][ty][tx + 16 * j] = s2;
      }
    }
    if (epi.stats()) {
      __syncthreads();
      if (threadIdx.x < kBN && c0 + threadIdx.x < cols) {
        const int c = threadIdx.x;
        float v1 = 0.f, v2 = 0.f;
        for (int w = 0; w < 16; ++w) {
          v1 += red[0][w][c];
          v2 += red[1][w][c];
        }
        epi.p1[(size_t)blockIdx.x * cols + c0 + c] = v1;
        epi.p2[(size_t)blockIdx.x * cols + c0 + c] = v2;
      }
    }
  }
}

// out_a[c] = sum_r part_a[r][c] (and the same for b when gridDim.y == 2),
// summed in a fixed order: thread (x, y) of a (32, kParts) block takes
// rows y, y + kParts, ... of column blockIdx.x * 32 + x, then row 0 of the
// block adds the kParts partials in order.
constexpr int kParts = 16;

template <typename TOut>
__global__ void __launch_bounds__(32 * kParts)
reduce_partials(const float* __restrict__ part_a, TOut* __restrict__ out_a,
                const float* __restrict__ part_b, TOut* __restrict__ out_b,
                int n_rows, int cols) {
  __shared__ float s[kParts][32];
  const float* part = blockIdx.y == 0 ? part_a : part_b;
  TOut* out = blockIdx.y == 0 ? out_a : out_b;
  const int c = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (c < cols) {
#pragma unroll 4
    for (int r = threadIdx.y; r < n_rows; r += kParts)
      v += part[(size_t)r * cols + c];
  }
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float total = 0.f;
    for (int p = 0; p < kParts; ++p) total += s[p][threadIdx.x];
    out[c] = from_f<TOut>(total);
  }
}

template <typename TOut>
inline cudaError_t launch_reduce(const float* part_a, TOut* out_a,
                                 const float* part_b, TOut* out_b, int n_rows,
                                 int cols, cudaStream_t stream) {
  const dim3 grid((cols + 31) / 32, part_b ? 2 : 1);
  reduce_partials<TOut><<<grid, dim3(32, kParts), 0, stream>>>(
      part_a, out_a, part_b, out_b, n_rows, cols);
  return cudaGetLastError();
}

inline int tiles(int n, int t) { return (n + t - 1) / t; }

// The card's SM count: the grid of the persistent kernels (their sums do
// not depend on it: every partial row is one row tile's).
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    return 132;
  return n;
}

// ---------------------------------------------------------------------------
// The wgmma routes' operand boxes: 64 rows of 64 bf16 (128 bytes a row)
// that TMA writes with 128-byte swizzle (sm90_common.cuh).
// ---------------------------------------------------------------------------

// Byte offset of 16-byte chunk c (8 columns) of row r in a swizzled box.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// relu(x inv + shift) of eight consecutive columns, rounded to bf16.
__device__ __forceinline__ uint4 relu_pre8(uint4 xv, const float* inv,
                                           const float* shift) {
  const float4 i0 = __ldg(reinterpret_cast<const float4*>(inv));
  const float4 i1 = __ldg(reinterpret_cast<const float4*>(inv) + 1);
  const float4 h0 = __ldg(reinterpret_cast<const float4*>(shift));
  const float4 h1 = __ldg(reinterpret_cast<const float4*>(shift) + 1);
  const float iv[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
  const float sv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(xp[i]);
    o[i] = __floats2bfloat162_rn(
        fmaxf(__fadd_rn(__fmul_rn(xf.x, iv[2 * i]), sv[2 * i]), 0.f),
        fmaxf(__fadd_rn(__fmul_rn(xf.y, iv[2 * i + 1]), sv[2 * i + 1]),
              0.f));
  }
  return out;
}

}  // namespace hvd_convbn
