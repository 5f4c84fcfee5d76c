// Tile machinery of the f32 FMA routes shared by the flash-attention
// kernels (flash_fwd.cu, flash_bwd.cu); their tensor-core routes build on
// sm90_common.cuh.
//
// Every FMA kernel works on 64-row tiles of one (batch, head) slice of a
// [B, S, H, D] tensor, staged in shared memory as f32, row-major, with a
// padded row (ld = kDP + 1, kDP = D rounded up to 64 or 128). The odd row
// length puts the rows that neighbouring lanes read in neighbouring banks.
// A block has 256 threads as a 16 x 16 grid (tx = lane in a half-warp,
// ty = half-warp index); each thread owns the 4 x 4 outputs at rows
// ty + 16 i and columns tx + 16 j of a 64 x 64 score tile, so a row of the
// tile lives in the 16 lanes of one half-warp and its max and sum are four
// shuffles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd_flash {

constexpr int kTile = 64;        // rows of a q tile or a k tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLdS = kTile + 1;  // padded row of a score tile
constexpr float kNegInf = -1e30f;
constexpr float kMaskedBelow = -5e29f;  // NEG_INF / 2: "masked" test

template <typename T>
struct Vec16;

// 16 bytes of a row -> floats.
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
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
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x;
    out[1] = a.y;
    out[2] = a.z;
    out[3] = a.w;
  }
};

// Rows [row0, row0 + kTile) of one (b, h) slice into a shared tile of
// kTile x (kDP + 1) floats. `src` points at element (b, 0, h, 0); rows are
// `row_stride` elements apart (H * D). Rows >= S and columns >= D read as
// zero. Consecutive threads read consecutive 16-byte pieces of a row.
template <typename T, int kDP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S, size_t row_stride, int D) {
  constexpr int kN = Vec16<T>::kN;
  constexpr int kLd = kDP + 1;
  constexpr int kVecs = kDP / kN;
  for (int e = threadIdx.x; e < kTile * kVecs; e += kThreads) {
    const int r = e / kVecs;
    const int c0 = (e % kVecs) * kN;
    float vals[kN];
    if (row0 + r < S && c0 < D) {
      Vec16<T>::load(src + (size_t)(row0 + r) * row_stride + c0, vals);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) dst[r * kLd + c0 + i] = vals[i];
  }
}

// acc[i][j] += sum_{d < D} A[ty + 16 i][d] * B[tx + 16 j][d]: a 64 x 64
// tile of A . B^T from two row-major shared tiles. The A reads are
// broadcasts within a half-warp; the B reads fall in 16 distinct banks.
template <int kLd>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* A,
                                         const float* B, int D, int tx,
                                         int ty) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{k < kTile} P[ty + 16 i][k] * V[k][tx + 16 j]: a
// 64 x kDP tile of P . V, P a score tile (ld kLdS), V a row-major operand
// tile (ld kDP + 1).
template <int kDP>
__device__ __forceinline__ void tile_pv(float (&acc)[4][kDP / 16],
                                        const float* P, const float* V,
                                        int tx, int ty) {
  constexpr int kLd = kDP + 1;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kLdS + k];
#pragma unroll
    for (int j = 0; j < kDP / 16; ++j) {
      const float v = V[k * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], v, acc[i][j]);
    }
  }
}

// Max and sum over the 16 lanes of a half-warp (one tile row).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Number of k tiles that some row of the q tile starting at local row q0
// can see: all of them without a causal mask; else those up to the tile's
// last row's global position (0 when the whole k block lies in its future).
__device__ __forceinline__ int visible_k_tiles(int q0, int Sq, int Sk,
                                               int q_offset, int k_offset,
                                               int causal) {
  int n_kt = (Sk + kTile - 1) / kTile;
  if (causal) {
    const int last = min(q0 + kTile, Sq) - 1;
    const int visible = q_offset + last - k_offset + 1;  // keys [0, visible)
    n_kt = visible <= 0 ? 0 : min(n_kt, (visible + kTile - 1) / kTile);
  }
  return n_kt;
}

// Shared memory a kernel with `operands` operand tiles and `scores` score
// tiles (plus `extra` floats) needs, in bytes.
template <int kDP>
constexpr size_t smem_bytes(int operands, int scores, int extra) {
  return sizeof(float) *
         ((size_t)operands * kTile * (kDP + 1) + (size_t)scores * kTile * kLdS +
          extra);
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The bf16 element type of the tensor-core routes (sm90_common.cuh).
typedef __nv_bfloat16 bf16;

// The launchers' common argument check: dtype 0 = bfloat16, 1 = float32.
inline bool bad_args(int B, int H, int Sq, int Sk, int D, int dtype) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D % 8 != 0 ||
         D > 128 || (long long)B * H > 65535 || (dtype != 0 && dtype != 1);
}

}  // namespace hvd_flash
