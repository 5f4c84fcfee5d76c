// Fused 1x1-conv + batch-norm statistics, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (horovod_tpu/ops/pallas/
// conv_bn.py, reached through `_fwd_call` and `conv1x1_bn_stats`). Same
// contract on the GEMM view of an NHWC 1x1 conv:
//   Y[M, N] = relu(X inv + shift)[M, K] . W[K, N]
// with f32 accumulation and Y stored in X's dtype; the prologue (optional)
// is computed in f32 and rounded to X's dtype before the product. The
// epilogue gives s1 = sum_m Y and s2 = sum_m Y^2 per column in f32, over the
// STORED (dtype-rounded) Y, so the statistics are those a separate BN pass
// would read back.
//
// Bound: bytes for every ResNet 1x1 conv on the main path. The stage-1
// expand conv (M = 401,408, 64 -> 256, bf16) moves ~257 MB for 13 GFLOP,
// ~51 flops a byte against the card's ~295. What the design does about it:
//   - the normalized activation relu(X inv + shift) is never written: the
//     prologue runs while X is staged in shared memory; the BN statistics
//     pass never re-reads Y: the sums come from the accumulators;
//   - the TPU's sequential ("arbitrary") M grid, which accumulates s1/s2 in
//     VMEM, becomes parallel row tiles that each write one partial row of
//     s1/s2 to an [n_row_tiles, N] f32 buffer; a second small launch
//     (reduce_partials) adds the partial rows in a fixed order, so the sums
//     are the same from run to run (no float atomics);
//   - W is passed transposed ([N, K], prepared by the wrapper with the cast
//     to X's dtype that the JAX wrapper also makes), so both operands stage
//     with K contiguous: 16-byte loads, 32-bit mma fragments;
//   - any M, K, N: the ragged edges are masked in the loads and the stores.
// bf16 runs the tensor cores (mma.sync m16n8k16); f32 (the card-vs-CPU
// check) runs FMAs. cp.async/TMA pipelining and wgmma are later work.

#include "conv_bn_common.cuh"

namespace hvd_convbn {
namespace {

template <typename T>
struct EpiFwd {
  T* y;
  float* p1;
  float* p2;
  int cols;
  __device__ __forceinline__ bool stats() const { return true; }
  __device__ __forceinline__ void put(int r, int c, float acc, float& s1,
                                      float& s2) const {
    const T yc = from_f<T>(acc);
    y[(size_t)r * cols + c] = yc;
    const float v = to_f(yc);
    s1 = v;
    s2 = __fmul_rn(v, v);
  }
};

template <typename T>
int launch(const void* x, const void* wt, const void* inv, const void* shift,
           void* y, void* s1, void* s2, void* part, int M, int K, int N,
           int prologue, cudaStream_t stream) {
  const int tm = tiles(M, kBM);
  float* p1 = static_cast<float*>(part);
  float* p2 = p1 + (size_t)tm * N;
  SrcAct<T> a{static_cast<const T*>(x), static_cast<const float*>(inv),
              static_cast<const float*>(shift), M, K, prologue};
  SrcPlain<T> b{static_cast<const T*>(wt), N, K};
  EpiFwd<T> epi{static_cast<T*>(y), p1, p2, N};
  const dim3 grid(tm, tiles(N, kBN), 1);
  gemm_kernel<T, false, false><<<grid, kThreads, 0, stream>>>(
      a, b, epi, M, N, K, tiles(K, kBK) * kBK);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce<float>(p1, static_cast<float*>(s1), p2,
                                   static_cast<float*>(s2), tm, N, stream);
}

}  // namespace
}  // namespace hvd_convbn

// x [M, K], wt [N, K] (W transposed, in x's dtype), inv/shift [K] f32 (null
// without the prologue), y [M, N] in x's dtype, s1/s2 [N] f32, part
// [2, ceil(M / 128), N] f32 scratch. dtype: 0 = bfloat16, 1 = float32.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int hvd_conv_bn_fwd(const void* x, const void* wt, const void* inv,
                               const void* shift, void* y, void* s1, void* s2,
                               void* part, int M, int K, int N, int prologue,
                               int dtype, void* stream) {
  using namespace hvd_convbn;
  if (M <= 0 || K <= 0 || N <= 0 || (dtype != 0 && dtype != 1) ||
      (prologue && (!inv || !shift)) || tiles(N, kBN) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<bf16>(x, wt, inv, shift, y, s1, s2, part, M, K,
                                   N, prologue, s)
                    : launch<float>(x, wt, inv, shift, y, s1, s2, part, M, K,
                                    N, prologue, s);
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
