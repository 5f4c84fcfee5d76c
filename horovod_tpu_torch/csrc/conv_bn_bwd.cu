// Fused 1x1-conv + batch-norm statistics, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` (horovod_tpu/ops/pallas/
// conv_bn.py, reached through `_bwd_call` from the custom VJP). Same
// single-pass formulas, on the GEMM view [M, K] x [K, N]:
//   dy_eff  = dy + ds1 + 2 ds2 y            f32, rounded to X's dtype for
//                                           BOTH products
//   g       = dy_eff . W^T                  [M, K], f32 accumulation
//   with the prologue (pre = x inv + shift):
//     dX      = g [pre > 0] inv             stored in X's dtype
//     d_inv   = sum_m g [pre > 0] x         [K] f32
//     d_shift = sum_m g [pre > 0]           [K] f32
//   without it: dX = g
//   dW      = relu(pre)^T (rounded) . dy_eff   [K, N], f32 accumulation over
//                                              M, stored in W's dtype
//
// Bound: bytes on the main path (x, y and dy read, dx written: 4 M-row
// matrices for ~4 M K N flops). The TPU kernel is one streaming pass over
// M with W and the f32 dW accumulator resident in VMEM, accumulating dW,
// d_inv and d_shift across a sequential grid. On Hopper it is two GEMM
// launches that never materialize dy_eff or relu(pre) (both are formed
// while their tiles are staged in shared memory):
//   - dX over (M tiles, K tiles), reduction over N; its epilogue applies the
//     ReLU mask and inv and writes one partial row of d_inv/d_shift per row
//     tile;
//   - dW over (K tiles, N tiles, S splits of M), both operands staged
//     transposed (M is their row index); split s writes its f32 partial dW
//     to part_w[s], since K x N alone gives too few blocks for the card.
// Small launches (reduce_partials) then add the partial rows and the S
// partial dW in a fixed order and round dW to W's dtype: the results are
// the same from run to run (no float atomics). bf16 runs the tensor cores
// (mma.sync m16n8k16), f32 FMAs.

#include "conv_bn_common.cuh"

namespace hvd_convbn {
namespace {

template <typename T>
struct EpiDx {
  T* dx;
  const T* x;
  const float* inv;
  const float* shift;
  float* p1;
  float* p2;
  int cols, prologue;
  __device__ __forceinline__ bool stats() const { return prologue != 0; }
  __device__ __forceinline__ void put(int r, int c, float g, float& s1,
                                      float& s2) const {
    const size_t i = (size_t)r * cols + c;
    if (prologue) {
      const float xv = to_f(x[i]);
      const float pre = __fadd_rn(__fmul_rn(xv, inv[c]), shift[c]);
      const float gm = pre > 0.f ? g : 0.f;
      dx[i] = from_f<T>(__fmul_rn(gm, inv[c]));
      s1 = __fmul_rn(gm, xv);
      s2 = gm;
    } else {
      dx[i] = from_f<T>(g);
    }
  }
};

struct EpiDw {
  float* part;   // [splits, K, N]
  float* p1;     // unused (no column sums)
  float* p2;
  int cols;
  size_t split_stride;
  __device__ __forceinline__ bool stats() const { return false; }
  __device__ __forceinline__ void put(int r, int c, float acc, float&,
                                      float&) const {
    part[blockIdx.z * split_stride + (size_t)r * cols + c] = acc;
  }
};

template <typename T>
int launch(const void* x, const void* w, const void* inv, const void* shift,
           const void* y, const void* dy, const void* ds1, const void* ds2,
           void* dx, void* dw, void* dinv, void* dshift, void* part_x,
           void* part_w, int M, int K, int N, int splits, int prologue,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* fi = static_cast<const float*>(inv);
  const float* fs = static_cast<const float*>(shift);
  SrcDyEff<T> d{static_cast<const T*>(dy), static_cast<const T*>(y),
                static_cast<const float*>(ds1),
                static_cast<const float*>(ds2), M, N};

  // dX = dy_eff . W^T (+ the prologue's mask and partial d_inv, d_shift)
  const int tm = tiles(M, kBM);
  float* px1 = static_cast<float*>(part_x);
  float* px2 = prologue ? px1 + (size_t)tm * K : nullptr;
  SrcPlain<T> wk{static_cast<const T*>(w), K, N};
  EpiDx<T> ex{static_cast<T*>(dx), xt, fi, fs, px1, px2, K, prologue};
  gemm_kernel<T, false, false><<<dim3(tm, tiles(K, kBN), 1), kThreads, 0,
                                 stream>>>(d, wk, ex, M, K, N,
                                           tiles(N, kBK) * kBK);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // dW = relu(pre)^T . dy_eff, split over M
  const int chunk = tiles(tiles(M, splits), kBK) * kBK;
  SrcAct<T> a{xt, fi, fs, M, K, prologue};
  EpiDw ew{static_cast<float*>(part_w), nullptr, nullptr, N,
           (size_t)K * N};
  gemm_kernel<T, true, true><<<dim3(tiles(K, kBM), tiles(N, kBN), splits),
                               kThreads, 0, stream>>>(a, d, ew, K, N, M,
                                                      chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = launch_reduce<T>(static_cast<const float*>(part_w), static_cast<T*>(dw),
                       nullptr, nullptr, splits, K * N, stream);
  if (e != cudaSuccess || !prologue) return (int)e;
  return (int)launch_reduce<float>(px1, static_cast<float*>(dinv), px2,
                                   static_cast<float*>(dshift), tm, K,
                                   stream);
}

}  // namespace
}  // namespace hvd_convbn

// x [M, K], w [K, N] (in x's dtype), inv/shift [K] f32 (null without the
// prologue), y/dy [M, N] in x's dtype, ds1/ds2 [N] f32. Outputs: dx [M, K]
// in x's dtype, dw [K, N] in x's dtype, dinv/dshift [K] f32 (with the
// prologue only). Scratch: part_x [2, ceil(M / 128), K] f32 (with the
// prologue), part_w [splits, K, N] f32. dtype: 0 = bfloat16, 1 = float32.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int hvd_conv_bn_bwd(const void* x, const void* w, const void* inv,
                               const void* shift, const void* y,
                               const void* dy, const void* ds1,
                               const void* ds2, void* dx, void* dw,
                               void* dinv, void* dshift, void* part_x,
                               void* part_w, int M, int K, int N, int splits,
                               int prologue, int dtype, void* stream) {
  using namespace hvd_convbn;
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || splits > 65535 ||
      (dtype != 0 && dtype != 1) || tiles(K, kBN) > 65535 ||
      tiles(N, kBN) > 65535 || (long long)K * N > 0x7fffffffLL ||
      (prologue && (!inv || !shift || !dinv || !dshift || !part_x)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<bf16>(x, w, inv, shift, y, dy, ds1, ds2, dx, dw, dinv,
                            dshift, part_x, part_w, M, K, N, splits,
                            prologue, s)
             : launch<float>(x, w, inv, shift, y, dy, ds1, ds2, dx, dw, dinv,
                             dshift, part_x, part_w, M, K, N, splits,
                             prologue, s);
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
