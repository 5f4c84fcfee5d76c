// Probe of the wgmma helpers of horovod_tpu_torch/csrc/sm90_common.cuh
// with the A operand in registers, built by the card tests
// (tests/test_torch_cuda_kernels.py). One block of three warpgroups runs
// the dq product chain of the flash backward over n_tiles tiles of 64
// keys; warpgroup wg owns rows 64 wg .. 64 wg + 63 of x and y:
//   s  = x . k_t^T,  dp = y . v_t^T     (A: x, y from registers; k_t, v_t
//                                         K-major, 128-byte swizzled smem)
//   p  = exp2(s * scale2 - lse2),  ds = p (dp - dd)
//   acc += ds . k_t                      (A: ds from registers; k_t read
//                                         MN-major from the same tile)
// out = acc, f32 [192, 64]. x, y: bf16 [192, 64]; k, v: bf16
// [64 n_tiles, 64]; lse2, dd: f32 [192]. As in the flash kernels, a
// warpgroup multiplies only the tiles its rows see (here warpgroup wg sees
// the first n_tiles - 2 + wg) but takes part in every iteration.
//
// mode 0 builds the x and y fragments from global memory on every tile,
// as the flash kernels build every register A fragment inside the
// iteration that uses it. mode 1 loads them once before the loop and
// carries them across iterations: ptxas of CUDA 12.9 serializes these
// products (C7520, the branch above them) and then allocates the packed
// ds fragments into the registers of the carried y fragments, with
// nothing to reload them, so every tile after the first multiplies
// garbage (see the wgmma_rs note in sm90_common.cuh).

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace {

using namespace hvd_sm90;

constexpr int kWgs = 3;
constexpr int kThreads = 128 * kWgs;

// The A fragments (k16 steps kk) of warp w's 16 rows of row-major [*, 64]
// bf16 rows starting at x.
__device__ __forceinline__ void load_frag(uint32_t (&a)[4][4],
                                          const __nv_bfloat16* x, int w,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * w + g + 8 * (i & 1);
      const int c = 16 * kk + 8 * (i >> 1) + 2 * t;
      a[kk][i] = *reinterpret_cast<const uint32_t*>(x + r * 64 + c);
    }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Tile t of a [*, 64] bf16 tensor into 128-byte swizzled shared memory:
// 16-byte chunk c of row r at chunk c ^ (r % 8), as TMA writes it.
__device__ __forceinline__ void stage(uint8_t* dst,
                                      const __nv_bfloat16* src, int t) {
  for (int c = threadIdx.x; c < 64 * 8; c += kThreads) {
    const int r = c >> 3, ch = c & 7;
    *reinterpret_cast<uint4*>(dst + r * 128 + ((ch ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(src + (size_t)(64 * t + r) * 64 +
                                        8 * ch);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
probe(const __nv_bfloat16* __restrict__ x,
      const __nv_bfloat16* __restrict__ y,
      const __nv_bfloat16* __restrict__ k,
      const __nv_bfloat16* __restrict__ v, const float* __restrict__ lse2,
      const float* __restrict__ dd, float* __restrict__ out, int n_tiles,
      float scale2) {
  extern __shared__ uint8_t raw[];
  uint8_t* ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint8_t* vs = ks + 64 * 128;
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 64 * wg + 16 * w + g;          // rows row0, row0 + 8
  const __nv_bfloat16* xw = x + 64 * wg * 64;
  const __nv_bfloat16* yw = y + 64 * wg * 64;
  const float l[2] = {lse2[row0], lse2[row0 + 8]};
  const float d[2] = {dd[row0], dd[row0 + 8]};
  const uint64_t dk = sw128_desc(ks), dv = sw128_desc(vs);
  const int n_wg = n_tiles - (kWgs - 1) + wg;     // tiles the rows see

  uint32_t xa[4][4], ya[4][4];
  if (kMode != 0) {
    load_frag(xa, xw, w, lane);
    load_frag(ya, yw, w, lane);
  }
  float acc[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();                      // the previous tile is consumed
    stage(ks, k, it);
    stage(vs, v, it);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    uint32_t xu[4][4], yu[4][4];
    if (kMode == 0) {
      load_frag(xu, xw, w, lane);
      load_frag(yu, yw, w, lane);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xu[kk][i] = xa[kk][i];
          yu[kk][i] = ya[kk][i];
        }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    if (it < n_wg) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<0>(s, xu[kk], dk + kk * kKMajorStep);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<0>(dp, yu[kk], dv + kk * kKMajorStep);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(xu);
    fence_regs(yu);
    uint32_t ga[4][4];
    if (it < n_wg) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = (j >> 1) & 1;
        dp[j] = exp2f(fmaf(s[j], scale2, -l[i])) * (dp[j] - d[i]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ga[kk][i] = pack2(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(acc, ga[kk], dk + kk * kMNMajorStep);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ga);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(out + (row0 + 8 * i) * 64 + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hvd_wgmma_rs_probe(int mode, const void* x, const void* y,
                                  const void* k, const void* v,
                                  const void* lse2, const void* dd,
                                  void* out, int n_tiles, float scale2,
                                  void* stream) {
  using T = __nv_bfloat16;
  auto kernel = mode == 0 ? probe<0> : probe<1>;
  kernel<<<1, kThreads, 2 * 64 * 128 + 1024,
           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse2), static_cast<const float*>(dd),
      static_cast<float*>(out), n_tiles, scale2);
  return (int)cudaGetLastError();
}
