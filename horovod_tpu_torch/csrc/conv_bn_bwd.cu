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
// matrices for ~4 M K N flops); the stage 3-4 shapes are near their
// operations bound. The TPU kernel is one streaming pass over M with W and
// the f32 dW accumulator resident in VMEM. Three routes; the wrapper
// (ops/conv_bn.py, bwd_plan) picks one from the shape before the launch:
//
// "fused" (bf16, K and N multiples of 8, K at most 4 boxes of 64 and K x N
// at most 8 boxes of 64 x 64, 4 with the prologue, and a ring of 2 stages
// fitting shared memory: ResNet-50's stage 1 and stage 2's first conv1):
// the TPU kernel's single pass over M. A fixed number of persistent blocks
// (132: the wrapper's constant, not the card's SM count) each walk a
// contiguous range of 64-row tiles with W resident in shared memory and
// their dW partial in registers. Per tile, raw dy, y and x arrive by TMA
// (2-D tensor maps, 128-byte swizzle) into a ring of stages; the four
// warpgroups write dy_eff over dy in place and relu(pre) beside x, as bf16
// in the same swizzled row-major layout; then wgmma reads dy_eff as a
// K-major A (g = dy_eff . W^T, W K-major) and as an MN-major B (dW +=
// relu(pre)^T dy_eff, relu(pre) an MN-major A): one staged tile serves
// both products and nothing is transposed by hand. The dX epilogue takes
// x from the stage, not from device memory, and writes dX through a
// shared-memory box and a TMA store, so x, y and dy cross HBM once.
// Warpgroup w owns g's 64-column tile w and dW tiles w, w + 4; where K is
// one box, warpgroup 0 stages g in f32 over the stage's dead y boxes and
// all 16 warps share the epilogue. No producer warp: the last warp done
// with a stage refills it.
//
// "split" (the other bf16 shapes with K, N multiples of 8: ResNet-50's
// stages 2-4): two launches on the same machinery.
//   - dX: persistent blocks walk 128 x 128 tiles of g, each over N in
//     64-wide chunks (dy, y and W by TMA into a 3-stage ring a producer
//     warp keeps full across tiles), dy_eff formed in place, m64n128k16
//     products; the epilogue applies the mask and inv (x by TMA) and
//     writes one partial row of d_inv/d_shift per 128 rows;
//   - dW: the fused kernel's walk without g, over slices of K x N of at
//     most 8 boxes (the slice that loads the fewest boxes), split over M
//     into at most one wave of 132 blocks.
//
// "mma" (f32, and bf16 with K or N not a multiple of 8): PR 3's design,
// two tiled GEMMs on mma.sync (bf16) or FMAs (f32) that stage their
// operands through registers (conv_bn_common.cuh).
//
// Every route writes partial dW, d_inv and d_shift as f32 rows whose count
// depends only on the shape, and reduce_partials (reduce_few_rows for up
// to 16 dW partials) adds them in a fixed order (no float atomics): the
// results are the same from run to run. Rounding: dy_eff and relu(pre)
// are formed in f32 with the _rn intrinsics (no FMA contraction), as the
// plain version computes them, and rounded to bf16 once; pre uses the same
// __fmul_rn/__fadd_rn, so the ReLU mask equals the plain version's.
// ptxas notes no C75xx for any of these kernels: every wgmma of the walk
// runs unconditionally or behind a fence this source issues (PERF.md).

#include "conv_bn_common.cuh"
#include "sm90_common.cuh"

namespace hvd_convbn {
namespace {

// ---------------------------------------------------------------------------
// The "mma" route (PR 3)
// ---------------------------------------------------------------------------

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
int launch_mma(const void* x, const void* w, const void* inv,
               const void* shift, const void* y, const void* dy,
               const void* ds1, const void* ds2, void* dx, void* part_x,
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
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wgmma routes ("fused" and "split")
// ---------------------------------------------------------------------------

using namespace hvd_sm90;

constexpr uint32_t kBoxBytes = 64 * 64 * 2;  // 64 rows x 64 bf16, swizzled
constexpr int kWalkWgs = 4;
constexpr int kWalkThreads = 128 * kWalkWgs;
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kMaxStages = 4;
// Bytes past the boxes: full barriers, the W barrier, done counters.
constexpr int kWalkTail = 8 * kMaxStages + 8 + 4 * kMaxStages;

// dy_eff of eight consecutive columns (col .. col + 7) from raw bf16 dy and
// y, rounded to bf16.
__device__ __forceinline__ uint4 dy_eff8(uint4 dv, uint4 yv,
                                         const float* ds1, const float* ds2) {
  const float4 a0 = __ldg(reinterpret_cast<const float4*>(ds1));
  const float4 a1 = __ldg(reinterpret_cast<const float4*>(ds1) + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(ds2));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(ds2) + 1);
  const float s1[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float s2[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const __nv_bfloat162* d = reinterpret_cast<const __nv_bfloat162*>(&dv);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&yv);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 df = __bfloat1622float2(d[i]);
    const float2 yf = __bfloat1622float2(y[i]);
    const float e0 = __fadd_rn(__fadd_rn(df.x, s1[2 * i]),
                               __fmul_rn(2.f * s2[2 * i], yf.x));
    const float e1 = __fadd_rn(__fadd_rn(df.y, s1[2 * i + 1]),
                               __fmul_rn(2.f * s2[2 * i + 1], yf.y));
    o[i] = __floats2bfloat162_rn(e0, e1);
  }
  return out;
}

// The walk: one block's plan. Block (split, slice) walks the 64-row tiles
// [split * tiles / splits, (split + 1) * tiles / splits) over K columns
// [k0, k0 + 64 kts) and N columns [n0, n0 + 64 nts), slice = ks * n_slices
// + ns with k0 = 64 kts ks, n0 = 64 nts ns. With g (the fused route) the
// slice is the whole of K and N.
struct WalkPlan {
  int M, K, N;
  int kts, nts, n_slices;
  int tiles, splits, stages;
};

// Shared memory of the walk, from a 1024-aligned base, in boxes: W (kts x
// nts, with g only), then `stages` stages of [dy_eff (over dy) x nts, y x
// nts, x x kts, relu(pre) x kts (with the prologue)], then (with g) one dX
// staging box per g tile, then the barriers.
__host__ __device__ inline int walk_stage_boxes(int kts, int nts, int pro) {
  return 2 * nts + (pro ? 2 : 1) * kts;
}

inline size_t walk_smem_bytes(const WalkPlan& p, bool with_g, int pro) {
  const int once = with_g ? p.kts * p.nts + p.kts : 0;
  return 1024 + (size_t)kBoxBytes *
                    (once + p.stages * walk_stage_boxes(p.kts, p.nts, pro)) +
         kWalkTail;
}

// Lane 0 of a warp: TMA copies of tile `tile` (dy, y over the N slice, x
// over the K slice) into stage buffer sb, counted on `bar`. Boxes that
// would start past N or K (a slice's last) are not loaded: forming writes
// zeros there, and the products' rows and columns there are not stored.
__device__ __forceinline__ void walk_fill(
    uint8_t* sb, uint64_t* bar, const CUtensorMap* tm_dy,
    const CUtensorMap* tm_y, const CUtensorMap* tm_x, int kts, int nts,
    int k0, int n0, int K, int N, long long tile) {
  const int row = (int)(tile * 64);
  const int nb = min(nts, (N - n0 + 63) / 64), kb = min(kts, (K - k0 + 63) / 64);
  mbar_arrive_expect_tx(bar, (uint32_t)(2 * nb + kb) * kBoxBytes);
  for (int b = 0; b < nb; ++b) {
    tma_load_2d(sb + b * kBoxBytes, tm_dy, bar, n0 + 64 * b, row);
    tma_load_2d(sb + (nts + b) * kBoxBytes, tm_y, bar, n0 + 64 * b, row);
  }
  for (int b = 0; b < kb; ++b)
    tma_load_2d(sb + (2 * nts + b) * kBoxBytes, tm_x, bar, k0 + 64 * b, row);
}

// kG: also g, dX and (with kPro) d_inv/d_shift (the fused route). kDT: dW
// tiles of 64 x 64 per warpgroup (tile w + 4 j of the slice's kts x nts;
// a warpgroup past the last tile multiplies tile 0 again and drops the
// result, so no wgmma sits in a branch). kSpread (kts == 1, nts >= 2):
// warpgroup 0 alone computes g, so it stages g in f32 over the stage's
// dead y boxes and all 16 warps share the dX epilogue, 8 columns of one
// row each.
template <int kDT, bool kG, bool kPro, bool kSpread>
__global__ void __launch_bounds__(kWalkThreads, 1)
walk_kernel(const __grid_constant__ CUtensorMap tm_dy,
            const __grid_constant__ CUtensorMap tm_y,
            const __grid_constant__ CUtensorMap tm_x,
            const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_dx,
            const float* __restrict__ inv, const float* __restrict__ shift,
            const float* __restrict__ ds1, const float* __restrict__ ds2,
            float* __restrict__ part_w, float* __restrict__ part_x,
            WalkPlan p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kts = p.kts, nts = p.nts;
  const int w_boxes = kG ? kts * nts : 0;
  const int sboxes = walk_stage_boxes(kts, nts, kPro);
  uint8_t* wsm = base;
  uint8_t* stage0 = base + (size_t)w_boxes * kBoxBytes;
  uint8_t* dxs = stage0 + (size_t)p.stages * sboxes * kBoxBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(dxs + (kG ? kts : 0) * kBoxBytes);
  uint64_t* wbar = full + kMaxStages;
  uint32_t* done = reinterpret_cast<uint32_t*>(wbar + 1);

  const int split = blockIdx.x;
  const int k0 = (blockIdx.y / p.n_slices) * kts * 64;
  const int n0 = (blockIdx.y % p.n_slices) * nts * 64;
  const long long t_begin = (long long)split * p.tiles / p.splits;
  const long long t_end = (long long)(split + 1) * p.tiles / p.splits;
  const int n_it = (int)(t_end - t_begin);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warpgroup_uniform();
  const int wq = warp & 3, g = lane >> 2, q = lane & 3;
  const bool has_g = kG && wg < kts;
  const bool store_thread = has_g && (threadIdx.x & 127) == 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxStages; ++i) {
      mbar_init(&full[i], 1);
      done[i] = 0;
    }
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (kG) {
      mbar_arrive_expect_tx(wbar, (uint32_t)w_boxes * kBoxBytes);
      for (int kt = 0; kt < kts; ++kt)
        for (int nt = 0; nt < nts; ++nt)
          tma_load_2d(wsm + (kt * nts + nt) * kBoxBytes, &tm_w, wbar,
                      n0 + 64 * nt, k0 + 64 * kt);
    }
    for (int st = 0; st < min(p.stages, n_it); ++st)
      walk_fill(stage0 + (size_t)st * sboxes * kBoxBytes, &full[st], &tm_dy,
                &tm_y, &tm_x, kts, nts, k0, n0, p.K, p.N, t_begin + st);
  }

  float acc_g[32];
  float acc_w[kDT][32];
  // d_inv/d_shift sums: this thread's 16 columns of g's tile, or (kSpread)
  // the 8 columns of its epilogue chunk.
  float s_inv[16], s_shift[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc_g[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDT; ++j) acc_w[j][i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) s_inv[i] = s_shift[i] = 0.f;
  if (kG) mbar_wait(wbar, 0);

  // Forming: warp w takes logical chunk w % 8 (8 columns) of rows
  // 32 (w / 8) + lane of every box; the 8 lanes of a quarter-warp hit 8
  // distinct chunks of their rows (the swizzle), and ds1/ds2/inv/shift
  // loads are the same address across the warp.
  const int fc = warp & 7;
  const int fr = 32 * (warp >> 3) + lane;
  const uint32_t foff = swz(fr, fc);

  for (int it = 0; it < n_it; ++it) {
    const int st = it % p.stages;
    const int m0 = (int)((t_begin + it) * 64);
    uint8_t* sb = stage0 + (size_t)st * sboxes * kBoxBytes;
    mbar_wait(&full[st], (it / p.stages) & 1);
    const bool row_ok = m0 + fr < p.M;
    for (int b = 0; b < nts; ++b) {
      const int col = n0 + 64 * b + 8 * fc;
      uint4* pe = reinterpret_cast<uint4*>(sb + b * kBoxBytes + foff);
      const uint4 yv =
          *reinterpret_cast<const uint4*>(sb + (nts + b) * kBoxBytes + foff);
      uint4 ev = make_uint4(0u, 0u, 0u, 0u);
      if (row_ok && col < p.N) ev = dy_eff8(*pe, yv, ds1 + col, ds2 + col);
      *pe = ev;  // rows past M and columns past N: zero
    }
    if (kPro) {
      for (int b = 0; b < kts; ++b) {
        const int col = k0 + 64 * b + 8 * fc;
        const uint4 xv = *reinterpret_cast<const uint4*>(
            sb + (2 * nts + b) * kBoxBytes + foff);
        uint4 rv = make_uint4(0u, 0u, 0u, 0u);
        if (col < p.K) rv = relu_pre8(xv, inv + col, shift + col);
        *reinterpret_cast<uint4*>(sb + (2 * nts + kts + b) * kBoxBytes +
                                  foff) = rv;
      }
    }
    fence_proxy_async();
    named_bar_sync(1, kWalkThreads);

    if (has_g) {
      // g[:, tile wg] = dy_eff . W[tile wg rows]^T: both K-major. The
      // fence heads every box: a loop of wgmma over a count the compiler
      // does not know gets one injected there otherwise (ptxas C7519).
      for (int b = 0; b < nts; ++b) {
        wgmma_fence();
        const uint64_t ad = sw128_desc(sb + b * kBoxBytes);
        const uint64_t bd = sw128_desc(wsm + (wg * nts + b) * kBoxBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(acc_g, ad + kk * kKMajorStep, bd + kk * kKMajorStep,
                      (b | kk) != 0);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      // dW[tile kt, nt] += relu(pre)[:, kt]^T dy_eff[:, nt]: both MN-major
      const int idx0 = wg + kWalkWgs * j;
      const int idx = idx0 < kts * nts ? idx0 : 0;
      const int kt = idx / nts, nt = idx % nts;
      const int abox = 2 * nts + (kPro ? kts : 0) + kt;
      const uint64_t ad = sw128_desc(sb + abox * kBoxBytes);
      const uint64_t bd = sw128_desc(sb + nt * kBoxBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(acc_w[j], ad + kk * kMNMajorStep,
                       bd + kk * kMNMajorStep, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_g);
#pragma unroll
    for (int j = 0; j < kDT; ++j) fence_regs(acc_w[j]);

    if (kSpread) {
      // g (warpgroup 0) to f32 over the y boxes: row r at 256 r, 16-byte
      // chunk c4 at (c4 ^ (r % 8)) * 16. Then thread t takes 8 columns
      // (chunk t % 8) of row t / 8.
      uint8_t* gs = sb + nts * kBoxBytes;
      if (has_g) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rl = 16 * wq + g + 8 * i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int cl = 8 * j + 2 * q;
            *reinterpret_cast<float2*>(
                gs + rl * 256 + (((cl >> 2) ^ (rl & 7)) << 4) +
                ((cl & 3) << 2)) =
                make_float2(acc_g[4 * j + 2 * i], acc_g[4 * j + 2 * i + 1]);
          }
        }
      }
      if (store_thread) bulk_wait_read<0>();  // the last store read dxs
      named_bar_sync(1, kWalkThreads);
      const int er = threadIdx.x >> 3, ec = threadIdx.x & 7;
      const float4 ga = *reinterpret_cast<const float4*>(
          gs + er * 256 + (((2 * ec) ^ (er & 7)) << 4));
      const float4 gb = *reinterpret_cast<const float4*>(
          gs + er * 256 + (((2 * ec + 1) ^ (er & 7)) << 4));
      float o[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const int c = k0 + 8 * ec;
      if (kPro && c < p.K) {
        const uint4 xr = *reinterpret_cast<const uint4*>(
            sb + 2 * nts * kBoxBytes + swz(er, ec));
        const __nv_bfloat162* xp =
            reinterpret_cast<const __nv_bfloat162*>(&xr);
        const float4 i0 = __ldg(reinterpret_cast<const float4*>(inv + c));
        const float4 i1 = __ldg(reinterpret_cast<const float4*>(inv + c) + 1);
        const float4 h0 = __ldg(reinterpret_cast<const float4*>(shift + c));
        const float4 h1 =
            __ldg(reinterpret_cast<const float4*>(shift + c) + 1);
        const float iv[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
        const float sv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float2 xf = __bfloat1622float2(xp[e / 2]);
          const float xv = (e & 1) ? xf.y : xf.x;
          const float gm =
              __fadd_rn(__fmul_rn(xv, iv[e]), sv[e]) > 0.f ? o[e] : 0.f;
          s_inv[e] += __fmul_rn(gm, xv);
          s_shift[e] += gm;
          o[e] = __fmul_rn(gm, iv[e]);
        }
      }
      uint4 packed;
      __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pk[e] = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
      *reinterpret_cast<uint4*>(dxs + swz(er, ec)) = packed;
      fence_proxy_async();
      named_bar_sync(1, kWalkThreads);
      if (store_thread) {
        tma_store_2d(&tm_dx, dxs, k0, m0);
        bulk_commit();
      }
    } else if (has_g) {
      // dX (and the d_inv/d_shift sums) of g's tile wg: thread rows
      // 16 wq + g + 8 i, columns 8 j + 2 q + (0, 1) of the tile; x from
      // the stage. dX goes to the warpgroup's staging box, swizzled as the
      // tiles are, and out by one TMA store (rows past M and columns past
      // K are not written); the previous tile's store has read the box
      // first.
      const uint8_t* xbox = sb + (2 * nts + wg) * kBoxBytes;
      uint8_t* stg = dxs + wg * kBoxBytes;
      if (store_thread) bulk_wait_read<0>();
      named_bar_sync(2 + wg, 128);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 16 * wq + g + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = k0 + 64 * wg + 8 * j + 2 * q;
          float g0 = acc_g[4 * j + 2 * i], g1 = acc_g[4 * j + 2 * i + 1];
          if (kPro && c < p.K) {
            const float2 xf = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xbox + swz(rl, j) +
                                                         4 * q));
            const float2 iv = __ldg(reinterpret_cast<const float2*>(inv + c));
            const float2 sv =
                __ldg(reinterpret_cast<const float2*>(shift + c));
            const float gm0 =
                __fadd_rn(__fmul_rn(xf.x, iv.x), sv.x) > 0.f ? g0 : 0.f;
            const float gm1 =
                __fadd_rn(__fmul_rn(xf.y, iv.y), sv.y) > 0.f ? g1 : 0.f;
            s_inv[2 * j] += __fmul_rn(gm0, xf.x);
            s_inv[2 * j + 1] += __fmul_rn(gm1, xf.y);
            s_shift[2 * j] += gm0;
            s_shift[2 * j + 1] += gm1;
            g0 = __fmul_rn(gm0, iv.x);
            g1 = __fmul_rn(gm1, iv.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(stg + swz(rl, j) + 4 * q) =
              __floats2bfloat162_rn(g0, g1);
        }
      }
      fence_proxy_async();
      named_bar_sync(2 + wg, 128);
      if (store_thread) {
        tma_store_2d(&tm_dx, stg, k0 + 64 * wg, m0);
        bulk_commit();
      }
    }

    // Done with the stage: the last of the 16 warps refills it. The count
    // only grows; the last warp of round it / stages reads one less than
    // 16 times that many rounds.
    __syncwarp();
    uint32_t before = 0;
    if (lane == 0) {
      __threadfence_block();
      before = atomicAdd(&done[st], 1u);
    }
    before = __shfl_sync(0xffffffffu, before, 0);
    if (before == (uint32_t)(kWalkWarps * (it / p.stages + 1) - 1)) {
      __threadfence_block();
      if (lane == 0 && it + p.stages < n_it)
        walk_fill(sb, &full[st], &tm_dy, &tm_y, &tm_x, kts, nts, k0, n0,
                  p.K, p.N, t_begin + it + p.stages);
    }
  }

  if (store_thread) bulk_wait_read<0>();  // the staging box is read

  // This block's dW partial: part_w[split][k][n] over its slice.
  float* pw = part_w + (size_t)split * p.K * p.N;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int idx = wg + kWalkWgs * j;
    if (idx >= kts * nts) continue;
    const int kt = idx / nts, nt = idx % nts;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + 64 * kt + 16 * wq + g + 8 * i;
      if (k >= p.K) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = n0 + 64 * nt + 8 * jj + 2 * q;
        if (n < p.N)
          *reinterpret_cast<float2*>(pw + (size_t)k * p.N + n) = make_float2(
              acc_w[j][4 * jj + 2 * i], acc_w[j][4 * jj + 2 * i + 1]);
      }
    }
  }

  if (kG && kPro && kSpread) {
    // d_inv/d_shift partial rows: over the 4 rows of a warp by shuffles
    // (lanes 8 apart share their columns), over the 16 warps in shared
    // memory in a fixed order.
    __syncthreads();
    float* red = reinterpret_cast<float*>(stage0);  // [2][16 warps][64]
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int o = 8; o < 32; o <<= 1) {
        s_inv[e] += __shfl_xor_sync(0xffffffffu, s_inv[e], o);
        s_shift[e] += __shfl_xor_sync(0xffffffffu, s_shift[e], o);
      }
    }
    if (lane < 8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red[warp * 64 + 8 * lane + e] = s_inv[e];
        red[(kWalkWarps + warp) * 64 + 8 * lane + e] = s_shift[e];
      }
    }
    __syncthreads();
    if (threadIdx.x < 64 && k0 + (int)threadIdx.x < p.K) {
      float a = 0.f, b = 0.f;
      for (int w2 = 0; w2 < kWalkWarps; ++w2) {
        a += red[w2 * 64 + threadIdx.x];
        b += red[(kWalkWarps + w2) * 64 + threadIdx.x];
      }
      part_x[(size_t)split * p.K + k0 + threadIdx.x] = a;
      part_x[(size_t)(p.splits + split) * p.K + k0 + threadIdx.x] = b;
    }
  } else if (kG && kPro) {
    // d_inv/d_shift partial rows: over the 8 row lanes g by shuffles, over
    // the 4 warps of a warpgroup in shared memory (the stages are idle: no
    // copy is in flight), then in a fixed order.
    __syncthreads();
    float* red = reinterpret_cast<float*>(stage0);  // [wg][2][wq][64]
    if (has_g) {
#pragma unroll
      for (int v = 0; v < 16; ++v) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s_inv[v] += __shfl_xor_sync(0xffffffffu, s_inv[v], o);
          s_shift[v] += __shfl_xor_sync(0xffffffffu, s_shift[v], o);
        }
      }
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = 8 * j + 2 * q + e;
            red[((wg * 2 + 0) * 4 + wq) * 64 + cl] = s_inv[2 * j + e];
            red[((wg * 2 + 1) * 4 + wq) * 64 + cl] = s_shift[2 * j + e];
          }
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kts * 64; t += kWalkThreads) {
      const int w_ = t / 64, cl = t % 64, c = k0 + t;
      if (c >= p.K) continue;
      float a = 0.f, b = 0.f;
      for (int w2 = 0; w2 < 4; ++w2) {
        a += red[((w_ * 2 + 0) * 4 + w2) * 64 + cl];
        b += red[((w_ * 2 + 1) * 4 + w2) * 64 + cl];
      }
      part_x[(size_t)split * p.K + c] = a;
      part_x[(size_t)(p.splits + split) * p.K + c] = b;
    }
  }
}

// The split route's dX: tiles of g[128 rows, 128 columns], tile t = (row
// block t / n_ct, column block t % n_ct), so the column blocks of a row
// block run side by side and find its dy and y in L2. A persistent block
// walks tiles blockIdx.x, + gridDim.x, ..., each over N in 64-wide chunks:
// two consumer warpgroups (64 rows each, m64n128k16) and a producer warp
// that keeps a 3-stage ring of dy, y and W chunks full across tiles, so
// the next tile's chunks load while a tile's epilogue runs. dX leaves
// through two staging boxes by TMA stores; with the prologue, x arrives
// there by TMA at the tile's start and dX is written over it.
constexpr int kDxStages = 3;
constexpr int kDxConsumers = 256;
constexpr int kDxThreads = kDxConsumers + 32;

struct DxSmem {
  bf16 dy[kDxStages][128 * 64];  // dy_eff is written over dy
  bf16 y[kDxStages][128 * 64];
  bf16 w[kDxStages][128 * 64];   // W rows c0 .. c0 + 127, a 64-column chunk
  bf16 dx[2][128 * 64];          // dX staging: columns c0 .., c0 + 64 ..
  float red[kDxConsumers / 32][2][128];  // d_inv/d_shift per warp
  uint64_t full[kDxStages], empty[kDxStages], xbar;
};

template <bool kPro>
__global__ void __launch_bounds__(kDxThreads, 1)
dx_kernel(const __grid_constant__ CUtensorMap tm_dy,
          const __grid_constant__ CUtensorMap tm_y,
          const __grid_constant__ CUtensorMap tm_w,
          const __grid_constant__ CUtensorMap tm_dx,
          const __grid_constant__ CUtensorMap tm_x,
          const float* __restrict__ inv,
          const float* __restrict__ shift, const float* __restrict__ ds1,
          const float* __restrict__ ds2, float* __restrict__ part_x, int M,
          int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  DxSmem& sm = aligned_smem<DxSmem>(smem_raw);
  const int n_ct = (K + 127) / 128, n_rb = (M + 127) / 128;
  const int n_tiles = n_ct * n_rb;
  const int n_it = (N + 63) / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kDxStages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], kDxConsumers / 32);
    }
    mbar_init(&sm.xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kDxConsumers / 32) {  // the producer
    if (lane == 0) {
      int gc = 0;  // chunks of this block so far
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int r0 = (t / n_ct) * 128, c0 = (t % n_ct) * 128;
        for (int it = 0; it < n_it; ++it, ++gc) {
          const int st = gc % kDxStages;
          mbar_wait(&sm.empty[st], ((gc / kDxStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.full[st], 3 * 2 * kBoxBytes);
          tma_load_2d(sm.dy[st], &tm_dy, &sm.full[st], 64 * it, r0);
          tma_load_2d(sm.y[st], &tm_y, &sm.full[st], 64 * it, r0);
          tma_load_2d(sm.w[st], &tm_w, &sm.full[st], 64 * it, c0);
        }
      }
    }
    return;
  }

  const int wg = warpgroup_uniform();
  const int wq = warp & 3, g = lane >> 2, q = lane & 3;
  float acc[64];
  int gc = 0, ti = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++ti) {
    const int rb = t / n_ct;
    const int r0 = rb * 128, c0 = (t % n_ct) * 128;
    if (kPro && threadIdx.x == 0) {
      // x of the tile into the staging boxes, once the last tile's stores
      // have read them
      bulk_wait_read<0>();
      mbar_arrive_expect_tx(&sm.xbar,
                            (c0 + 64 < K ? 2 : 1) * 2 * kBoxBytes);
      tma_load_2d(sm.dx[0], &tm_x, &sm.xbar, c0, r0);
      if (c0 + 64 < K) tma_load_2d(sm.dx[1], &tm_x, &sm.xbar, c0 + 64, r0);
    }
    for (int it = 0; it < n_it; ++it, ++gc) {
      const int st = gc % kDxStages;
      mbar_wait(&sm.full[st], (gc / kDxStages) & 1);
      // warp w forms logical chunk w of rows lane + 32 i
      const int col = 64 * it + 8 * warp;
      uint8_t* dyb = reinterpret_cast<uint8_t*>(sm.dy[st]);
      const uint8_t* yb = reinterpret_cast<const uint8_t*>(sm.y[st]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t off = swz(lane + 32 * i, warp);
        uint4 ev = make_uint4(0u, 0u, 0u, 0u);
        if (col < N)
          ev = dy_eff8(*reinterpret_cast<const uint4*>(dyb + off),
                       *reinterpret_cast<const uint4*>(yb + off), ds1 + col,
                       ds2 + col);
        *reinterpret_cast<uint4*>(dyb + off) = ev;
      }
      fence_proxy_async();
      named_bar_sync(1, kDxConsumers);
      wgmma_fence();
      const uint64_t ad = sw128_desc(sm.dy[st] + 64 * 64 * wg);
      const uint64_t bd = sw128_desc(sm.w[st]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128(acc, ad + kk * kKMajorStep, bd + kk * kKMajorStep,
                      (it | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (it > 0) release(&sm.empty[(gc - 1) % kDxStages], lane);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(&sm.empty[(gc - 1) % kDxStages], lane);

    // Epilogue: thread rows r0 + 64 wg + 16 wq + g + 8 i, columns
    // c0 + 8 j + 2 q + (0, 1), j < 16, into the staging boxes (swizzled as
    // the tiles are): over the tile's x with the prologue, else once the
    // last tile's stores have read them.
    if (kPro) {
      mbar_wait(&sm.xbar, ti & 1);
    } else {
      if (threadIdx.x == 0) bulk_wait_read<0>();
      named_bar_sync(2, kDxConsumers);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j + 2 * q;
      float sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
      float2 iv = make_float2(0.f, 0.f), sv = iv;
      if (kPro && c < K) {
        iv = __ldg(reinterpret_cast<const float2*>(inv + c));
        sv = __ldg(reinterpret_cast<const float2*>(shift + c));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rl = 64 * wg + 16 * wq + g + 8 * i;
        const int m = r0 + rl;
        float g0 = acc[4 * j + 2 * i], g1 = acc[4 * j + 2 * i + 1];
        __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(
            reinterpret_cast<uint8_t*>(sm.dx[j / 8]) + swz(rl, j % 8) +
            4 * q);
        if (kPro && m < M && c < K) {
          const float2 xf = __bfloat1622float2(*at);
          const float gm0 =
              __fadd_rn(__fmul_rn(xf.x, iv.x), sv.x) > 0.f ? g0 : 0.f;
          const float gm1 =
              __fadd_rn(__fmul_rn(xf.y, iv.y), sv.y) > 0.f ? g1 : 0.f;
          sa[0] += __fmul_rn(gm0, xf.x);
          sa[1] += __fmul_rn(gm1, xf.y);
          sb[0] += gm0;
          sb[1] += gm1;
          g0 = __fmul_rn(gm0, iv.x);
          g1 = __fmul_rn(gm1, iv.y);
        }
        *at = __floats2bfloat162_rn(g0, g1);
      }
      if (kPro) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            sa[e] += __shfl_xor_sync(0xffffffffu, sa[e], o);
            sb[e] += __shfl_xor_sync(0xffffffffu, sb[e], o);
          }
          if (g == 0) {
            sm.red[warp][0][8 * j + 2 * q + e] = sa[e];
            sm.red[warp][1][8 * j + 2 * q + e] = sb[e];
          }
        }
      }
    }
    fence_proxy_async();
    named_bar_sync(2, kDxConsumers);
    if (threadIdx.x == 0) {
      tma_store_2d(&tm_dx, sm.dx[0], c0, r0);
      if (c0 + 64 < K) tma_store_2d(&tm_dx, sm.dx[1], c0 + 64, r0);
      bulk_commit();
    }
    if (kPro && threadIdx.x < 128 && c0 + (int)threadIdx.x < K) {
      const int cl = threadIdx.x;
      float a = 0.f, b = 0.f;
      for (int w2 = 0; w2 < kDxConsumers / 32; ++w2) {
        a += sm.red[w2][0][cl];
        b += sm.red[w2][1][cl];
      }
      part_x[(size_t)rb * K + c0 + cl] = a;
      part_x[(size_t)(n_rb + rb) * K + c0 + cl] = b;
    }
  }
  if (threadIdx.x == 0) bulk_wait_read<0>();
}

static_assert(sizeof(DxSmem) + 1024 <= 232448, "dX kernel shared bytes");

// out[c] = sum_r part[r][c] over a few rows (the split route's dW): one
// thread per 4 columns, the rows in order (cols % 4 == 0).
constexpr int kFewRows = 16;

__global__ void __launch_bounds__(256)
reduce_few_rows(const float* __restrict__ part, bf16* __restrict__ out,
                int n_rows, long long cols) {
  const long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (c >= cols) return;
  float4 acc = *reinterpret_cast<const float4*>(part + c);
  for (int r = 1; r < n_rows; ++r) {
    const float4 v =
        *reinterpret_cast<const float4*>(part + (size_t)r * cols + c);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + c);
  o[0] = __floats2bfloat162_rn(acc.x, acc.y);
  o[1] = __floats2bfloat162_rn(acc.z, acc.w);
}

template <int kDT, bool kG, bool kPro, bool kSpread>
cudaError_t launch_walk(const CUtensorMap& tdy, const CUtensorMap& ty,
                        const CUtensorMap& tx, const CUtensorMap& tw,
                        const CUtensorMap& tdx,
                        const void* inv, const void* shift, const void* ds1,
                        const void* ds2, void* part_w, void* part_x,
                        const WalkPlan& p, int grid_y, cudaStream_t stream) {
  auto kernel = walk_kernel<kDT, kG, kPro, kSpread>;
  const size_t smem = walk_smem_bytes(p, kG, kPro);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(p.splits, grid_y), kWalkThreads, smem, stream>>>(
      tdy, ty, tx, tw, tdx, static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<const float*>(ds1),
      static_cast<const float*>(ds2), static_cast<float*>(part_w),
      static_cast<float*>(part_x), p);
  return cudaGetLastError();
}

// route 1 ("fused"): splits blocks, each a range of 64-row tiles, with the
// whole K x N. route 2 ("split"): dX by dx_kernel, dW by the walk over
// slices of kts x nts tiles split `splits` ways over M. The wrapper's plan
// sets splits, kts, nts and stages; they are checked here.
int launch_wgmma(int route, const void* x, const void* w, const void* inv,
                 const void* shift, const void* y, const void* dy,
                 const void* ds1, const void* ds2, void* dx, void* part_x,
                 void* part_w, int M, int K, int N, int splits, int kts,
                 int nts, int stages, int prologue, cudaStream_t stream) {
  const int KT = tiles(K, 64), NT = tiles(N, 64);
  WalkPlan p{M, K, N, kts, nts, tiles(NT, nts), tiles(M, 64), splits,
             stages};
  const bool fused = route == 1;
  if (K % 8 || N % 8 || kts <= 0 || nts <= 0 || stages < 2 ||
      stages > kMaxStages || splits > 65535 || splits > p.tiles ||
      kts * nts > 4 * (fused ? (prologue ? 1 : 2) : 2) ||
      (fused && (kts != KT || nts != NT || KT > kWalkWgs)) ||
      (!fused && (long long)tiles(K, 128) * tiles(M, 128) > 0x7fffffffLL) ||
      walk_smem_bytes(p, fused, prologue) > 232448)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tdy, ty, tx, tw, tdx;
  cudaError_t e;
  if ((e = encode_2d_bf16(&tdy, dy, M, N, 64)) != cudaSuccess ||
      (e = encode_2d_bf16(&ty, y, M, N, 64)) != cudaSuccess ||
      (e = encode_2d_bf16(&tx, x, M, K, 64)) != cudaSuccess ||
      (e = encode_2d_bf16(&tw, w, K, N, 64)) != cudaSuccess ||
      (e = encode_2d_bf16(&tdx, dx, M, K, 64)) != cudaSuccess)
    return (int)e;
  if (fused) {
#define HVD_WALK(DT, PRO, SPREAD)                                          \
  launch_walk<DT, true, PRO, SPREAD>(tdy, ty, tx, tw, tdx, inv, shift, ds1, \
                                     ds2, part_w, part_x, p, 1, stream)
    const bool dt2 = kts * nts > kWalkWgs;
    const bool spread = kts == 1 && nts >= 2;
    if (prologue)
      e = spread ? HVD_WALK(1, true, true) : HVD_WALK(1, true, false);
    else if (dt2)
      e = spread ? HVD_WALK(2, false, true) : HVD_WALK(2, false, false);
    else
      e = spread ? HVD_WALK(1, false, true) : HVD_WALK(1, false, false);
#undef HVD_WALK
    return (int)e;
  }
  // dX, then dW
  CUtensorMap tdy128, ty128, tw128, tdx128, tx128;
  if ((e = encode_2d_bf16(&tdy128, dy, M, N, 128)) != cudaSuccess ||
      (e = encode_2d_bf16(&ty128, y, M, N, 128)) != cudaSuccess ||
      (e = encode_2d_bf16(&tw128, w, K, N, 128)) != cudaSuccess ||
      (e = encode_2d_bf16(&tdx128, dx, M, K, 128)) != cudaSuccess ||
      (e = encode_2d_bf16(&tx128, x, M, K, 128)) != cudaSuccess)
    return (int)e;
  const size_t dsmem = sizeof(DxSmem) + 1024;
  const long long dx_tiles = (long long)tiles(K, 128) * tiles(M, 128);
  const int sms = sm_count();
  const dim3 dgrid((unsigned)(dx_tiles < sms ? dx_tiles : sms));
  if (prologue) {
    if ((e = cudaFuncSetAttribute(dx_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dsmem)) != cudaSuccess)
      return (int)e;
    dx_kernel<true><<<dgrid, kDxThreads, dsmem, stream>>>(
        tdy128, ty128, tw128, tdx128, tx128,
        static_cast<const float*>(inv), static_cast<const float*>(shift),
        static_cast<const float*>(ds1), static_cast<const float*>(ds2),
        static_cast<float*>(part_x), M, K, N);
  } else {
    if ((e = cudaFuncSetAttribute(dx_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dsmem)) != cudaSuccess)
      return (int)e;
    dx_kernel<false><<<dgrid, kDxThreads, dsmem, stream>>>(
        tdy128, ty128, tw128, tdx128, tx128, nullptr, nullptr,
        static_cast<const float*>(ds1),
        static_cast<const float*>(ds2), nullptr, M, K, N);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int grid_y = tiles(KT, kts) * p.n_slices;
  e = prologue ? launch_walk<2, false, true, false>(tdy, ty, tx, tw, tdx, inv, shift, ds1,
                                             ds2, part_w, part_x, p,
                                             grid_y, stream)
               : launch_walk<2, false, false, false>(tdy, ty, tx, tw, tdx, inv, shift,
                                              ds1, ds2, part_w, part_x,
                                              p, grid_y, stream);
  return (int)e;
}

}  // namespace
}  // namespace hvd_convbn

// x [M, K], w [K, N] (in x's dtype), inv/shift [K] f32 (null without the
// prologue), y/dy [M, N] in x's dtype, ds1/ds2 [N] f32. Outputs: dx [M, K]
// in x's dtype, dw [K, N] in x's dtype, dinv/dshift [K] f32 (with the
// prologue only). route: 0 = "mma" (any shape, bf16 or f32), 1 = "fused",
// 2 = "split" (bf16, K and N multiples of 8). Scratch, f32: part_w [splits,
// K, N]; part_x [2, rows, K] with the prologue, rows = splits for route 1,
// ceil(M / 128) otherwise. kts, nts, stages: the walk's slice and ring
// (routes 1 and 2; ignored by route 0). dtype: 0 = bfloat16, 1 = float32.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int hvd_conv_bn_bwd(const void* x, const void* w, const void* inv,
                               const void* shift, const void* y,
                               const void* dy, const void* ds1,
                               const void* ds2, void* dx, void* dw,
                               void* dinv, void* dshift, void* part_x,
                               void* part_w, int M, int K, int N, int route,
                               int splits, int kts, int nts, int stages,
                               int prologue, int dtype, void* stream) {
  using namespace hvd_convbn;
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 || splits > 65535 ||
      (dtype != 0 && dtype != 1) || route < 0 || route > 2 ||
      (route != 0 && dtype != 0) || tiles(K, kBN) > 65535 ||
      tiles(N, kBN) > 65535 || (long long)K * N > 0x7fffffffLL ||
      (prologue && (!inv || !shift || !dinv || !dshift || !part_x)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int err;
  if (route != 0)
    err = launch_wgmma(route, x, w, inv, shift, y, dy, ds1, ds2, dx, part_x,
                       part_w, M, K, N, splits, kts, nts, stages, prologue,
                       s);
  else if (dtype == 0)
    err = launch_mma<bf16>(x, w, inv, shift, y, dy, ds1, ds2, dx, part_x,
                           part_w, M, K, N, splits, prologue, s);
  else
    err = launch_mma<float>(x, w, inv, shift, y, dy, ds1, ds2, dx, part_x,
                            part_w, M, K, N, splits, prologue, s);
  if (err) return err;
  // dW, d_inv and d_shift: the partial rows, added in a fixed order
  cudaError_t e;
  if (route != 0 && splits <= kFewRows) {
    const long long cols = (long long)K * N;
    reduce_few_rows<<<(unsigned)((cols / 4 + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(part_w), static_cast<bf16*>(dw), splits,
        cols);
    e = cudaGetLastError();
  } else if (dtype == 0)
    e = launch_reduce<bf16>(static_cast<const float*>(part_w),
                            static_cast<bf16*>(dw), nullptr, nullptr, splits,
                            K * N, s);
  else
    e = launch_reduce<float>(static_cast<const float*>(part_w),
                             static_cast<float*>(dw), nullptr, nullptr,
                             splits, K * N, s);
  if (e != cudaSuccess || !prologue) return (int)e;
  const int rows = route == 1 ? splits : tiles(M, 128);
  float* px = static_cast<float*>(part_x);
  return (int)launch_reduce<float>(px, static_cast<float*>(dinv),
                                   px + (size_t)rows * K,
                                   static_cast<float*>(dshift), rows, K, s);
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
