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
// would read back. Rows past M count zero in the sums (the TPU kernel's
// m_valid mask).
//
// Bound: bytes for every ResNet 1x1 conv of the main path but stage 4's
// (operations). The stage-1 expand conv (M = 401,408, 64 -> 256, bf16)
// moves ~257 MB, 205 MB of it y, for 13 GFLOP: ~51 flops a byte against
// the card's ~295. The TPU kernel walks a sequential M grid with the s1/s2
// sums carried in VMEM. Two routes; the wrapper (ops/conv_bn.py, fwd_plan)
// picks one from the shape before the launch:
//
// "wgmma" (bf16, K and N multiples of 8: the 16-byte TMA stride; every
// ResNet-50 1x1 conv): one persistent kernel, a block per SM walking output
// tiles t, t + grid, ... of 128 x 256 (N > 128), 256 x 128 (64 < N <= 128)
// or 256 x 64 (N <= 64), the column tiles of a row tile side by side so
// that a re-read of its x hits L2; where N fits one tile, x is read and
// normalized once.
//   - A ring of stages is kept full across tiles: per 64-wide K chunk, the
//     x box (tile rows x 64) and the W boxes (64 x 64 each, K rows by tile
//     columns) by TMA (2-D tensor maps, 128-byte swizzle); wgmma reads W
//     as an MN-major B, so nothing transposes it. Thread 0 fills it, and
//     the last warp done with a stage refills it with the chunk one ring
//     later. At K = 64 a tile is one stage, so the ring holds the next
//     tiles' loads while a tile's epilogue runs.
//   - Four warpgroups, each 64 rows x 128 (or 64) columns of f32
//     accumulators (64 registers a thread of the 128 that 512 threads
//     allow). With the prologue, the warpgroups that share 64 rows write
//     relu(x inv + shift) over the raw x box, in place, in the same swizzled
//     layout (__fmul_rn/__fadd_rn, as the plain version rounds), zero past
//     K (inv and shift are never read there) and past M; then wgmma reads
//     the box as a K-major A. No A operand comes from registers (ptxas
//     12.9 miscompiles carried register fragments, PERF.md).
//   - Epilogue: each warpgroup rounds its accumulators to bf16 into its
//     swizzled staging boxes, and y leaves by one TMA store per box (rows
//     past M and columns past N are not written) that runs on while the
//     next tile loads, forms and multiplies; a box is written again once
//     its last store has read it. s1 and s2 are summed from those rounded
//     values read back from the boxes: each lane takes two columns of a
//     box over 32 (or 16) rows, so no lane exchanges partial sums; the
//     block adds its warps' sums in a fixed order into one partial row per
//     row tile, kept in L2 for the reduce (evict_last).
//
// "mma" (f32, the card-against-CPU check, and ragged bf16): PR 3's tiled
// GEMM (conv_bn_common.cuh): mma.sync or FMAs on operands staged through
// registers, one partial row per 128 rows.
//
// Both routes write s1/s2 partial rows whose count depends on the shape
// alone and add them in a fixed order (no float atomics): the sums are the
// same from run to run and on any number of SMs.

#include "conv_bn_common.cuh"
#include "sm90_common.cuh"

namespace hvd_convbn {
namespace {

// ---------------------------------------------------------------------------
// The "mma" route (PR 3)
// ---------------------------------------------------------------------------

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
int launch_mma(const void* x, const void* wt, const void* inv,
               const void* shift, void* y, void* s1, void* s2, void* part,
               int M, int K, int N, int prologue, cudaStream_t stream) {
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

// ---------------------------------------------------------------------------
// The "wgmma" route
// ---------------------------------------------------------------------------

using namespace hvd_sm90;

// Four warpgroups and no producer warp: ptxas counts a warp past the
// warpgroups as a fifth one and caps 544 threads at 96 registers (the
// accumulators spill); 512 threads get 128.
constexpr int kFwdThreads = 512;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kBox = 64 * 64 * 2;                  // a swizzled 64 x 64 box
// Per-warp column sums of a tile, per statistic: 4 row-warps x 256
// columns, 8 x 128 or 16 x 64; the pad puts s2's row in other banks.
constexpr int kRedStride = 1024 + 16;
constexpr int kSmemMax = 232448;

// A tile of kWgRows x (4 / kWgRows) warpgroups of 64 rows x kWN columns.
template <int kWgRows, int kWN>
struct FwdShape {
  static constexpr int kWgCols = 4 / kWgRows;
  static constexpr int kTM = 64 * kWgRows;
  static constexpr int kTN = kWN * kWgCols;
  static constexpr int kXBytes = kTM * 128;        // x chunk: kTM x 64
  static constexpr int kWBytes = kTN * 128;        // W chunk: kTN / 64 boxes
  static constexpr int kYBoxes = 4 * (kWN / 64);   // y staging, per warpgroup
  static constexpr int kFixed =
      kYBoxes * kBox + 2 * kRedStride * 4 + 1024 + 64;
  static constexpr int kFit = (kSmemMax - kFixed) / (kXBytes + kWBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "a ring of two stages at least");
  static_assert(kWgRows * (4 / (kWN / 64)) * kTN <= 1024,
                "red holds a tile's warp sums");
};

template <int kWgRows, int kWN>
struct FwdSmem {
  using S = FwdShape<kWgRows, kWN>;
  uint8_t x[S::kStages][S::kXBytes];
  uint8_t w[S::kStages][S::kWBytes];
  uint8_t y[S::kYBoxes][kBox];
  float red[2][kRedStride];
  uint64_t full[S::kStages];
  uint32_t done[S::kStages];  // warps done with each stage, ever
};

// A partial row to device memory with an L2 evict_last hint: the y stream
// of the same launch would push it out of L2 before reduce_rows reads it.
__device__ __forceinline__ void st_keep(float* p, float v) {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;\n" ::"l"(p),
               "f"(v), "l"(pol)
               : "memory");
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Lane 0 of a warp: chunk c of the block's walk (K chunk c % n_kc of its
// tile c / n_kc) into its stage by TMA, counted on the stage's barrier: x
// rows r0 .., and W's 64 K rows as kTN / 64 boxes of 64 columns side by
// side (zero past K and N).
template <int kWgRows, int kWN>
__device__ __forceinline__ void fwd_fill(FwdSmem<kWgRows, kWN>& sm,
                                         const CUtensorMap* tm_x,
                                         const CUtensorMap* tm_w, int c,
                                         int n_kc, int n_ct, int n_tiles) {
  using S = FwdShape<kWgRows, kWN>;
  const int t = blockIdx.x + (c / n_kc) * gridDim.x, kc = c % n_kc;
  if (t >= n_tiles) return;
  const int st = c % S::kStages;
  const int r0 = (t / n_ct) * S::kTM, c0 = (t % n_ct) * S::kTN;
  mbar_arrive_expect_tx(&sm.full[st], S::kXBytes + S::kWBytes);
  tma_load_2d(sm.x[st], tm_x, &sm.full[st], 64 * kc, r0);
#pragma unroll
  for (int b = 0; b < S::kTN / 64; ++b)
    tma_load_2d(sm.w[st] + b * kBox, tm_w, &sm.full[st], c0 + 64 * b,
                64 * kc);
}

// A warp is done with chunk c's stage (its products have read it): the
// last of the block's warps to be done refills it with chunk c + stages.
// The count only grows; the last warp of round c / stages reads one less
// than kFwdWarps times that many rounds.
template <int kWgRows, int kWN>
__device__ __forceinline__ void fwd_done(FwdSmem<kWgRows, kWN>& sm,
                                         const CUtensorMap* tm_x,
                                         const CUtensorMap* tm_w, int c,
                                         int n_kc, int n_ct, int n_tiles,
                                         int lane) {
  constexpr int kSt = FwdShape<kWgRows, kWN>::kStages;
  __syncwarp();
  uint32_t before = 0;
  if (lane == 0) {
    __threadfence_block();
    before = atomicAdd(&sm.done[c % kSt], 1u);
  }
  before = __shfl_sync(0xffffffffu, before, 0);
  if (before == (uint32_t)(kFwdWarps * (c / kSt + 1) - 1)) {
    __threadfence_block();
    if (lane == 0) fwd_fill(sm, tm_x, tm_w, c + kSt, n_kc, n_ct, n_tiles);
  }
}

// Tile t of the block's walk is row tile t / n_ct, column tile t % n_ct.
// Warpgroup wg owns rows 64 (wg / kWgCols) and columns kWN (wg % kWgCols)
// of the tile. Named barriers: 1 + wr over the warpgroups that share 64
// rows (the prologue's box), 5 and 6 over the block, 7 + wg within a
// warpgroup (its staging boxes).
template <int kWgRows, int kWN, bool kPro>
__global__ void __launch_bounds__(kFwdThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
           const __grid_constant__ CUtensorMap tm_w,
           const __grid_constant__ CUtensorMap tm_y,
           const float* __restrict__ inv, const float* __restrict__ shift,
           float* __restrict__ part, int M, int K, int N) {
  using S = FwdShape<kWgRows, kWN>;
  constexpr int kWgCols = S::kWgCols, kTM = S::kTM, kTN = S::kTN;
  constexpr int kSt = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  FwdSmem<kWgRows, kWN>& sm = aligned_smem<FwdSmem<kWgRows, kWN>>(smem_raw);
  const int n_rt = (M + kTM - 1) / kTM, n_ct = (N + kTN - 1) / kTN;
  const int n_tiles = n_rt * n_ct;
  const int n_kc = (K + 63) / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kSt; ++i) {
      mbar_init(&sm.full[i], 1);
      sm.done[i] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int c = 0; c < kSt; ++c)
      fwd_fill(sm, &tm_x, &tm_w, c, n_kc, n_ct, n_tiles);

  const int wg = warpgroup_uniform();
  const int wr = wg / kWgCols, wc = wg % kWgCols;
  const int wq = warp & 3, g = lane >> 2, q = lane & 3;
  const bool store_thread = (threadIdx.x & 127) == 0;
  // The prologue: warp lw of the warpgroups sharing the box takes kCpw of
  // its 8 logical chunks (8 columns each) of rows lane and lane + 32; the
  // 8 lanes of a quarter-warp hit 8 distinct chunks (the swizzle), and
  // inv/shift loads are the same address across the warp.
  constexpr int kCpw = 2 / kWgCols;
  const int lw = wc * 4 + wq;
  uint8_t* stg = sm.y[wg * (kWN / 64)];
  float acc[kWN / 2];
  int gc = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int rt = t / n_ct;
    const int r0 = rt * kTM, c0 = (t % n_ct) * kTN;
    for (int kc = 0; kc < n_kc; ++kc, ++gc) {
      const int st = gc % kSt;
      mbar_wait<true>(&sm.full[st], (gc / kSt) & 1);
      uint8_t* xb = sm.x[st] + wr * kBox;
      if (kPro) {
#pragma unroll
        for (int cc = 0; cc < kCpw; ++cc) {
          const int c = lw * kCpw + cc;
          const int col = 64 * kc + 8 * c;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = lane + 32 * i;
            uint4* px = reinterpret_cast<uint4*>(xb + swz(row, c));
            uint4 rv = make_uint4(0u, 0u, 0u, 0u);
            if (col < K && r0 + 64 * wr + row < M)
              rv = relu_pre8(*px, inv + col, shift + col);
            *px = rv;  // past K and past M: zero
          }
        }
        fence_proxy_async();
        named_bar_sync(1 + wr, 128 * kWgCols);
      }
      // The fence heads every chunk: a wgmma chain in a loop of unknown
      // trip count gets one injected otherwise (ptxas C7519).
      wgmma_fence();
      // A = the x box, K-major; B = the warpgroup's W boxes, MN-major
      const uint64_t ad = sw128_desc(xb);
      uint8_t* wb = sm.w[st] + wc * (kWN / 64) * kBox;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (kWN == 128)
          wgmma_ss_n128<1>(acc, ad + kk * kKMajorStep,
                           sw128_desc_mn(wb, kBox) + kk * kMNMajorStep,
                           (kc | kk) != 0);
        else
          wgmma_ss<1>(acc, ad + kk * kKMajorStep,
                      sw128_desc(wb) + kk * kMNMajorStep, (kc | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kc > 0)
        fwd_done(sm, &tm_x, &tm_w, gc - 1, n_kc, n_ct, n_tiles, lane);
    }
    // While the last products run: red is free once the last tile's sums
    // are read.
    named_bar_sync(5, kFwdThreads);
    wgmma_wait<0>();
    fence_regs(acc);
    fwd_done(sm, &tm_x, &tm_w, gc - 1, n_kc, n_ct, n_tiles, lane);

    // Epilogue: d[4 j + e] is row 16 wq + g + 8 (e / 2), column 8 j + 2 q +
    // (e % 2) of the warpgroup's 64 x kWN, rounded to bf16 into its
    // staging boxes (swizzled as the operand boxes are) once the last
    // tile's stores have read them; then one TMA store per box.
    constexpr int kBoxes = kWN / 64;
    if (store_thread) bulk_wait_read<0>();
    named_bar_sync(7 + wg, 128);
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
      uint8_t* box = stg + (j / 8) * kBox;
      *reinterpret_cast<uint32_t*>(box + swz(16 * wq + g, j % 8) + 4 * q) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(box + swz(16 * wq + g + 8, j % 8) +
                                   4 * q) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    fence_proxy_async();
    named_bar_sync(7 + wg, 128);
    if (store_thread) {
#pragma unroll
      for (int bx = 0; bx < kBoxes; ++bx) {
        const int col = c0 + wc * kWN + 64 * bx;
        if (col < N && r0 + 64 * wr < M)
          tma_store_2d(&tm_y, stg + bx * kBox, col, r0 + 64 * wr);
      }
      bulk_commit();
    }
    // s1 and s2 of the stored (rounded) values, read back from the staging
    // boxes: lane l of a warp sums columns 2 l, 2 l + 1 of one box over
    // kSumRows rows in order (a warp reads one whole 128-byte row at a
    // time). Rows past M are zero there (the prologue wrote zero rows of
    // A, or TMA filled x with zeros).
    constexpr int kSumWarps = 4 / kBoxes, kSumRows = 64 / kSumWarps;
    {
      const uint8_t* box = stg + (wq / kSumWarps) * kBox;
      const int rs = (wq % kSumWarps) * kSumRows;
      float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll 8
      for (int r = rs; r < rs + kSumRows; ++r) {
        const float2 v = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            box + swz(r, lane >> 2) + 4 * (lane & 3)));
        a0 += v.x;
        a1 += v.y;
        b0 = fmaf(v.x, v.x, b0);
        b1 = fmaf(v.y, v.y, b1);
      }
      const int rw = wr * kSumWarps + wq % kSumWarps;
      const int col = wc * kWN + 64 * (wq / kSumWarps) + 2 * lane;
      *reinterpret_cast<float2*>(&sm.red[0][rw * kTN + col]) =
          make_float2(a0, a1);
      *reinterpret_cast<float2*>(&sm.red[1][rw * kTN + col]) =
          make_float2(b0, b1);
    }
    named_bar_sync(6, kFwdThreads);
    // The tile's partial row of s1 and s2: its row-warps in order.
    for (int u = threadIdx.x; u < 2 * kTN; u += kFwdThreads) {
      const int s = u / kTN, c = u % kTN;
      if (c0 + c >= N) continue;
      float a = 0.f;
#pragma unroll
      for (int rw = 0; rw < kWgRows * kSumWarps; ++rw)
        a += sm.red[s][rw * kTN + c];
      st_keep(part + ((size_t)s * n_rt + rt) * N + c0 + c, a);
    }
  }
  if (store_thread) bulk_wait_read<0>();  // the boxes are read
}

static_assert(sizeof(FwdSmem<2, 128>) + 1024 <= kSmemMax, "128 x 256 tiles");
static_assert(sizeof(FwdSmem<4, 128>) + 1024 <= kSmemMax, "256 x 128 tiles");
static_assert(sizeof(FwdSmem<4, 64>) + 1024 <= kSmemMax, "256 x 64 tiles");

// s1[c], s2[c] = sum_r part[0 or 1][r][c], in a fixed order: thread p of
// block (x, y) sums columns 4 x .. 4 x + 3 of statistic y over rows p, p +
// kRedParts, ..., then the block adds its parts by a fixed tree. Needs
// cols % 4 == 0.
constexpr int kRedParts = 512;

__global__ void __launch_bounds__(kRedParts)
reduce_rows(const float* __restrict__ part, float* __restrict__ s1,
            float* __restrict__ s2, int n_rows, int cols) {
  __shared__ float4 red[kRedParts];
  const int rp = threadIdx.x, c = blockIdx.x * 4;
  const float* p = part + (size_t)blockIdx.y * n_rows * cols;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int r = rp; r < n_rows; r += kRedParts) {
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(p + (size_t)r * cols + c));
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  red[rp] = a;
  __syncthreads();
#pragma unroll
  for (int h = kRedParts / 2; h > 0; h >>= 1) {
    if (rp < h) {
      const float4 o = red[rp + h];
      red[rp].x += o.x;
      red[rp].y += o.y;
      red[rp].z += o.z;
      red[rp].w += o.w;
    }
    __syncthreads();
  }
  if (rp == 0) *reinterpret_cast<float4*>((blockIdx.y ? s2 : s1) + c) = red[0];
}

template <int kWgRows, int kWN, bool kPro>
cudaError_t launch_tiles(const CUtensorMap& tx, const CUtensorMap& tw,
                         const CUtensorMap& ty, const void* inv,
                         const void* shift, void* part, int M, int K, int N,
                         cudaStream_t stream) {
  using S = FwdShape<kWgRows, kWN>;
  auto kernel = fwd_kernel<kWgRows, kWN, kPro>;
  const int smem = (int)sizeof(FwdSmem<kWgRows, kWN>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = tiles(M, S::kTM) * tiles(N, S::kTN);
  const int sms = sm_count();
  kernel<<<n_tiles < sms ? n_tiles : sms, kFwdThreads, smem, stream>>>(
      tx, tw, ty, static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<float*>(part), M, K, N);
  return cudaGetLastError();
}

// tile_n (the wrapper's plan): 256 -> 128 x 256 tiles, 128 -> 256 x 128,
// 64 -> 256 x 64; the partial rows are ceil(M / tile rows).
int launch_wgmma(const void* x, const void* w, const void* inv,
                 const void* shift, void* y, void* s1, void* s2, void* part,
                 int M, int K, int N, int tile_n, int prologue,
                 cudaStream_t stream) {
  const int tm = tile_n == 256 ? 128 : 256;
  if (K % 8 || N % 8 || (tile_n != 64 && tile_n != 128 && tile_n != 256) ||
      (long long)tiles(M, tm) * tiles(N, tile_n) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw, ty;
  cudaError_t e;
  if ((e = encode_2d_bf16(&tx, x, M, K, tm)) != cudaSuccess ||
      (e = encode_2d_bf16(&tw, w, K, N, 64)) != cudaSuccess ||
      (e = encode_2d_bf16(&ty, y, M, N, 64)) != cudaSuccess)
    return (int)e;
#define HVD_TILES(ROWS, WN)                                                  \
  (prologue ? launch_tiles<ROWS, WN, true>(tx, tw, ty, inv, shift, part, M, \
                                           K, N, stream)                     \
            : launch_tiles<ROWS, WN, false>(tx, tw, ty, inv, shift, part, M, \
                                            K, N, stream))
  e = tile_n == 256 ? HVD_TILES(2, 128)
                    : tile_n == 128 ? HVD_TILES(4, 128) : HVD_TILES(4, 64);
#undef HVD_TILES
  if (e != cudaSuccess) return (int)e;
  reduce_rows<<<dim3(N / 4, 2), kRedParts, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(s1),
      static_cast<float*>(s2), tiles(M, tm), N);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace hvd_convbn

// x [M, K]; w: on route 0 ("mma", any shape, bf16 or f32) W^T [N, K], on
// route 1 ("wgmma", bf16, K and N multiples of 8; tile_n 64, 128 or 256) W
// [K, N], in x's dtype; inv/shift [K] f32 (null without the prologue), y
// [M, N] in x's dtype, s1/s2 [N] f32, part [2, rows, N] f32 scratch: rows =
// ceil(M / 128) on route 0, ceil(M / (tile_n == 256 ? 128 : 256)) on route
// 1. dtype: 0 = bfloat16, 1 = float32. Returns cudaGetLastError() after
// the launches (0 on success).
extern "C" int hvd_conv_bn_fwd(const void* x, const void* w, const void* inv,
                               const void* shift, void* y, void* s1, void* s2,
                               void* part, int M, int K, int N, int prologue,
                               int route, int tile_n, int dtype,
                               void* stream) {
  using namespace hvd_convbn;
  if (M <= 0 || K <= 0 || N <= 0 || (dtype != 0 && dtype != 1) ||
      route < 0 || route > 1 || (route == 1 && dtype != 0) ||
      (prologue && (!inv || !shift)) || tiles(N, kBN) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (route == 1)
    return launch_wgmma(x, w, inv, shift, y, s1, s2, part, M, K, N, tile_n,
                        prologue, s);
  return dtype == 0 ? launch_mma<bf16>(x, w, inv, shift, y, s1, s2, part, M,
                                       K, N, prologue, s)
                    : launch_mma<float>(x, w, inv, shift, y, s1, s2, part,
                                        M, K, N, prologue, s);
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
