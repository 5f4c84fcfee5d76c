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
// q/k/v/do in bf16 or f32 -> dq/dk/dv in f32 [B, S, H, D]. A row that sees
// no key gets dq = 0 exactly, a key no row sees dk = dv = 0 exactly.
//
// Bound: operations. The dq kernel does three products over the visible
// tiles (s, dp, dq), the dk/dv kernel four (s, dp, dv, dk), each recomputing
// s from q and k instead of reading a saved [Sq, Sk] tensor: 7 products
// against a fused kernel's 5, the price of having no float atomics. What
// the design does about it:
//   - no atomics: the dq kernel owns q rows and loops over the K tiles
//     they can see; the dk/dv kernel owns keys and loops over the q tiles
//     that can see them. Every sum stays inside one block, in a fixed
//     order, so the gradients are bitwise the same from run to run;
//   - the causal skip on both sides, blocks launched heaviest first over
//     the whole grid, the mask applied only on tiles that cross the
//     diagonal or the ragged edge;
//   - P comes from the saved lse (no second max/sum pass); the tensor-core
//     route takes it as ex2.approx with log2(e) folded into the scale and
//     lse; the accumulators stay in registers across the loop.
// Two implementations of each kernel:
//   - bf16 with D <= 64 (the flagship): Hopper's warpgroup products. Every
//     product is a wgmma m64n64k16 with f32 accumulation. s and dp read
//     both operands from shared memory; the dq, dk and dv products take
//     P, dS (or their transposes) as the A operand from registers, rounded
//     to bf16 straight from the accumulators (as the mma.sync route did),
//     and read their B operand (k, q, do) from the same shared tile that
//     served K-major, through an MN-major (transposed) descriptor: no
//     operand is copied twice or transposed by hand. Tiles arrive by TMA
//     (4-D tensor maps over [B, S, H, D], 128-byte swizzle, which zero-fills
//     rows past S and columns past D) into a ring of 3 stages signalled by
//     mbarriers, so the next tile loads while the current one is
//     multiplied. A block is three consumer warpgroups, each owning 64 of
//     the block's 192 rows and sharing every staged tile; they overlap
//     each other's exp work with their products, and inside a warpgroup
//     the dq kernel computes P while its dp product still runs. The dq
//     kernel adds a producer warpgroup that hands its registers to the
//     consumers (setmaxnreg); the dk/dv kernel needs all 168 registers a
//     thread of 384 for its four 64x64 f32 tiles, so the last warp done
//     with a stage refills it. A block takes 99,384 (dq) or 100,912
//     bytes (dk/dv) of shared memory. Measured alternatives that were
//     slower: two consumer warpgroups, A operands of s and dp from
//     registers, issuing the next tile's s/dp behind the current gradient
//     products, 2 or 4 stages, and split waits in the dk/dv kernel
//     (PERF.md). Every register A fragment is built inside the iteration
//     that multiplies it (see wgmma_rs in sm90_common.cuh);
//   - f32, or bf16 with D > 64: f32 FMAs on shared-memory tiles, 64 rows
//     a block.

#include "flash_common.cuh"
#include "sm90_common.cuh"

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


// ---------------------------------------------------------------------------
// Tensor-core route for bf16, D <= 64: wgmma and TMA (sm90_common.cuh).
//
// A block owns 192 rows (the dq kernel: q rows; the dk/dv kernel: keys),
// 64 per consumer warpgroup, loaded once by TMA, and streams the other
// side in 64-row tiles through a ring of kStages stages; each staged tile
// serves the three warpgroups. A stage is signalled full by an mbarrier
// (TMA bytes + arrivals). A warpgroup whose 64 rows see none of a tile
// (the causal edge, or rows past S) skips its products but still takes
// part in the ring.
//   - dq: a fourth, producer warpgroup; one of its threads refills a stage
//     once the stage's empty mbarrier has an arrival from every consumer
//     warp. It hands its registers to the consumers (setmaxnreg).
//   - dk/dv: three warpgroups and no producer: its 4 x 32 f32 accumulator
//     tiles need 168 registers a thread, and 3 x 128 x 168 leaves none for
//     a fourth warpgroup. Each warp counts itself done with a stage on a
//     shared counter; the last one refills the stage (TMA for q and do,
//     cp.async for lse and dD), so no warp waits to start a copy.
// ---------------------------------------------------------------------------

using namespace hvd_sm90;

constexpr int kStages = 3;

constexpr int kDqWgs = 3;                        // consumer warpgroups
constexpr int kDqRows = 64 * kDqWgs;
constexpr int kDqThreads = (kDqWgs + 1) * 128;   // + the producer
constexpr int kDqConsumerRegs = 152;             // 3 x 128 x 152 + 128 x 56
constexpr int kDqProducerRegs = 56;              //   = 65,536

struct DqSmem {
  bf16 q[kDqWgs][64 * 64];            // the block's q rows
  bf16 dout[kDqWgs][64 * 64];
  bf16 k[kStages][64 * 64];           // the ring: streamed K/V tiles
  bf16 v[kStages][64 * 64];
  uint64_t full[kStages], empty[kStages], own;
};

constexpr int kDkvWgs = 3;
constexpr int kDkvRows = 64 * kDkvWgs;
constexpr int kDkvThreads = kDkvWgs * 128;

struct DkvSmem {
  bf16 k[kDkvWgs][64 * 64];           // the block's keys
  bf16 v[kDkvWgs][64 * 64];
  bf16 q[kStages][64 * 64];           // the ring: streamed Q/dO tiles
  bf16 dout[kStages][64 * 64];
  float lse[kStages][64];             // lse of the tile's rows
  float dd[kStages][64];
  uint64_t full[kStages], own;
  uint32_t done[kStages];             // warps done with the stage, ever
};

// A block asks for its struct + 1 KB (to align it to 1024 bytes) of
// dynamic shared memory: 99,384 bytes (dq) and 100,912 (dk/dv).
static_assert(sizeof(DqSmem) + 1024 == 99384, "dq shared bytes");
static_assert(sizeof(DkvSmem) + 1024 == 100912, "dk/dv shared bytes");

// Stage st gets q tile q0: lane 0 starts the TMA copies of q and do, every
// lane copies two rows of lse and dD with cp.async; the 32 arrivals land
// with the copies.
__device__ __forceinline__ void dkv_fill(DkvSmem& sm, int st, int q0,
                                         const CUtensorMap* tm_q,
                                         const CUtensorMap* tm_do,
                                         const float* lse, const float* dD,
                                         int bh, int h, int b, int Sq,
                                         int lane) {
  if (lane == 0) {
    mbar_expect_tx(&sm.full[st], 2 * kTileBytes);
    tma_load_4d(sm.q[st], tm_q, &sm.full[st], 0, h, q0, b);
    tma_load_4d(sm.dout[st], tm_do, &sm.full[st], 0, h, q0, b);
  }
  for (int i = lane; i < 64; i += 32) {
    const int r = q0 + i;
    const size_t at = (size_t)bh * Sq + min(r, Sq - 1);
    cp_async_4(&sm.lse[st][i], lse + at, r < Sq);
    cp_async_4(&sm.dd[st][i], dD + at, r < Sq);
  }
  cp_async_arrive(&sm.full[st]);
}

// The dq kernel's products for one K/V tile: s = q k^T and dp = do v^T
// (both from shared memory, K-major, committed as two groups),
// p = exp2(s * scale2 - lse2) while dp still runs, ds = p (dp - dD), then
// dq += ds . k with ds as the A fragment and k read MN-major. kMask: the
// tile crosses the causal diagonal or the ragged edge.
template <bool kMask>
__device__ __forceinline__ void dq_tile(float (&acc)[32], float (&s)[32],
                                        float (&dp)[32], uint64_t dq_a,
                                        uint64_t ddo_a, const bf16* sk,
                                        const bf16* sv, const float (&lse2)[2],
                                        const float (&dd)[2], float scale2,
                                        int row0, int key0, int Sk,
                                        int q_offset, int k_offset,
                                        int causal) {
  const uint64_t dk = sw128_desc(sk), dv = sw128_desc(sv);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(s, dq_a + kk * kKMajorStep, dk + kk * kKMajorStep, kk);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(dp, ddo_a + kk * kKMajorStep, dv + kk * kKMajorStep, kk);
  wgmma_commit();
  wgmma_wait<1>();  // s is ready; p is computed while dp is multiplied
  fence_regs(s);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float p = ex2(fmaf(s[4 * j + e], scale2, -lse2[i]));
      if (kMask) {
        const int c = key0 + 8 * j + (e & 1);
        const bool ok = c < Sk && (!causal || q_offset + row0 + 8 * i >=
                                                  k_offset + c);
        p = ok ? p : 0.f;
      }
      s[4 * j + e] = p;
    }
  wgmma_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int j = 0; j < 32; ++j) dp[j] = s[j] * (dp[j] - dd[(j >> 1) & 1]);
  uint32_t a[4][4];
  pack_a(a, dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<1>(acc, a[kk], dk + kk * kMNMajorStep);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a);
}

// Grid (B * H, ceil(Sq / 192)); blockIdx.y runs over q blocks heaviest
// first (under the causal mask the last rows see the most keys).
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ dD,
                          float* __restrict__ dq, int H, int Sq, int Sk,
                          int D, int q_offset, int k_offset, float scale,
                          int causal) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qb0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // K tiles some row of the block sees.
  int n_kt = (Sk + 63) / 64;
  if (causal) {
    const int visible = q_offset + min(qb0 + kDqRows, Sq) - k_offset;
    n_kt = visible <= 0 ? 0 : min(n_kt, (visible + 63) / 64);
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], 4 * kDqWgs);
    }
    mbar_init(&sm.own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * kDqWgs) {  // the producer; one thread starts the copies
    setmaxnreg_dec<kDqProducerRegs>();
    if (warp != 4 * kDqWgs) return;
    if (lane == 0 && n_kt > 0) {
      mbar_arrive_expect_tx(&sm.own, 2 * kDqWgs * kTileBytes);
      for (int i = 0; i < kDqWgs; ++i) {
        tma_load_4d(sm.q[i], &tm_q, &sm.own, 0, h, qb0 + 64 * i, b);
        tma_load_4d(sm.dout[i], &tm_do, &sm.own, 0, h, qb0 + 64 * i, b);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kStages;
        mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes);
        tma_load_4d(sm.k[st], &tm_k, &sm.full[st], 0, h, it * 64, b);
        tma_load_4d(sm.v[st], &tm_v, &sm.full[st], 0, h, it * 64, b);
      }
    }
    return;
  }

  setmaxnreg_inc<kDqConsumerRegs>();
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qb0 + 64 * wg;               // the warpgroup's first row
  const int row0 = r0 + 16 * w + g;           // this thread's rows: +0, +8
  const float scale2 = scale * kLog2e;
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    lse2[i] = r < Sq ? lse[(size_t)bh * Sq + r] * kLog2e : 0.f;
    dd[i] = r < Sq ? dD[(size_t)bh * Sq + r] : 0.f;
  }
  // K tiles this warpgroup's rows see.
  int n_kt_wg = r0 < Sq ? n_kt : 0;
  if (causal && n_kt_wg > 0) {
    const int visible = q_offset + min(r0 + 64, Sq) - k_offset;
    n_kt_wg = visible <= 0 ? 0 : min(n_kt, (visible + 63) / 64);
  }
  float acc[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = dp[i] = 0.f;

  if (n_kt > 0) {
    mbar_wait(&sm.own, 0);
    const uint64_t dq_a = sw128_desc(sm.q[wg]);
    const uint64_t ddo_a = sw128_desc(sm.dout[wg]);
    for (int it = 0; it < n_kt; ++it) {
      const int st = it % kStages;
      mbar_wait(&sm.full[st], (it / kStages) & 1);
      if (it < n_kt_wg) {
        const int k0 = it * 64;
        // Every (row, key) of the tile visible: the warpgroup's first row
        // sees the tile's last key, and the tile lies inside Sk.
        const bool edge = k0 + 64 > Sk ||
                          (causal && q_offset + r0 < k_offset + k0 + 63);
        if (edge)
          dq_tile<true>(acc, s, dp, dq_a, ddo_a, sm.k[st], sm.v[st], lse2,
                        dd, scale2, row0, k0 + 2 * t, Sk, q_offset,
                        k_offset, causal);
        else
          dq_tile<false>(acc, s, dp, dq_a, ddo_a, sm.k[st], sm.v[st], lse2,
                         dd, scale2, row0, k0 + 2 * t, Sk, q_offset,
                         k_offset, causal);
      }
      release(&sm.empty[st], lane);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= Sq) continue;
    float* row = dq + ((size_t)(b * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < D)
        *reinterpret_cast<float2*>(row + d) = make_float2(
            acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// The dk/dv kernel's products for one Q/dO tile, transposed against the
// dq kernel (rows keys, columns q rows): s^T = k q^T and dp^T = v do^T
// (shared memory, K-major), p^T and ds^T in registers with lse2/dD per
// column from the stage, then dv += p^T . do and dk += ds^T . q with the
// A fragments from registers and do, q read MN-major.
template <bool kMask>
__device__ __forceinline__ void dkv_tile(
    float (&gk)[32], float (&gv)[32], float (&s)[32], float (&dp)[32],
    uint64_t dk_a, uint64_t dv_a, const bf16* sq, const bf16* sdo,
    const float* lse2, const float* dd, float scale2, int key0, int qrow0,
    int Sq, int Sk, int q_offset, int k_offset, int causal, int t) {
  const uint64_t dq_b = sw128_desc(sq), ddo_b = sw128_desc(sdo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(s, dk_a + kk * kKMajorStep, dq_b + kk * kKMajorStep, kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(dp, dv_a + kk * kKMajorStep, ddo_b + kk * kKMajorStep, kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
    const float2 d2 = *reinterpret_cast<const float2*>(dd + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lv = ((e & 1) ? l2.y : l2.x) * kLog2e;
      const float dv = (e & 1) ? d2.y : d2.x;
      float p = ex2(fmaf(s[4 * j + e], scale2, -lv));
      if (kMask) {
        const int c = key0 + 8 * (e >> 1);
        const int r = qrow0 + col + (e & 1);
        const bool ok = c < Sk && r < Sq &&
                        (!causal || q_offset + r >= k_offset + c);
        p = ok ? p : 0.f;
      }
      s[4 * j + e] = p;                              // p^T
      dp[4 * j + e] = p * (dp[4 * j + e] - dv);      // ds^T
    }
  }
  uint32_t pa[4][4], da[4][4];
  pack_a(pa, s);
  pack_a(da, dp);
  const uint64_t dq_m = sw128_desc(sq), ddo_m = sw128_desc(sdo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<1>(gv, pa[kk], ddo_m + kk * kMNMajorStep);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<1>(gk, da[kk], dq_m + kk * kMNMajorStep);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(gv);
  fence_regs(gk);
  fence_regs(pa);
  fence_regs(da);
}

// Grid (B * H, ceil(Sk / 192)); key block 0 first (under the causal mask
// the first keys are seen by the most q rows).
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ dD,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int H, int Sq, int Sk, int D, int q_offset,
                           int k_offset, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& sm = aligned_smem<DkvSmem>(smem_raw);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kb0 = blockIdx.y * kDkvRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The first q tile holding a row that sees the block's first key.
  const int n_qt = (Sq + 63) / 64;
  int qt_begin = 0;
  if (causal) {
    const int r = k_offset + kb0 - q_offset;
    if (r > 0) qt_begin = min(r / 64, n_qt);
  }
  const int n_it = n_qt - qt_begin;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 32);
      sm.done[i] = 0;
    }
    mbar_init(&sm.own, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // No producer: warp 0 fills the ring first, then the last warp to be
  // done with a stage refills it.
  if (warp == 0 && n_it > 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.own, 2 * kDkvWgs * kTileBytes);
      for (int i = 0; i < kDkvWgs; ++i) {
        tma_load_4d(sm.k[i], &tm_k, &sm.own, 0, h, kb0 + 64 * i, b);
        tma_load_4d(sm.v[i], &tm_v, &sm.own, 0, h, kb0 + 64 * i, b);
      }
    }
    for (int st = 0; st < min(kStages, n_it); ++st)
      dkv_fill(sm, st, (qt_begin + st) * 64, &tm_q, &tm_do, lse, dD, bh, h,
               b, Sq, lane);
  }

  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = kb0 + 64 * wg;               // the warpgroup's first key
  const int key0 = c0 + 16 * w + g;           // this thread's keys: +0, +8
  const float scale2 = scale * kLog2e;
  float gk[32], gv[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) gk[i] = gv[i] = s[i] = dp[i] = 0.f;

  if (n_it > 0) {
    mbar_wait(&sm.own, 0);
    const uint64_t dk_a = sw128_desc(sm.k[wg]);
    const uint64_t dv_a = sw128_desc(sm.v[wg]);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int q0 = (qt_begin + it) * 64;
      mbar_wait(&sm.full[st], (it / kStages) & 1);
      // Some (row, key) visible: the tile's last row sees the warpgroup's
      // first key. All visible: its first row sees the last key, and the
      // tile lies inside Sq and Sk.
      const bool any = c0 < Sk &&
                       (!causal || q_offset + q0 + 63 >= k_offset + c0);
      if (any) {
        const bool edge = c0 + 64 > Sk || q0 + 64 > Sq ||
                          (causal && q_offset + q0 < k_offset + c0 + 63);
        if (edge)
          dkv_tile<true>(gk, gv, s, dp, dk_a, dv_a, sm.q[st], sm.dout[st],
                         sm.lse[st], sm.dd[st], scale2, key0, q0, Sq, Sk,
                         q_offset, k_offset, causal, t);
        else
          dkv_tile<false>(gk, gv, s, dp, dk_a, dv_a, sm.q[st], sm.dout[st],
                          sm.lse[st], sm.dd[st], scale2, key0, q0, Sq, Sk,
                          q_offset, k_offset, causal, t);
      }
      __syncwarp();
      uint32_t before = 0;
      if (lane == 0) {
        __threadfence_block();
        before = atomicAdd(&sm.done[st], 1u);
      }
      before = __shfl_sync(0xffffffffu, before, 0);
      // The count only grows: the last warp of round it / kStages reads
      // one less than the warps of that many rounds.
      if (before == 4 * kDkvWgs * (it / kStages + 1) - 1) {  // refill
        __threadfence_block();
        if (it + kStages < n_it)
          dkv_fill(sm, st, (qt_begin + it + kStages) * 64, &tm_q, &tm_do,
                   lse, dD, bh, h, b, Sq, lane);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = key0 + 8 * i;
    if (c >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + c) * H + h) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < D) {
        *reinterpret_cast<float2*>(dk + off + d) = make_float2(
            gk[4 * j + 2 * i] * scale, gk[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<float2*>(dv + off + d) =
            make_float2(gv[4 * j + 2 * i], gv[4 * j + 2 * i + 1]);
      }
    }
  }
}

// Encodes the four [B, S, H, D] maps and launches a wgmma kernel with
// the block's shared memory (+1 KB to align it to 1024 bytes).
template <typename Smem, int kThreads, int kRows, typename Kernel,
          typename... Out>
int launch_wgmma(Kernel kernel, int n_own_rows, const void* q, const void* k,
                 const void* v, const void* dout, const void* lse,
                 const void* dD, int B, int H, int Sq, int Sk, int D,
                 int q_offset, int k_offset, float scale, int causal,
                 cudaStream_t stream, Out*... out) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e;
  if ((e = encode_bshd_bf16(&tq, q, B, Sq, H, D, 64)) != cudaSuccess ||
      (e = encode_bshd_bf16(&tk, k, B, Sk, H, D, 64)) != cudaSuccess ||
      (e = encode_bshd_bf16(&tv, v, B, Sk, H, D, 64)) != cudaSuccess ||
      (e = encode_bshd_bf16(&tdo, dout, B, Sq, H, D, 64)) != cudaSuccess)
    return (int)e;
  const size_t smem = sizeof(Smem) + 1024;
  if ((e = allow_smem(kernel, smem)) != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (n_own_rows + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(dD), static_cast<float*>(out)..., H, Sq, Sk,
      D, q_offset, k_offset, scale, causal);
  return (int)cudaGetLastError();
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
  if (dtype == 0 && D <= 64)
    return launch_wgmma<DqSmem, kDqThreads, kDqRows>(
        flash_bwd_dq_wgmma_kernel, Sq, q, k, v, dout, lse, dD, B, H, Sq, Sk,
        D, q_offset, k_offset, scale, causal, s, dq);
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
  if (dtype == 0 && D <= 64)
    return launch_wgmma<DkvSmem, kDkvThreads, kDkvRows>(
        flash_bwd_dkv_wgmma_kernel, Sk, q, k, v, dout, lse, dD, B, H, Sq, Sk,
        D, q_offset, k_offset, scale, causal, s, dk, dv);
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
