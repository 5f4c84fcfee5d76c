// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (horovod_tpu/ops/pallas/
// flash_attention.py, reached through `flash_block_attend`). Same contract:
// q [B, Sq, H, D], k/v [B, Sk, H, D] in bf16 or f32 -> UNNORMALIZED
// o = sum_j exp(s_ij - m_i) v_j in f32 [B, Sq, H, D] plus the row stats
// m (running max of s = scale q . k) and l (running sum) in f32
// [B, H, Sq], with the causal mask taken at global positions
// q_offset + i >= k_offset + j. A row that sees no key gives m = -1e30,
// l = 0 and o = 0 exactly, so ring attention can merge partials. No
// atomics: every sum stays in one block, in a fixed order, so results are
// bitwise the same from run to run.
//
// Bound: operations. Causal, the kernel does 4 * B * H * D * Sq * Sk / 2
// flops against (3 Sk + Sq) * B * H * D inputs read once, far above the
// card's ~295 flops per byte; and as many exponentials, B * H * Sq * Sk / 2
// (268.6 M at the flagship's B=8, S=2048, H=16), which at 16 a clock per
// SM take about as long as the products at 989 TF/s (~0.07 ms each). What
// the design does about it:
//   - the TPU's sequential K grid axis (m, l, acc carried in VMEM) becomes a
//     loop inside one block that owns its q rows; m, l and the output
//     accumulator stay in registers for the whole loop, and blocks run in
//     no order, heaviest first;
//   - the loop stops at the last K tile any row of the block can see, so
//     the causal forward does about half the work; the tensor-core route
//     applies the mask only on the tiles that cross the diagonal or the
//     ragged edge.
// Two implementations of the same contract:
//   - bf16 with D <= 64 and scale > 0 (the flagship): Hopper's warpgroup
//     products with f32 accumulation: s = q k^T as wgmma m64n128k16 with
//     both operands K-major in shared memory, o += p v as m64n64k16 with
//     p as the A operand from registers, rounded to bf16 from the s
//     accumulators (as the reference's p.astype(v.dtype)), and v read
//     through an MN-major descriptor over the same TMA tile, so nothing is
//     transposed by hand. K/V tiles of 128 keys arrive by TMA (4-D tensor
//     maps over [B, S, H, D], 128-byte swizzle, zero fill past S and D)
//     into a ring of 4 stages signalled by full mbarriers. A block is three
//     warpgroups of 64 q rows each, sharing every staged tile. There is no
//     producer warpgroup: 128-key tiles need 64 s accumulators beside the
//     32 of o, and ptxas caps a thread at 128 registers at 512 threads
//     (168 at 384), whatever setmaxnreg grants later; so thread 0 fills
//     the ring and the last warp done with a stage refills it. A
//     warpgroup does its softmax, then, in its turn (named barriers pass
//     the turn 0, 1, 2, 0, ...), issues o += p v and the next tile's s
//     together, passes the turn on and waits for both; so one warpgroup's
//     softmax runs beside the others' products. The s accumulators carry
//     the next tile's products into the next iteration; a register A
//     fragment never does: every p fragment is built in the iteration
//     that multiplies it (see wgmma_rs in sm90_common.cuh). Exponentials
//     are ex2.approx.ftz with log2(e) folded into the scale; m is kept as
//     the max of the raw products and stored times scale, the reference's
//     units (hence scale > 0). ptxas builds it to 168 registers a thread
//     with no spills; 156,728 bytes of dynamic shared memory a block. At the flagship shape 128-key tiles with turns ran 1-3 %
//     faster than 64-key tiles with a producer warpgroup
//     (tools/compare_trees.py, PERF.md); the kernel stays at about a
//     third of its bound, held by each warpgroup's chain of products,
//     wait and softmax;
//   - f32, or D > 64 (or scale <= 0): f32 FMAs on shared-memory tiles, 4 x 4
//     outputs a thread, 256 threads; q, k and v read in their own dtype
//     straight from the [B, S, H, D] strides and converted to f32 once per
//     tile in shared memory.

#include <math.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

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


// ---------------------------------------------------------------------------
// Tensor-core route for bf16, D <= 64: wgmma and TMA (sm90_common.cuh).
//
// A block is three warpgroups that own 192 q rows, 64 each, loaded once by
// TMA, and stream K/V in tiles of 128 keys through a ring of kStages
// stages; every staged tile serves the three warpgroups. There is no
// producer warpgroup: thread 0 fills the ring first, and the last warp to
// be done with a stage (a shared counter) refills it. A warpgroup
// multiplies the n_wg tiles its rows see, the first n_full of them
// unmasked (every (row, key) visible), the rest masked (they cross the
// causal diagonal or the ragged edge); past them it only takes its turns
// and counts itself done with the block's remaining tiles.
// ---------------------------------------------------------------------------

using namespace hvd_sm90;

constexpr int kN = 128;                           // keys of a K/V tile
constexpr int kNK = kN / 16;                      // its k16 steps in p v
constexpr int kS = kN / 2;                        // s accumulators a thread
constexpr int kStages = 4;
constexpr int kWgs = 3;                           // warpgroups
constexpr int kRows = 64 * kWgs;
constexpr int kWgmmaThreads = kWgs * 128;
constexpr uint32_t kStageBytes = 2 * (kN / 64) * kTileBytes;  // K and V

struct FwdSmem {
  bf16 q[kWgs][64 * 64];              // the block's q rows
  bf16 k[kStages][kN * 64];           // the ring: streamed K/V tiles
  bf16 v[kStages][kN * 64];
  uint64_t full[kStages], own;
  uint32_t done[kStages];             // warps done with the stage, ever
};

// A block asks for its struct + 1 KB (to align it to 1024 bytes) of
// dynamic shared memory.
static_assert(sizeof(FwdSmem) + 1024 == 156728, "forward shared bytes");

// s = q k^T over one K tile, both operands K-major in shared memory; one
// commit group. The first k16 step overwrites s.
__device__ __forceinline__ void issue_s(float (&s)[kS], uint64_t dq,
                                        const bf16* sk) {
  const uint64_t dk = sw128_desc(sk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n128(s, dq + kk * kKMajorStep, dk + kk * kKMajorStep, kk);
  wgmma_commit();
}

// Starts the TMA copies of K/V tile `tile` into stage st.
__device__ __forceinline__ void fill_stage(FwdSmem& sm, int st, int tile,
                                           const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, int h,
                                           int b) {
  mbar_arrive_expect_tx(&sm.full[st], kStageBytes);
  tma_load_4d(sm.k[st], tm_k, &sm.full[st], 0, h, tile * kN, b);
  tma_load_4d(sm.v[st], tm_v, &sm.full[st], 0, h, tile * kN, b);
}

struct fmax_op {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

struct add_op {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};

// op over the kN / 4 accumulators of this thread in row i (0: row g, 1:
// row g + 8) as a tree, for a short dependence chain.
template <typename Op>
__device__ __forceinline__ float row_reduce(const float (&s)[kS], int i,
                                            Op op) {
  float v[kN / 8];
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
    v[j] = op(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
#pragma unroll
  for (int lv = 0; lv < 4; ++lv) {            // log2(kN / 8) levels
    const int w = (kN / 16) >> lv;
#pragma unroll
    for (int j = 0; j < kN / 16; ++j)
      if (j < w) v[j] = op(v[j], v[j + w]);
  }
  return v[0];
}

// Grid (B * H, ceil(Sq / 192)); blockIdx.y runs over q blocks heaviest
// first (under the causal mask the last rows see the most keys).
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       float* __restrict__ o_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int H, int Sq, int Sk,
                       int D, int q_offset, int k_offset, float scale,
                       int causal) {
  extern __shared__ uint8_t smem_raw[];
  FwdSmem& sm = aligned_smem<FwdSmem>(smem_raw);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qb0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // K tiles some row of the block sees.
  int n_kt = (Sk + kN - 1) / kN;
  if (causal) {
    const int visible = q_offset + min(qb0 + kRows, Sq) - k_offset;
    n_kt = visible <= 0 ? 0 : min(n_kt, (visible + kN - 1) / kN);
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 1);
      sm.done[i] = 0;
    }
    mbar_init(&sm.own, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_kt > 0) {
    mbar_arrive_expect_tx(&sm.own, kWgs * kTileBytes);
    for (int i = 0; i < kWgs; ++i)
      tma_load_4d(sm.q[i], &tm_q, &sm.own, 0, h, qb0 + 64 * i, b);
    for (int it = 0; it < min(kStages, n_kt); ++it)
      fill_stage(sm, it, it, &tm_k, &tm_v, h, b);
  }

  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qb0 + 64 * wg;               // the warpgroup's first row
  const int row0 = r0 + 16 * w + g;           // this thread's rows: +0, +8
  const float scale2 = scale * kLog2e;
  // Tiles this warpgroup's rows see, and how many of them lead with every
  // (row, key) visible: the warpgroup's first row sees the tile's last key
  // and the tile lies inside Sk.
  int n_wg = r0 < Sq ? n_kt : 0;
  int n_full = Sk / kN;
  if (causal) {
    const int visible = q_offset + min(r0 + 64, Sq) - k_offset;
    n_wg = visible <= 0 ? 0 : min(n_wg, (visible + kN - 1) / kN);
    const int first_sees = q_offset + r0 - k_offset + 1;  // keys [0, ..)
    n_full = min(n_full, first_sees <= 0 ? 0 : first_sees / kN);
  }
  n_full = min(n_full, n_wg);
  // Keys [0, lim) of the block are visible to this thread's two rows.
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lim[i] = causal ? min(Sk, q_offset + row0 + 8 * i - k_offset + 1) : Sk;

  // m is the row max of the raw products q . k (kNegInf: no key seen
  // yet), l this thread's part of the row sum of p.
  float o[32], s[kS];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  if (n_kt > 0) {
    mbar_wait(&sm.own, 0);
    const uint64_t dq = sw128_desc(sm.q[wg]);
    mbar_wait(&sm.full[0], 0);
    issue_s(s, dq, sm.k[0]);
    wgmma_wait<0>();
    fence_regs(s);
    // Turns: the warpgroups issue their products in the order 0, 1, 2, 0,
    // ..., one turn per tile of the block, each on its own named barrier
    // (128 threads wait, the 128 before arrive) that the warpgroup before
    // opens once its products are issued. So a warpgroup's softmax runs
    // while the others' products do, instead of all meeting on the
    // exponential unit and then on the tensor cores. A warpgroup past its
    // last visible tile still takes its turns.
    const int my_bar = 1 + wg, next_bar = 1 + (wg + 1) % kWgs;
    if (wg == kWgs - 1) named_bar_arrive(1, 256);  // warpgroup 0 goes first
    for (int it = 0; it < n_kt; ++it) {
      const int st = it % kStages;
      const bool pass_on = it < n_kt - 1 || wg < kWgs - 1;
      if (it < n_wg) {
        // s holds this tile's q k^T, o every earlier tile's p v.
        if (it >= n_full) {
          // Keys at or past lim drop below kMaskedBelow. Arithmetic, not a
          // predicated write: a per-thread branch on an accumulator can
          // make ptxas serialize every wgmma of the kernel (C7518).
#pragma unroll
          for (int j = 0; j < kN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = it * kN + 8 * j + 2 * t + (e & 1);
              s[4 * j + e] += c >= lim[e >> 1] ? 2.f * kNegInf : 0.f;
            }
        }
        float msub[2], alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = row_reduce(s, i, fmax_op());
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx);
          // p = 2^(scale2 (s - m)); a row that has seen no key subtracts
          // +inf, so its masked entries give p = 0, never 2^0.
          msub[i] = m_new <= kMaskedBelow ? INFINITY : m_new * scale2;
          alpha[i] = ex2(fmaf(m[i], scale2, -msub[i]));
          alpha[i] = m_new == m[i] ? 1.f : alpha[i];
          m[i] = m_new;
        }
#pragma unroll
        for (int j = 0; j < kS; ++j)
          s[j] = ex2(fmaf(s[j], scale2, -msub[(j >> 1) & 1]));
#pragma unroll
        for (int j = 0; j < 32; ++j) o[j] *= alpha[(j >> 1) & 1];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          l[i] = fmaf(l[i], alpha[i], row_reduce(s, i, add_op()));
        // o += p . v with p rounded to bf16 as the A fragment (built here,
        // in the iteration that multiplies it) and v read MN-major; then,
        // in this warpgroup's turn, the next tile's s into the same
        // accumulators (the last tile issues its own again, so that no
        // product sits in a branch).
        uint32_t a[kNK][4];
        pack_a(a, s);
        const uint64_t dv = sw128_desc(sm.v[st]);
        const int nx = min(it + 1, n_wg - 1);
        mbar_wait(&sm.full[nx % kStages], (nx / kStages) & 1);
        named_bar_sync(my_bar, 256);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kNK; ++kk)
          wgmma_rs<1>(o, a[kk], dv + kk * kMNMajorStep);
        wgmma_commit();
        issue_s(s, dq, sm.k[nx % kStages]);
        if (pass_on) named_bar_arrive(next_bar, 256);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(s);
        fence_regs(a);
      } else {  // past its last visible tile: waits for it, takes its turn
        mbar_wait(&sm.full[st], (it / kStages) & 1);
        named_bar_sync(my_bar, 256);
        if (pass_on) named_bar_arrive(next_bar, 256);
      }
      // The warp is done with stage st. The count only grows: the last
      // warp of round it / kStages reads one less than the warps of that
      // many rounds, and refills the stage.
      __syncwarp();
      uint32_t before = 0;
      if (lane == 0) {
        __threadfence_block();
        before = atomicAdd(&sm.done[st], 1u);
      }
      before = __shfl_sync(0xffffffffu, before, 0);
      if (before == 4 * kWgs * (it / kStages + 1) - 1 && lane == 0 &&
          it + kStages < n_kt) {
        __threadfence_block();
        fill_stage(sm, st, it + kStages, &tm_k, &tm_v, h, b);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= Sq) continue;
    float* orow = o_out + ((size_t)(b * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
    }
    if (t == 0) {  // m in the reference's units: max of scale * q . k
      m_out[(size_t)bh * Sq + r] = m[i] <= kMaskedBelow ? kNegInf
                                                         : m[i] * scale;
      l_out[(size_t)bh * Sq + r] = l[i];
    }
  }
}

// Encodes the three [B, S, H, D] maps (K/V boxes of 128 rows) and
// launches the wgmma kernel with its shared memory (+1 KB to align it to
// 1024 bytes).
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 void* m, void* l, int B, int H, int Sq, int Sk, int D,
                 int q_offset, int k_offset, float scale, int causal,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  if ((e = encode_bshd_bf16(&tq, q, B, Sq, H, D, 64)) != cudaSuccess ||
      (e = encode_bshd_bf16(&tk, k, B, Sk, H, D, kN)) != cudaSuccess ||
      (e = encode_bshd_bf16(&tv, v, B, Sk, H, D, kN)) != cudaSuccess)
    return (int)e;
  const size_t smem = sizeof(FwdSmem) + 1024;
  if ((e = allow_smem(flash_fwd_wgmma_kernel, smem)) != cudaSuccess)
    return (int)e;
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  flash_fwd_wgmma_kernel<<<grid, kWgmmaThreads, smem, stream>>>(
      tq, tk, tv, static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), H, Sq, Sk, D, q_offset, k_offset, scale,
      causal);
  return (int)cudaGetLastError();
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
  if (dtype == 0 && D <= 64 && scale > 0.f)
    return launch_wgmma(q, k, v, o, m, l, B, H, Sq, Sk, D, q_offset,
                        k_offset, scale, causal, s);
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
