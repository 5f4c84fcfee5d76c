// Hopper (sm_90a) building blocks: mbarriers, TMA tile loads through
// tensor maps, shared-memory matrix descriptors and warpgroup matrix
// products (wgmma), as PTX, and the pieces the flash kernels' tensor-core
// routes share. Used by flash_fwd.cu, flash_bwd.cu and the conv_bn kernels.
//
// Conventions:
//   - operand tiles are 64 rows of 64 bf16 (128 bytes a row) that TMA
//     writes with 128-byte swizzle into 1024-byte aligned shared memory:
//     the 16-byte chunk c of row r lands at chunk c ^ (r % 8). One tile
//     serves as a K-major operand (the product sums along its columns) and
//     as an MN-major one (the product sums along its rows) through two
//     descriptors over the same bytes; nothing is copied transposed;
//   - wgmma m64n64k16 with f32 accumulators: thread t of the warpgroup
//     (warp w = t / 32, g = lane / 4, q = lane % 4) holds d[4 j + e] at
//     row 16 w + g + 8 (e / 2), column 8 j + 2 q + (e % 2), j < 8. The A
//     operand from registers has mma.sync's m16n8k16 fragment layout over
//     the warp's 16 rows, so d[8 kk .. 8 kk + 7] rounded to bf16 pairs is
//     the A fragment of the next product's k16 step kk. m64n128k16 holds
//     d[4 j + e] the same way for j < 16; its B operand is two such tiles
//     one after the other (128 rows: TMA writes them as one box).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Adds `bytes` to the transaction count of the current phase (no arrival).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// 4 bytes from global into shared memory, asynchronously; zero when !valid
// (nothing is read).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait();

// Waits until the phase of parity `parity` has completed. A wait that
// lasts seconds is a protocol fault (every wait here is for work inside
// the block): it traps, so the launch fails instead of hanging the card.
// kGmma: the warpgroup may have a wgmma group in flight here; the timeout
// path waits for it before it traps (ptxas injects that wait otherwise and
// notes C7517).
template <bool kGmma = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - t0 > 4000000000ull) {
      if (kGmma) wgmma_wait<0>();
      __trap();
    }
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One box of a 4-D tensor map into shared memory; completion is counted
// in bytes on `bar`. Coordinates innermost first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map into shared memory; completion counted in
// bytes on `bar`. c0 is the column, c1 the row.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One box of shared memory to a 2-D tensor map (rows and columns past the
// tensor are not written), in a bulk group: bulk_commit, then
// bulk_wait_read before the box is written again.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// The warpgroup index of this thread, as a value the compiler knows is the
// same across the warp (so a branch on it around wgmma is not divergent).
__device__ __forceinline__ int warpgroup_uniform() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operand reads, TMA) that follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Closes this thread's bulk group (its TMA stores so far).
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's bulk groups still read
// shared memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime's
// entry-point query so the library needs no -lcuda. Null when absent.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
    if (e == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a contiguous bf16 [B, S, H, D] tensor whose box is
// `rows` rows x 64 columns of one (b, h), written with 128-byte swizzle.
// Rows >= S and columns >= D read as zero. Needs D % 8 == 0 (16-byte
// strides) and D <= 64.
inline cudaError_t encode_bshd_bf16(CUtensorMap* map, const void* base,
                                    int B, int S, int H, int D, int rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidPitchValue;
}

// A tensor map over a contiguous row-major bf16 [rows, cols] matrix whose
// box is `box_rows` rows x 64 columns, written with 128-byte swizzle (the
// layout of one 64-row tile per 64 rows of the box). Rows >= rows and
// columns >= cols read as zero. Needs cols % 8 == 0 (16-byte strides).
inline cudaError_t encode_2d_bf16(CUtensorMap* map, const void* base,
                                  long long rows, long long cols,
                                  int box_rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidPitchValue;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte swizzled operand at `p` (1024-byte aligned
// tile, or a K offset of 32-byte steps into one). K-major: 8-row groups
// are 1024 bytes apart (SBO); LBO is unused. MN-major: the 8-row groups
// along K are 1024 bytes apart (SBO); LBO would step to the next 64
// elements along MN, which a 64-wide operand never needs.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t addr = smem_u32(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same for an MN-major operand wider than 64 along MN (n128): its
// 64-element blocks along MN are `lbo` bytes apart (LBO).
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* p,
                                                  uint32_t lbo) {
  const uint32_t addr = smem_u32(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Advance a descriptor along K by one k16 step: 32 bytes within the
// swizzled row (K-major), or 16 rows of 128 bytes (MN-major).
constexpr uint64_t kKMajorStep = 32 >> 4;
constexpr uint64_t kMNMajorStep = 2048 >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Tells the compiler that registers an asynchronous wgmma reads or writes
// are in use here, so no read of them moves above a wait and no other
// value takes their place before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define HVD_WGMMA_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HVD_WGMMA_D64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define HVD_WGMMA_OUT8(d, i)                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HVD_WGMMA_OUT32(d)                                                \
  HVD_WGMMA_OUT8(d, 0), HVD_WGMMA_OUT8(d, 8), HVD_WGMMA_OUT8(d, 16),      \
      HVD_WGMMA_OUT8(d, 24)

// d (+)= A . B, m64n64k16, bf16 in, f32 accumulate; A and B from shared
// memory, each K-major (kTrans = 0) or MN-major (1): an MN-major A is a
// tile whose rows run along the reduction (A^T stored row-major). scale_d
// = 0 overwrites d.
template <int kTransB, int kTransA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_WGMMA_D32
      ", %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : HVD_WGMMA_OUT32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d (+)= A . B, m64n128k16, bf16 in, f32 accumulate; A and B from shared
// memory, A K-major, B K-major (kTransB = 0: 128 rows) or MN-major (1: two
// 64-wide blocks, sw128_desc_mn). scale_d = 0 overwrites d.
template <int kTransB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64],
                                              uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HVD_WGMMA_D64
      ", %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : HVD_WGMMA_OUT32(d), HVD_WGMMA_OUT8(d, 32), HVD_WGMMA_OUT8(d, 40),
        HVD_WGMMA_OUT8(d, 48), HVD_WGMMA_OUT8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
}

// d += A . B, m64n64k16, A from registers (four bf16 pairs in the layout
// above), B from shared memory, K-major (kTransB = 0) or MN-major (1).
// Build A inside the loop iteration that multiplies it (from the
// accumulators or from memory); do not carry it across iterations. ptxas
// of CUDA 12.9, when it serializes products that sit in a branch (C7520),
// reuses the registers of an A fragment that is live around the loop and
// never reloads them: tests/cuda/wgmma_rs_probe.cu shows it, and
// test_cuda_wgmma_rs_carried_a_fragment_is_miscompiled holds it.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : HVD_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(kTransB));
}

// Moves registers between warpgroups: a producer gives back, consumers
// take. Every warp of the warpgroup executes it.
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Named barrier `id` (1..15; 0 is __syncthreads') over `count` threads:
// sync waits for the count, arrive adds to it without waiting.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

#undef HVD_WGMMA_D32
#undef HVD_WGMMA_D64
#undef HVD_WGMMA_OUT8
#undef HVD_WGMMA_OUT32

// ---------------------------------------------------------------------------
// Shared by the flash kernels' tensor-core routes
// ---------------------------------------------------------------------------

constexpr uint32_t kTileBytes = 64 * 64 * 2;   // one swizzled bf16 tile
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU; results below 2^-126 flush to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rounds the accumulator pairs of k16 step kk (d[8 kk .. 8 kk + 7]) to the
// bf16 A fragment of the next product.
template <int NK>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NK][4],
                                       const float (&d)[8 * NK]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// A consumer warp is done with a stage of a ring: one arrival for the
// warp on the stage's empty barrier, after every lane's reads of it.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The block's dynamic shared memory as a struct aligned to 1024 bytes, the
// period of the 128-byte swizzle; a launch asks for sizeof + 1 KB.
template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(uint8_t* raw) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(raw);
  return *reinterpret_cast<Smem*>((p + 1023) & ~uintptr_t(1023));
}

}  // namespace hvd_sm90
