// Streaming copy, for Hopper (sm_90a): the bandwidth probe's kernel.
//
// Replaces the Pallas TPU kernel `copy_kernel` of bench.py (reached
// through `pallas_copy`, `bench.py --pallas-bandwidth`): o = x over a
// [rows, row_bytes] array, block by block, to measure what a kernel's
// streaming pass reaches against the framework's elementwise pass. Here it
// copies bytes, whatever the dtype.
//
// Bound: bytes, and nothing else. Every byte is read once and written once
// with no arithmetic: 2 x 256 MiB at the probe's shape (bf16 [131072,
// 1024]) over 3.35 TB/s is 0.160 ms. What the design does about it:
//   - a persistent grid (at most kBlocksPerSm blocks an SM) walks the copy
//     in chunks of `rows_per_cta` whole rows, one contiguous byte range
//     each: block b takes chunks b, b + grid, ...; a chunk is the unit a
//     block moves per step of its loop, as the TPU sweep's row block was;
//   - bytes are always in flight: the threads of a block (enough for four
//     16-byte vectors each of a chunk, 32 to 512) move the vectors and
//     issue the next batch's loads before the current batch's stores,
//     across chunk boundaries. Loads are
//     non-coherent with a 256-byte L2 fetch and stores skip L1: of the
//     flavours measured (plain, __ldg, the evict-first hints __ldcs/__stcs
//     of PR 4's kernel, others) the fastest. A second design, one thread a
//     block streaming cp.async.bulk copies through a ring of shared
//     memory, measured slower at every tile and was dropped (PERF.md);
//   - a range whose source and destination share their offset modulo 16
//     copies a scalar head up to the first 16-byte boundary and a scalar
//     tail; where they differ the whole copy goes byte by byte (no vector
//     can serve it).
// The TPU's "parallel"/"arbitrary" grid semantics have no meaning on
// Hopper: CTAs always run in parallel, in no order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;
constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 64;

struct Chunk {
  long long start, len;  // bytes of chunk c
};

__device__ __forceinline__ Chunk chunk_of(long long c, long long total,
                                          long long cta_bytes) {
  const long long s = c * cta_bytes;
  return {s, min(total, s + cta_bytes) - s};
}

// Head bytes of a chunk before its first 16-byte boundary (co-aligned
// source and destination).
__device__ __forceinline__ long long head_of(const unsigned char* src,
                                             long long start, long long len) {
  const long long h =
      (long long)((16 - ((reinterpret_cast<uintptr_t>(src) + start) & 15)) &
                  15);
  return h < len ? h : len;
}

// The scalar head and tail of every chunk of this block.
__device__ __forceinline__ void copy_edges(const unsigned char* src,
                                           unsigned char* dst,
                                           long long total,
                                           long long cta_bytes,
                                           long long n_chunks) {
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = chunk_of(c, total, cta_bytes);
    const long long head = head_of(src, ch.start, ch.len);
    const long long body_end = head + (ch.len - head) / 16 * 16;
    for (long long i = threadIdx.x; i < head; i += blockDim.x)
      dst[ch.start + i] = src[ch.start + i];
    for (long long i = body_end + threadIdx.x; i < ch.len; i += blockDim.x)
      dst[ch.start + i] = src[ch.start + i];
  }
}

// 16 bytes from the source, read-only for the kernel (source and
// destination do not overlap), not kept in L1, with a 256-byte L2 fetch;
// and 16 bytes to the destination, not kept in L1.
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile(
      "st.global.L1::no_allocate.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
      : "memory");
}

// Thread t of the block moves vectors t, t + nt, ... of each chunk body in
// batches of kUnroll per thread; the loads of the next batch (possibly of
// the next chunk) are issued before the stores of the current one.
struct VecPos {
  long long c, v, nvec;
  const uint4* s4;
  uint4* d4;
};

__device__ __forceinline__ bool vec_seek(VecPos& p, const unsigned char* src,
                                         unsigned char* dst, long long total,
                                         long long cta_bytes,
                                         long long n_chunks) {
  for (; p.c < n_chunks; p.c += gridDim.x) {
    const Chunk ch = chunk_of(p.c, total, cta_bytes);
    const long long head = head_of(src, ch.start, ch.len);
    p.nvec = (ch.len - head) / 16;
    p.s4 = reinterpret_cast<const uint4*>(src + ch.start + head);
    p.d4 = reinterpret_cast<uint4*>(dst + ch.start + head);
    p.v = 0;
    if (p.nvec > 0) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
stream_copy_kernel(const unsigned char* __restrict__ src,
                unsigned char* __restrict__ dst, long long total,
                long long cta_bytes, long long n_chunks) {
  copy_edges(src, dst, total, cta_bytes, n_chunks);
  const long long step = (long long)kUnroll * blockDim.x;
  VecPos cur{(long long)blockIdx.x, 0, 0, nullptr, nullptr};
  bool ok = vec_seek(cur, src, dst, total, cta_bytes, n_chunks);
  uint4 r[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = cur.v + threadIdx.x + (long long)u * blockDim.x;
    if (ok && j < cur.nvec) r[u] = ld_stream(cur.s4 + j);
  }
  while (ok) {
    VecPos nxt = cur;
    nxt.v += step;
    bool ok2 = true;
    if (nxt.v >= nxt.nvec) {
      nxt.c += gridDim.x;
      ok2 = vec_seek(nxt, src, dst, total, cta_bytes, n_chunks);
    }
    uint4 rn[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = nxt.v + threadIdx.x + (long long)u * blockDim.x;
      if (ok2 && j < nxt.nvec) rn[u] = ld_stream(nxt.s4 + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = cur.v + threadIdx.x + (long long)u * blockDim.x;
      if (j < cur.nvec) st_stream(cur.d4 + j, r[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = rn[u];
    cur = nxt;
    ok = ok2;
  }
}

// Source and destination not co-aligned: byte by byte, chunk by chunk.
__global__ void byte_copy_kernel(const unsigned char* __restrict__ src,
                                 unsigned char* __restrict__ dst,
                                 long long total, long long cta_bytes,
                                 long long n_chunks) {
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = chunk_of(c, total, cta_bytes);
    for (long long i = threadIdx.x; i < ch.len; i += blockDim.x)
      dst[ch.start + i] = src[ch.start + i];
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

}  // namespace

// src, dst: [rows, row_bytes] bytes each, not overlapping. Each block
// copies chunks of rows_per_cta rows per step of its loop. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int hvd_stream_copy(const void* src, void* dst, long long rows,
                               long long row_bytes, int rows_per_cta,
                               void* stream) {
  if (rows <= 0 || row_bytes <= 0 || rows_per_cta <= 0 || !src || !dst)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (rows + rows_per_cta - 1) / rows_per_cta;
  const long long cta_bytes = (long long)rows_per_cta * row_bytes;
  const long long grid_max = (long long)kBlocksPerSm * sm_count();
  const unsigned grid = (unsigned)(n_chunks < grid_max ? n_chunks : grid_max);
  // enough threads for kUnroll vectors each, a warp at least
  const long long vec_threads = (cta_bytes / 16 + kUnroll - 1) / kUnroll;
  int threads = (int)((vec_threads + 31) / 32 * 32);
  threads = threads < 32 ? 32 : (threads > kThreads ? kThreads : threads);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* d = static_cast<unsigned char*>(dst);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (((reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst)) &
       15) != 0)
    byte_copy_kernel<<<grid, 256, 0, st>>>(s, d, rows * row_bytes, cta_bytes,
                                           n_chunks);
  else
    stream_copy_kernel<<<grid, threads, 0, st>>>(s, d, rows * row_bytes,
                                                 cta_bytes, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
