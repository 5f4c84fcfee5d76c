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
//   - each CTA moves `rows_per_cta` whole rows, one contiguous byte range;
//     its threads move 16-byte vectors (uint4), neighbouring threads on
//     neighbouring addresses, four vectors per thread in flight before the
//     first store, with streaming cache hints (__ldcs/__stcs: the data is
//     touched once and does not fit the 50 MB L2 anyway);
//   - a range whose source and destination share their offset modulo 16
//     copies a scalar head up to the first 16-byte boundary, the vector
//     body, and a scalar tail; a range where they differ (a pointer not
//     16-byte aligned against the other) copies byte by byte;
//   - the TPU sweep's 512/1024/2048-row blocks are a VMEM/DMA question
//     (a 2048-row block of 2 KiB rows would be 4 MiB, and only 64 of them
//     would cover 132 SMs); here the sweep is over the tile each CTA moves.
//     The TPU's "parallel"/"arbitrary" grid semantics have no meaning on
//     Hopper: CTAs always run in parallel, in no order.
// cp.async/TMA bulk copies are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;

__global__ void stream_copy_kernel(const unsigned char* __restrict__ src,
                                   unsigned char* __restrict__ dst,
                                   long long total, long long cta_bytes) {
  const long long start = (long long)blockIdx.x * cta_bytes;
  const long long end = min(total, start + cta_bytes);
  const unsigned char* s = src + start;
  unsigned char* d = dst + start;
  const long long len = end - start;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(s);
  const uintptr_t da = reinterpret_cast<uintptr_t>(d);
  if (((sa ^ da) & 15) != 0) {  // never co-aligned: bytes
    for (long long i = tid; i < len; i += nt) d[i] = s[i];
    return;
  }
  long long head = (long long)((16 - (sa & 15)) & 15);
  if (head > len) head = len;
  for (long long i = tid; i < head; i += nt) d[i] = s[i];
  const long long nvec = (len - head) / 16;
  const uint4* s4 = reinterpret_cast<const uint4*>(s + head);
  uint4* d4 = reinterpret_cast<uint4*>(d + head);
  for (long long i = tid; i < nvec; i += (long long)kUnroll * nt) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + (long long)u * nt;
      if (j < nvec) r[u] = __ldcs(s4 + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + (long long)u * nt;
      if (j < nvec) __stcs(d4 + j, r[u]);
    }
  }
  for (long long i = head + nvec * 16 + tid; i < len; i += nt) d[i] = s[i];
}

}  // namespace

// src, dst: [rows, row_bytes] bytes each, not overlapping. Each CTA copies
// rows_per_cta rows. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int hvd_stream_copy(const void* src, void* dst, long long rows,
                               long long row_bytes, int rows_per_cta,
                               void* stream) {
  if (rows <= 0 || row_bytes <= 0 || rows_per_cta <= 0 || !src || !dst)
    return (int)cudaErrorInvalidValue;
  const long long ctas = (rows + rows_per_cta - 1) / rows_per_cta;
  if (ctas > 2147483647LL) return (int)cudaErrorInvalidValue;
  const long long cta_bytes = (long long)rows_per_cta * row_bytes;
  // enough threads for kUnroll vectors each, a warp at least, 256 at most
  long long vec_threads = (cta_bytes / 16 + kUnroll - 1) / kUnroll;
  int threads = (int)((vec_threads + 31) / 32 * 32);
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  stream_copy_kernel<<<(unsigned)ctas, threads, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
      rows * row_bytes, cta_bytes);
  return (int)cudaGetLastError();
}

extern "C" const char* hvd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
