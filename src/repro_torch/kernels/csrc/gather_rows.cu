// Row gather out[i, :] = table[idx[i], :] for sm_90a (the device-cache hit
// path of the embedding cache).
//
// Replaces the Pallas TPU kernel gather_rows_pallas (_kernel) in
// src/repro/kernels/gather_rows/kernel.py, whose scalar-prefetched index
// vector steered one DMA per row through the grid's BlockSpec index map.
//
// What bounds it on an H100: memory, and at serving sizes the launch.  It
// moves 2 * n * d * 4 bytes (each row read once and written once) and does
// no arithmetic; at n = 256, d = 64 that is 131 kB, well under a
// microsecond of HBM time.
//
// Design: one warp per output row, eight rows per 256-thread block.  Each
// warp loads its own index (there is no scalar prefetch) and copies the
// row with 16-byte vector loads and stores when d % 4 == 0 and both base
// pointers are 16-byte aligned, else with 4-byte ones; neighbouring lanes
// touch neighbouring addresses, so every access coalesces.  Indices are
// int32 or int64 and are range-checked by the caller on the host.  A pure
// copy like this one would serve equally well in Triton; it is CUDA C++ so
// that the port keeps one build route.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename Idx>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const float* __restrict__ table, const Idx* __restrict__ idx,
    float* __restrict__ out, long long n, long long d, bool vec4) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const long long src = (long long)idx[row];
  if (vec4) {
    const float4* t = reinterpret_cast<const float4*>(table + src * d);
    float4* o = reinterpret_cast<float4*>(out + row * d);
    for (long long c = lane; c < d / 4; c += 32) o[c] = t[c];
  } else {
    const float* t = table + src * d;
    float* o = out + row * d;
    for (long long c = lane; c < d; c += 32) o[c] = t[c];
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  `idx`
// holds n int64 values when idx_is_64 != 0, else n int32 values, each in
// [0, rows).
extern "C" int gather_rows_f32(const float* table, const void* idx, int idx_is_64,
                               float* out, long long n, long long d, void* stream) {
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (idx_is_64) {
    gather_rows_kernel<int64_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        table, static_cast<const int64_t*>(idx), out, n, d, vec4);
  } else {
    gather_rows_kernel<int32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        table, static_cast<const int32_t*>(idx), out, n, d, vec4);
  }
  return (int)cudaGetLastError();
}
