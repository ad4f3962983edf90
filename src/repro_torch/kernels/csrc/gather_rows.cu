// Row gather out[i, :] = table[idx[i], :] for sm_90a (the device-cache hit
// path of the embedding cache).
//
// Replaces the Pallas TPU kernel gather_rows_pallas (_kernel) in
// src/repro/kernels/gather_rows/kernel.py:33, whose scalar-prefetched index
// vector steered one DMA per row through the grid's BlockSpec index map.
//
// What bounds it on an H100: memory, and at the port's sizes the launch.
// It moves 2 * n * d * 4 bytes (each row read once and written once) plus
// the indices and does no arithmetic; at the serving and training fetches
// (n = 32 and 706 rows of d = 64) that is 16 kB and 361 kB, well under a
// microsecond of HBM time, so the host's launch decides the eager time
// (kernels/ops.py keeps that path short: the stream handle from the raw
// current-stream query, no device switch when the device is current).  The
// first version gave each row one warp, so at d = 64 half of its lanes had
// no 16-byte chunk to move.
//
// Design: one thread per 16-byte chunk of the output when d % 4 == 0 and
// both bases are 16-byte aligned, else one per element: thread t copies
// chunk t % (d / 4) of row t / (d / 4), so every lane has work at any d and
// neighbouring lanes touch neighbouring addresses of the output (and of
// each source row).  Each thread loads its row's index itself (there is no
// scalar prefetch; the lanes of a row read the same index in one
// transaction) and reads the table through the read-only path.  A thread
// moves one chunk and the grid covers the output, so a large n keeps as
// many loads in flight as the SMs hold threads.  Positions in the output are
// 32-bit (an output of up to 16 GiB).  Indices are int32 or int64 and are
// range-checked by the caller on the host.  A pure copy like this
// one would serve equally well in Triton; it is CUDA C++ so that the port
// keeps one build route.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Positions in the output are 32-bit (the entry point refuses an output of
// 2^32 - 256 floats or more, 16 GiB), so a thread's row and column cost one
// 32-bit division.
template <typename Idx, bool kVec>
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const float* __restrict__ table, const Idx* __restrict__ idx,
    float* __restrict__ out, unsigned total, unsigned w, long long d) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const unsigned row = t / w, c = t - row * w;  // w: chunks (or elements) per row
  const long long src = (long long)idx[row];
  if (kVec) {
    reinterpret_cast<float4*>(out)[t] =
        __ldg(reinterpret_cast<const float4*>(table + src * d) + c);
  } else {
    out[t] = __ldg(table + src * d + c);
  }
}

template <typename Idx, bool kVec>
void launch(const float* table, const Idx* idx, float* out, long long n, long long d,
            cudaStream_t s) {
  const unsigned w = (unsigned)(kVec ? d / 4 : d), total = (unsigned)(n * w);
  gather_rows_kernel<Idx, kVec><<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      table, idx, out, total, w, d);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  `idx`
// holds n int64 values when idx_is_64 != 0, else n int32 values, each in
// [0, rows).  Refuses an output of n * d >= 2^32 - 256 floats.
extern "C" int gather_rows_f32(const float* table, const void* idx, int idx_is_64,
                               float* out, long long n, long long d, void* stream) {
  if (n < 1 || d < 1 || n > (0xffffffffLL - kThreads) / d) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* i64 = static_cast<const int64_t*>(idx);
  const auto* i32 = static_cast<const int32_t*>(idx);
  if (vec) {
    if (idx_is_64) launch<int64_t, true>(table, i64, out, n, d, s);
    else launch<int32_t, true>(table, i32, out, n, d, s);
  } else {
    if (idx_is_64) launch<int64_t, false>(table, i64, out, n, d, s);
    else launch<int32_t, false>(table, i32, out, n, d, s);
  }
  return (int)cudaGetLastError();
}
