// Masked-mean neighbour aggregation + projection of ONE relation (the
// R-GCN AGG_r of the dict-form executors), for sm_90a.
//
//   out[i, :] = (sum_j mask[i,j] * h[i,j,:]) / max(sum_j mask[i,j], 1) @ w + b
//
// Replaces the Pallas TPU kernel relation_agg_pallas (_kernel) in
// src/repro/kernels/relation_agg/kernel.py.  That kernel walked a
// sequential grid (node block, d_out block, d_in chunk) and carried a
// float32 VMEM accumulator across the d_in chunks, so the mean never
// reached HBM.  It is the unstacked form of stacked_mean_linear (one
// weight, no slot axis) and keeps its own entry point here.
//
// What bounds it on an H100: memory, and at the dict-form executors'
// sizes the launch.  Per destination row it reads f * d_in * 4 bytes of h
// (1.5 KB at f = 3, d_in = 128) against 2 * f * d_in + 2 * d_in * d_out
// operations (17 kFLOP), about 11 FLOP per byte: under the ~20 FLOP per
// byte at which the fp32 CUDA cores become the limit.  At (n, f, d_in,
// d_out) = (4096, 3, 128, 64) the whole call moves 7.4 MB, about 2.2 us of
// HBM time, so one launch costs as much as the work.
//
// Design:
//   * one block of 256 threads per (tile of kRows = 16 destination rows,
//     tile of kCols = 64 output columns); blocks run in any order, so the
//     d_in loop that the TPU grid carried in scratch runs inside the block;
//   * per d_in chunk of kChunk = 64 columns, the masked mean of the tile is
//     built in shared memory in fp32 (neighbouring threads read
//     neighbouring h columns, so the reads of h coalesce; the f loop is
//     sequential per thread), and the weight chunk is staged beside it;
//   * each thread owns one row and four neighbouring output columns of the
//     tile in registers: per k one shared-memory scalar and one 16-byte
//     shared-memory vector feed four FMAs;
//   * ragged n, d_in and d_out are masked inside the kernel: no padded
//     copies of any operand; an all-masked row gives b (the count is
//     clamped at 1).
// Later work (not here): 16-byte loads of h, TMA + wgmma, bf16 storage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;    // destination rows per block
constexpr int kCols = 64;    // output columns per block
constexpr int kChunk = 64;   // d_in columns staged per pass
constexpr int kColGroups = kCols / 4;  // threads along the columns of a row

static_assert(kRows * kColGroups == kThreads, "one thread per (row, 4 columns)");

__global__ void __launch_bounds__(kThreads) relation_agg_kernel(
    const float* __restrict__ h, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ out, long long n, int f, int d_in, int d_out) {
  __shared__ float mean_s[kRows][kChunk];
  __shared__ __align__(16) float w_s[kChunk][kCols];
  __shared__ float cnt_s[kRows];

  const long long row0 = (long long)blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;

  if (tid < kRows) {
    const long long row = row0 + tid;
    float c = 0.f;
    if (row < n) {
      for (int j = 0; j < f; ++j) c += mask[row * f + j] ? 1.f : 0.f;
    }
    cnt_s[tid] = fmaxf(c, 1.f);
  }

  const int r = tid / kColGroups;        // this thread's row of the tile
  const int c4 = (tid % kColGroups) * 4;  // and its first of four columns
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < d_in; k0 += kChunk) {
    for (int e = tid; e < kRows * kChunk; e += kThreads) {
      const int rr = e / kChunk;
      const int k = k0 + e % kChunk;
      const long long row = row0 + rr;
      float sum = 0.f;
      if (row < n && k < d_in) {
        const float* hp = h + row * f * (long long)d_in + k;
        const uint8_t* mp = mask + row * f;
        for (int j = 0; j < f; ++j) {
          sum = fmaf(hp[(long long)j * d_in], mp[j] ? 1.f : 0.f, sum);
        }
        sum /= cnt_s[rr];
      }
      mean_s[rr][e % kChunk] = sum;
    }
    for (int e = tid; e < kChunk * kCols; e += kThreads) {
      const int k = k0 + e / kCols;
      const int o = col0 + e % kCols;
      w_s[e / kCols][e % kCols] = (k < d_in && o < d_out) ? w[(long long)k * d_out + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float a = mean_s[r][k];
      const float4 wv = *reinterpret_cast<const float4*>(&w_s[k][c4]);
      acc0 = fmaf(a, wv.x, acc0);
      acc1 = fmaf(a, wv.y, acc1);
      acc2 = fmaf(a, wv.z, acc2);
      acc3 = fmaf(a, wv.w, acc3);
    }
    __syncthreads();
  }

  const long long row = row0 + r;
  if (row >= n) return;
  const float acc[4] = {acc0, acc1, acc2, acc3};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = col0 + c4 + q;
    if (o < d_out) out[row * d_out + o] = acc[q] + b[o];
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller guarantees shapes, fp32 and contiguity.
extern "C" int relation_agg_fwd(const float* h, const uint8_t* mask, const float* w,
                                const float* b, float* out, long long n, long long f,
                                long long d_in, long long d_out, void* stream) {
  if (n < 1 || f < 0 || d_in < 0 || d_out < 1 || f > 0x7fffffff || d_in > 0x7fffffff ||
      d_out > 0x7fffffff || (d_out + kCols - 1) / kCols > 65535 ||
      (n + kRows - 1) / kRows > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)((n + kRows - 1) / kRows), (unsigned)((d_out + kCols - 1) / kCols));
  relation_agg_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      h, mask, w, b, out, n, (int)f, (int)d_in, (int)d_out);
  return (int)cudaGetLastError();
}
