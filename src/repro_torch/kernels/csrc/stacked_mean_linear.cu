// Stacked masked-mean + projection (the R-GCN AGG_r) for every branch slot
// of one metatree level, for sm_90a.
//
//   out[s, i, :] = (sum_j mask[s,i,j] * h[s,i,j,:]) / max(sum_j mask[s,i,j], 1)
//                  @ w[slot_u[s]] + b[slot_u[s]]
//
// Replaces the Pallas TPU kernel stacked_mean_linear_pallas
// (_mean_linear_kernel) in src/repro/kernels/stacked_relation_agg/kernel.py.
// That kernel walked a sequential grid (slot, node block, d_out block,
// d_in chunk) with a VMEM accumulator carried across d_in chunks and the
// weight block picked through a scalar-prefetched slot_u.
//
// What bounds it on an H100: memory.  Per destination row it reads
// f * d_in * 4 bytes of h (8 KB at f = 16, d_in = 128) against
// 2 * f * d_in + 2 * d_in * d_out operations (about 20 kFLOP), far below
// the ~20 FLOP/byte the fp32 CUDA cores need to become the limit.
//
// Design:
//   * one block per (tile of block_n node rows, tile of block_out output
//     columns, slot); blocks run in any order, so the d_in loop that the
//     TPU grid carried in scratch runs inside the block;
//   * the block reads slot_u[s] itself and offsets into the [U, d_in,
//     d_out] stack, so a weight shared by several slots is never copied
//     per slot;
//   * per d_in chunk of block_in columns, the masked mean of the tile is
//     built in shared memory in fp32 (neighbouring threads read
//     neighbouring h columns, so the reads of h coalesce), the matching
//     weight tile is staged in shared memory, and each thread accumulates
//     its outputs in registers with fp32 FMAs;
//   * ragged n, d_in and d_out are masked inside the kernel: no padded
//     copies of any operand.
// Later work (not here): 16-byte loads of h, TMA + wgmma, bf16 storage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAcc = 16;  // outputs per thread: block_n * block_out <= kThreads * kMaxAcc

__global__ void __launch_bounds__(kThreads) stacked_mean_linear_kernel(
    const float* __restrict__ h, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ b,
    const int* __restrict__ slot_u, float* __restrict__ out,
    long long n, int f, int d_in, int d_out, int bn, int bo, int bc) {
  extern __shared__ float smem[];
  float* mean_s = smem;           // [bn][bc]
  float* w_s = mean_s + bn * bc;  // [bc][bo]
  float* cnt_s = w_s + bc * bo;   // [bn]

  const int s = blockIdx.z;
  const long long row0 = (long long)blockIdx.x * bn;
  const int col0 = blockIdx.y * bo;
  const int tid = threadIdx.x;
  const int u = slot_u[s];
  const float* hs = h + (long long)s * n * f * d_in;
  const uint8_t* ms = mask + (long long)s * n * f;
  const float* wu = w + (long long)u * d_in * d_out;

  for (int r = tid; r < bn; r += kThreads) {
    const long long row = row0 + r;
    float c = 0.f;
    if (row < n) {
      for (int j = 0; j < f; ++j) c += ms[row * f + j] ? 1.f : 0.f;
    }
    cnt_s[r] = fmaxf(c, 1.f);
  }

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < d_in; c0 += bc) {
    for (int e = tid; e < bn * bc; e += kThreads) {
      const int r = e / bc;
      const int k = c0 + e % bc;
      const long long row = row0 + r;
      float sum = 0.f;
      if (row < n && k < d_in) {
        const float* hp = hs + row * f * d_in + k;
        const uint8_t* mp = ms + row * f;
        for (int j = 0; j < f; ++j) {
          sum = fmaf(hp[(long long)j * d_in], mp[j] ? 1.f : 0.f, sum);
        }
        sum /= cnt_s[r];
      }
      mean_s[e] = sum;
    }
    for (int e = tid; e < bc * bo; e += kThreads) {
      const int k = c0 + e / bo;
      const int o = col0 + e % bo;
      w_s[e] = (k < d_in && o < d_out) ? wu[(long long)k * d_out + o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < bn * bo) {
        const int r = e / bo;
        const int o = e % bo;
        const float* mrow = mean_s + r * bc;
        float a = acc[i];
        for (int k = 0; k < bc; ++k) a = fmaf(mrow[k], w_s[k * bo + o], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const float* bu = b + (long long)u * d_out;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < bn * bo) {
      const long long row = row0 + e / bo;
      const int o = col0 + e % bo;
      if (row < n && o < d_out) {
        out[((long long)s * n + row) * d_out + o] = acc[i] + bu[o];
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller guarantees shapes, contiguity and 0 <= slot_u[s] < U.
extern "C" int stacked_mean_linear_fwd(
    const float* h, const uint8_t* mask, const float* w, const float* b,
    const int* slot_u, float* out, long long rb, long long n, long long f,
    long long d_in, long long d_out, int block_n, int block_out, int block_in,
    void* stream) {
  if (block_n < 1 || block_out < 1 || block_in < 1 ||
      (long long)block_n * block_out > (long long)kThreads * kMaxAcc ||
      rb < 1 || rb > 65535 || n < 1 || d_out < 1 || d_in < 0 || f < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(float) * ((size_t)block_n * block_in + (size_t)block_in * block_out + block_n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stacked_mean_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)((n + block_n - 1) / block_n),
            (unsigned)((d_out + block_out - 1) / block_out), (unsigned)rb);
  stacked_mean_linear_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      h, mask, w, b, slot_u, out, n, (int)f, (int)d_in, (int)d_out, block_n,
      block_out, block_in);
  return (int)cudaGetLastError();
}
