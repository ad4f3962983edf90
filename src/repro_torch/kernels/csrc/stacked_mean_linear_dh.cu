// Backward of the stacked masked-mean + projection with respect to the
// neighbour activations h, for every branch slot of one metatree level, for
// sm_90a.
//
//   dh[s, i, j, :] = (g[s, i, :] @ w[slot_u[s]]^T) / max(sum_j mask[s,i,j], 1)
//                    * mask[s, i, j]
//
// Replaces the Pallas TPU kernel stacked_mean_linear_dh_pallas
// (_mean_linear_dh_kernel) in src/repro/kernels/stacked_relation_agg/kernel.py.
// That kernel walked a sequential grid (slot, node block, d_in block, d_out
// chunk) with a VMEM accumulator carried across the d_out chunks and the
// weight block picked through a scalar-prefetched slot_u.
//
// What bounds it on an H100: memory.  It writes rb*n*f*d_in*4 bytes of dh
// and reads rb*n*d_out*4 bytes of g plus the mask and the weights, against
// 2*rb*n*d_in*d_out operations: at d_out = 64 and f = 3 that is about
// 10 FLOP per byte, below the ~20 the fp32 CUDA cores need to become the
// limit.  The f-fold broadcast write of dh is most of the traffic.
//
// Design:
//   * one block per (tile of block_n node rows, tile of block_in input
//     columns, slot); blocks run in any order, so the d_out axis that the
//     TPU grid carried in scratch is a loop inside the block;
//   * the block reads slot_u[s] itself and offsets into the [U, d_in, d_out]
//     stack: no per-slot copy of a weight;
//   * per d_out chunk of block_out columns, the g tile [block_n, block_out]
//     and the weight tile [block_in, block_out] are staged in shared memory
//     (both read along d_out, so the loads coalesce; the weight tile's rows
//     are padded by one float so that neighbouring columns fall in
//     different banks), and each thread accumulates
//     dmean[r, c] = sum_o g[r, o] * w[c, o] in fp32 registers for one column
//     c and up to kMaxRows rows, reusing its weight value across the rows;
//   * the sum is divided by max(cnt, 1), cnt counted from the mask row as
//     the forward kernel does, and written f times, masked:
//     dh[s, r, j, c] = dmean[r, c] * mask[s, r, j]; neighbouring threads own
//     neighbouring c, so every store of a warp is one contiguous run;
//   * ragged n, d_in and d_out are masked inside the kernel: no padded
//     copies of any operand (the reference pads and slices).
// Later work (not here): 16-byte stores, wgmma/TMA for the product, bf16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 16;  // rows per thread: block_n <= kMaxRows * (kThreads / block_in)

__global__ void __launch_bounds__(kThreads) stacked_mean_linear_dh_kernel(
    const float* __restrict__ g, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const int* __restrict__ slot_u,
    float* __restrict__ dh, long long n, int f, int d_in, int d_out, int bn,
    int bo, int bc) {
  extern __shared__ float smem[];
  const int ws = bo + 1;             // padded weight-tile row
  float* g_s = smem;                 // [bn][bo]
  float* w_s = g_s + bn * bo;        // [bc][bo + 1]
  float* cnt_s = w_s + bc * ws;      // [bn]

  const long long row0 = (long long)blockIdx.x * bn;
  const int col0 = blockIdx.y * bc;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int lanes = kThreads / bc;   // row lanes; bc divides kThreads
  const int c = tid % bc;
  const int r0 = tid / bc;
  const int u = slot_u[s];
  const float* gs = g + (long long)s * n * d_out;
  const uint8_t* ms = mask + (long long)s * n * f;
  const float* wu = w + (long long)u * d_in * d_out;

  for (int r = tid; r < bn; r += kThreads) {
    const long long row = row0 + r;
    float cnt = 0.f;
    if (row < n) {
      for (int j = 0; j < f; ++j) cnt += ms[row * f + j] ? 1.f : 0.f;
    }
    cnt_s[r] = fmaxf(cnt, 1.f);
  }

  float acc[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) acc[i] = 0.f;

  for (int o0 = 0; o0 < d_out; o0 += bo) {
    for (int e = tid; e < bn * bo; e += kThreads) {
      const long long row = row0 + e / bo;
      const int o = o0 + e % bo;
      g_s[e] = (row < n && o < d_out) ? gs[row * d_out + o] : 0.f;
    }
    for (int e = tid; e < bc * bo; e += kThreads) {
      const int k = e / bo;
      const int o = e % bo;
      const int col = col0 + k;
      w_s[k * ws + o] =
          (col < d_in && o0 + o < d_out) ? wu[(long long)col * d_out + o0 + o] : 0.f;
    }
    __syncthreads();
    for (int o = 0; o < bo; ++o) {
      const float wv = w_s[c * ws + o];
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        const int r = r0 + i * lanes;
        if (r < bn) acc[i] = fmaf(g_s[r * bo + o], wv, acc[i]);
      }
    }
    __syncthreads();
  }

  const int col = col0 + c;
  if (col >= d_in) return;
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int r = r0 + i * lanes;
    const long long row = row0 + r;
    if (r < bn && row < n) {
      const float dmean = acc[i] / cnt_s[r];
      const uint8_t* mp = ms + row * f;
      float* out = dh + ((long long)s * n + row) * f * d_in + col;
      for (int j = 0; j < f; ++j) out[(long long)j * d_in] = dmean * (mp[j] ? 1.f : 0.f);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller guarantees shapes, contiguity and 0 <= slot_u[s] < U.
extern "C" int stacked_mean_linear_dh(
    const float* g, const uint8_t* mask, const float* w, const int* slot_u,
    float* dh, long long rb, long long n, long long f, long long d_in,
    long long d_out, int block_n, int block_out, int block_in, void* stream) {
  if (block_n < 1 || block_out < 1 || block_in < 1 || block_in > kThreads ||
      kThreads % block_in != 0 ||
      (long long)block_n > (long long)kMaxRows * (kThreads / block_in) ||
      rb < 1 || rb > 65535 || n < 1 || f < 1 || d_in < 1 || d_out < 0 ||
      (d_in + block_in - 1) / block_in > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * ((size_t)block_n * block_out +
                                       (size_t)block_in * (block_out + 1) + block_n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stacked_mean_linear_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)((n + block_n - 1) / block_n),
            (unsigned)((d_in + block_in - 1) / block_in), (unsigned)rb);
  stacked_mean_linear_dh_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      g, mask, w, slot_u, dh, n, (int)f, (int)d_in, (int)d_out, block_n,
      block_out, block_in);
  return (int)cudaGetLastError();
}
