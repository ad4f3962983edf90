// Masked softmax over the fanout + head-wise combine, for every branch slot
// of one metatree level (the attention epilogue of R-GAT and HGT when the
// logit and value projections run outside the kernel), for sm_90a.
//
//   alpha[s,i,j,h] = masked_softmax_j(e[s,i,:,h], mask[s,i,:])
//   out[s,i,h*dh+d] = sum_j alpha[s,i,j,h] * v[s,i,j,h*dh+d]
//
// Replaces the Pallas TPU kernel stacked_softmax_combine_pallas
// (_softmax_combine_kernel) in
// src/repro/kernels/stacked_relation_agg/kernel.py, whose grid (slot, node
// block) held a [bn, f, nh*dh] block of v in VMEM so that the attention
// probabilities never reached HBM.
//
// Numerics are relmod.masked_softmax's, step for step: masked logits are
// replaced by the float32 minimum, the max over f is subtracted, z =
// exp(e - max) * mask, alpha = z / max(sum z, 1e-9); a fully masked row
// therefore gives alpha = 0 and out = 0, never NaN.
//
// What bounds it on an H100: memory.  Per (row, column) it reads f values
// of v and does about 4 f operations; e and the mask are f * nh and f
// values per row, shared by the dh columns of a head.  At the training
// leaf (rb, n, f, nh, dh) = (6, 4096, 3, 4, 16) the call moves about 26 MB
// (v 18.9, out 6.3, e 1.2), some 7.9 us of HBM time.
//
// Design: one block of 256 threads per (tile of rows, slot).  A tile
// holds max(1, 256 / H) destination rows (H = nh * dh) and the threads run
// over its (row, column) pairs, so neighbouring threads read neighbouring
// columns of v (coalesced) and the dh threads of one head read the same
// logits (a broadcast).  f is a loop, not a block dimension, so any fanout
// works: each thread takes the max over f of its head's masked logits,
// then sum z, then sum (z / max(sum z, 1e-9)) * v, re-reading the logits
// (f * nh values per row, from L1) rather than holding them.  Ragged n is
// masked inside the kernel.
// Later work (not here): 16-byte loads of v, bf16 storage.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) stacked_softmax_combine_kernel(
    const float* __restrict__ e, const uint8_t* __restrict__ mask,
    const float* __restrict__ v, float* __restrict__ out, long long n, int f, int nh,
    int dh, int rows) {
  const int s = blockIdx.y;
  const int H = nh * dh;
  const long long row0 = (long long)blockIdx.x * rows;
  for (int p = threadIdx.x; p < rows * H; p += kThreads) {
    const long long row = row0 + p / H;
    if (row >= n) break;  // p only grows, and so does its row
    const int col = p % H;
    const int head = col / dh;
    const long long sr = (long long)s * n + row;  // (slot, row) index
    const uint8_t* m = mask + sr * f;
    const float* ep = e + sr * f * nh + head;
    const float* vp = v + sr * f * H + col;
    float mx = -FLT_MAX;
    for (int j = 0; j < f; ++j) mx = fmaxf(mx, m[j] ? ep[(long long)j * nh] : -FLT_MAX);
    float sum = 0.f;
    for (int j = 0; j < f; ++j) {
      const float em = m[j] ? ep[(long long)j * nh] : -FLT_MAX;
      sum += expf(em - mx) * (m[j] ? 1.f : 0.f);
    }
    const float denom = fmaxf(sum, 1e-9f);
    float acc = 0.f;
    for (int j = 0; j < f; ++j) {
      if (!m[j]) continue;  // alpha is exactly 0 there
      const float z = expf(ep[(long long)j * nh] - mx);
      acc = fmaf(z / denom, vp[(long long)j * H], acc);
    }
    out[sr * H + col] = acc;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller guarantees shapes, fp32, contiguity and rows = max(1, 256 / H).
extern "C" int stacked_softmax_combine_fwd(const float* e, const uint8_t* mask,
                                           const float* v, float* out, long long rb,
                                           long long n, long long f, long long nh,
                                           long long dh, int rows, void* stream) {
  if (rb < 1 || rb > 65535 || n < 1 || f < 0 || nh < 1 || dh < 1 || rows < 1 ||
      f > 0x7fffffff || nh * dh > 0x7fffffff || (long long)rows * nh * dh > 0x7fffffff ||
      (n + rows - 1) / rows > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)((n + rows - 1) / rows), (unsigned)rb);
  stacked_softmax_combine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      e, mask, v, out, n, (int)f, (int)nh, (int)dh, rows);
  return (int)cudaGetLastError();
}
