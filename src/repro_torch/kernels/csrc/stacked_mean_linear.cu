// Stacked masked-mean + projection (the R-GCN AGG_r) for every branch slot
// of one metatree level, for sm_90a.
//
//   out[s, i, :] = (sum_j mask[s,i,j] * h[s,i,j,:]) / max(sum_j mask[s,i,j], 1)
//                  @ w[slot_u[s]] + b[slot_u[s]]
//
// Replaces the Pallas TPU kernel stacked_mean_linear_pallas
// (_mean_linear_kernel) in src/repro/kernels/stacked_relation_agg/kernel.py:100.
// That kernel walked a sequential grid (slot, node block, d_out block,
// d_in chunk) with a VMEM accumulator carried across d_in chunks and the
// weight block picked through a scalar-prefetched slot_u.
//
// What bounds it on an H100: at f = 1 (the attention models' query side)
// the fp32 product, 26 FLOP per byte, past the ~20 at which the CUDA cores
// (67 TFLOP/s) become the limit; at f >= 3 (R-GCN) the bytes of h (8 KB a
// row at f = 16, d_in = 128).  The first version lost to one torch.baddbmm
// by 3.9x at f = 1: one thread built each mean element from strided scalar
// loads, every 16-row block restaged the whole 32 KB weight with scalar
// loads, and its product issued one or two shared loads per FMA.
//
// Design: the kernel template of mean_linear.cuh (shared with relation_agg.cu,
// kernel 6, which runs it at one slot), on the "nn" core of fp32_tile.cuh.

#include "mean_linear.cuh"

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller guarantees shapes, contiguity and 0 <= slot_u[s] < U.
extern "C" int stacked_mean_linear_fwd(
    const float* h, const uint8_t* mask, const float* w, const float* b,
    const int* slot_u, float* out, long long rb, long long n, long long f,
    long long d_in, long long d_out, void* stream) {
  return mean_linear::forward<false>(h, mask, w, b, slot_u, out, rb, n, f, d_in, d_out,
                                     (cudaStream_t)stream);
}
