// Masked-mean neighbour aggregation + projection of ONE relation (the
// R-GCN AGG_r of the dict-form executors), for sm_90a.
//
//   out[i, :] = (sum_j mask[i,j] * h[i,j,:]) / max(sum_j mask[i,j], 1) @ w + b
//
// Replaces the Pallas TPU kernel relation_agg_pallas (_kernel) in
// src/repro/kernels/relation_agg/kernel.py:64.  That kernel walked a
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
// What held the first version back (0.36 TB/s at that shape): it was
// kernel 1's first design, which lost 3.9x to torch.baddbmm: each mean
// element summed over f from strided 4-byte loads of h, every 16-row block
// restaged the whole weight slice with scalar loads (at n = 4096 more L2
// reads of w than bytes of h), two shared loads fed four FMAs, and no load
// overlapped an FMA (two barriers per 64-deep chunk).
//
// Design: kernel 1's, which computes exactly this function per slot: the
// kernel template of mean_linear.cuh in its compile-time single-slot form
// (u = 0, no slot_u), on the "nn" register-tiled fp32 core of
// fp32_tile.cuh.  The weight slice is staged once per block by cp.async,
// the raw neighbour rows stream through a cp.async ring as 16-byte copies
// (4-byte when d_in % 4 or h's base is off the 16-byte grid, chosen in the
// kernel) and are reduced from shared memory, and an RM x 8 micro-tile a
// thread runs the product; RM comes from the shape (rows_per_thread: 1 at
// every dict-form shape, 16-row tiles, 64-256 blocks).  Ragged n, f, d_in
// and d_out are masked in the kernel; an all-masked row gives b.  The
// arithmetic is the first version's (the mean summed over j in order and
// divided, each output summed over d_in in order in one thread, b added
// last), so the outputs equal its outputs and kernel 1's at one slot, bit
// for bit.  On the card (variants timed in one call, H100): at 16-row tiles
// the product is bound by shared loads of the weight (8 16-byte loads per
// 32 FMAs; 4.8 us at (4096, 3, 128, 64)) and, in series with it, the
// neighbour rows' arrival (4.9 us); 32- and 64-row tiles leave SMs idle and
// run slower; the eager time at every dict-form shape is mostly the host's
// launch.

#include "mean_linear.cuh"

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller guarantees shapes, fp32 and contiguity.
extern "C" int relation_agg_fwd(const float* h, const uint8_t* mask, const float* w,
                                const float* b, float* out, long long n, long long f,
                                long long d_in, long long d_out, void* stream) {
  return mean_linear::forward<true>(h, mask, w, b, nullptr, out, 1, n, f, d_in, d_out, 0,
                                    (cudaStream_t)stream);
}
