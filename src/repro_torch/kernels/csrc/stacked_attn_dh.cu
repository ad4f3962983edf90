// Backward of the fused attention AGG_r with respect to the neighbour
// activations h, for every branch slot of one metatree level, for sm_90a.
//
//   dh[s] = dz[s] @ we[us[0][s]]^T (+ dv[s] @ wv[us[1][s]]^T)
//   dz, dv [rb, n*f, H] -> dh [rb, n*f, d_in]
//
// Replaces the Pallas TPU kernel stacked_attn_dh_pallas (_attn_dh_kernel) in
// src/repro/kernels/stacked_relation_agg/kernel.py.  That kernel walked a grid
// (slot, node block, d_in block) and picked the weight block through a
// scalar-prefetched slot->stack index.
//
// What bounds it on an H100: at the training leaf level (rb, n, f, d_in,
// H = 6, 4096, 3, 128, 64) it reads dz (and dv) and writes dh, 57 MB for
// R-GAT (one product) and 75 MB for HGT (two), against 2 * n*f * d_in * H
// FMAs per product (1.2 GFLOP each): R-GAT sits at the byte bound, HGT just
// past it on the fp32 CUDA cores.
//
// Design:
//   * one block per (tile of 64 (row, neighbour) pairs, tile of 64 d_in
//     columns, slot): a plain tiled product per slot, the slot's weight read
//     straight from the [U, d_in, H] stack through us (no per-slot copy);
//   * per H chunk of block_in, the dz tile [64][block_in] and the transposed
//     weight tile [block_in][64] are staged in shared memory (both read along
//     H, so the loads coalesce; rows padded by one float against bank
//     conflicts), and each of the 256 threads accumulates a 4 x 4 register
//     tile with fp32 FMAs; with dv the second product accumulates into the
//     same registers;
//   * ragged n*f, d_in and H are masked inside the kernel: no padded copies.
// Later work (not here): wgmma/TMA, 16-byte stores of dh, bf16 storage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 64;     // (row, neighbour) pairs of one block
constexpr int kCols = 64;      // d_in columns of one block
constexpr int kMaxChunk = 64;  // largest H chunk (block_in)

template <bool kTwo>
__global__ void __launch_bounds__(kThreads) stacked_attn_dh_kernel(
    const float* __restrict__ dz, const float* __restrict__ dv,
    const float* __restrict__ we, const float* __restrict__ wv,
    const int* __restrict__ us, float* __restrict__ dh, int rb, long long pairs,
    int d_in, int H, int bc) {
  extern __shared__ float smem[];
  float* as = smem;                       // [kPairs][bc + 1]
  float* bs = as + kPairs * (bc + 1);     // [bc][kCols + 1]
  const int s = blockIdx.z;
  const long long p0 = (long long)blockIdx.x * kPairs;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int src = 0; src < (kTwo ? 2 : 1); ++src) {
    const float* g = (src == 0 ? dz : dv) + ((long long)s * pairs + p0) * H;
    const float* w = (src == 0 ? we : wv) + (long long)us[src * rb + s] * d_in * H;
    for (int k0 = 0; k0 < H; k0 += bc) {
      const int kk = min(bc, H - k0);
      for (int e = tid; e < kPairs * bc; e += kThreads) {
        const int m = e / bc, k = e % bc;
        as[m * (bc + 1) + k] =
            (p0 + m < pairs && k < kk) ? g[(long long)m * H + k0 + k] : 0.f;
      }
      for (int e = tid; e < kCols * bc; e += kThreads) {
        const int c = e / bc, k = e % bc;
        bs[k * (kCols + 1) + c] =
            (c0 + c < d_in && k < kk) ? w[(long long)(c0 + c) * H + k0 + k] : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kk; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[(tr + 16 * i) * (bc + 1) + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[k * (kCols + 1) + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = p0 + tr + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc + 16 * j;
      if (m < pairs && c < d_in) dh[((long long)s * pairs + m) * d_in + c] = acc[i][j];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  dv and wv
// are both null (one product) or both given.  The caller guarantees shapes,
// contiguity and 0 <= us[k][s] < the rows of the stack it indexes.
extern "C" int stacked_attn_dh(const float* dz, const float* dv, const float* we,
                               const float* wv, const int* us, float* dh, long long rb,
                               long long n, long long f, long long d_in, long long H,
                               int block_in, void* stream) {
  const bool two = dv != nullptr;
  const long long pairs = n * f;
  if (block_in < 1 || block_in > kMaxChunk || rb < 1 || rb > 65535 || n < 1 || f < 1 ||
      d_in < 1 || H < 1 || (dv == nullptr) != (wv == nullptr) ||
      (d_in + kCols - 1) / kCols > 65535 || (pairs + kPairs - 1) / kPairs > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(float) * ((size_t)kPairs * (block_in + 1) + (size_t)block_in * (kCols + 1));
  dim3 grid((unsigned)((pairs + kPairs - 1) / kPairs),
            (unsigned)((d_in + kCols - 1) / kCols), (unsigned)rb);
  if (two) {
    stacked_attn_dh_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        dz, dv, we, wv, us, dh, (int)rb, pairs, (int)d_in, (int)H, block_in);
  } else {
    stacked_attn_dh_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        dz, nullptr, we, nullptr, us, dh, (int)rb, pairs, (int)d_in, (int)H, block_in);
  }
  return (int)cudaGetLastError();
}
