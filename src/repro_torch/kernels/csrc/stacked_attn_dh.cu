// Backward of the fused attention AGG_r with respect to the neighbour
// activations h, for every branch slot of one metatree level, for sm_90a.
//
//   dh[s] = dz[s] @ we[us[0][s]]^T (+ dv[s] @ wv[us[1][s]]^T)
//   dz, dv [rb, n*f, H] -> dh [rb, n*f, d_in]
//
// Replaces the Pallas TPU kernel stacked_attn_dh_pallas (_attn_dh_kernel) in
// src/repro/kernels/stacked_relation_agg/kernel.py:452.  That kernel walked a
// grid (slot, node block, d_in block) and picked the weight block through a
// scalar-prefetched slot->stack index.
//
// What bounds it on an H100: the fp32 product.  At the training leaf (rb, n,
// f, d_in, H = 6, 4096, 3, 128, 64) it reads dz (and dv) and writes dh, 57 MB
// for R-GAT (one product) and 75 MB for HGT (two), against 2 * n*f * d_in * H
// FLOP per product (1.2 GFLOP each): 21-32 FLOP per byte, at or past the ~20
// at which the fp32 CUDA cores (67 TFLOP/s) become the limit.  So the product
// has to run near the fp32 rate, which the first version (a 4 x 4 register
// tile fed by 8 scalar shared loads per 16 FMAs, two barriers per 32-deep
// chunk and no load in flight during the FMAs) could not: it lost to one
// torch.bmm by 1.2-2.4x.
//
// Design: kernel 2's product (stacked_mean_linear_dh.cu) without its masked
// broadcast, on the "nt" core of fp32_tile.cuh: M = the n*f pairs, N = d_in,
// K = H; A = dz as it lies ([pairs][H]), B^T = we[u] as it lies ([d_in][H]).
//   * one block per (tile of 16 * RM pairs, tile of 64 d_in columns, slot),
//     128 threads, each owning an RM x 8 register micro-tile fed by 16-byte
//     shared loads (RM = 8: 16 loads per 256 FMAs); RM = 8 when 128-pair
//     tiles give each of the 132 SMs a block (the leaves: 1152 blocks), else
//     4 (the tops, 3 x 4096 pairs: 192 blocks instead of 96), else 1, chosen
//     from the shape in the C entry point (64-pair tiles at the leaves, for
//     more warps an SM, ran the HGT leaf 19 % slower);
//   * the block reads its slots itself and stages the weight slices once, by
//     cp.async, as they lie in memory, XOR-swizzled against bank conflicts;
//     with dv both products share one virtual depth: we's H then wv's H,
//     each padded to 32-deep chunks, so both slices stay resident (2 x 64 x
//     H floats, 32 KB at H = 64) while the virtual depth is at most 128; a
//     deeper one (H > 64 with dv, H > 128 without) is restaged in 128-deep
//     slices;
//   * dz (then dv) streams through a two-stage cp.async ring of [16 RM][32]
//     chunks, the next chunk in flight while the current one is multiplied;
//   * dh is written with float4 stores when d_in % 4 == 0, scalar stores
//     otherwise (4-byte copies when H % 4 != 0), chosen inside the kernel;
//     ragged pairs, d_in and H are masked in the kernel: no padded copies.
// Precision: full fp32 FMAs, each output summed over dz's k, then dv's, in
// increasing order inside one thread; no TF32, no tensor cores (a 3xTF32
// mma.sync version of kernel 2 passed 1e-5 at the kernel but failed the
// card-vs-CPU 1e-5 after three Adam steps, chip_smoke.py phase 8), no
// atomics, so the result is the same bit for bit from run to run.

#include "fp32_tile.cuh"

namespace {

using namespace fp32_tile;

template <int RM, int NSRC>
__global__ void __launch_bounds__(kThreads, 3) stacked_attn_dh_kernel(
    const float* __restrict__ dz, const float* __restrict__ dv,
    const float* __restrict__ we, const float* __restrict__ wv,
    const int* __restrict__ us, float* __restrict__ dh, int rb, long long pairs,
    int d_in, int H, int kw) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                // [kBN][kw], 16-byte chunks swizzled
  float* a_s = w_s + kBN * kw;      // [2][16 RM][kAP]
  const int s = blockIdx.z;
  const int col0 = blockIdx.y * kBN;
  const long long row0 = (long long)blockIdx.x * 16 * RM;
  const float* a[NSRC];
  const float* w[NSRC];
  a[0] = dz + (long long)s * pairs * H;
  w[0] = we + (long long)us[s] * d_in * H;
  if (NSRC == 2) {
    a[NSRC - 1] = dv + (long long)s * pairs * H;
    w[NSRC - 1] = wv + (long long)us[rb + s] * d_in * H;
  }
  const bool vec_a = H % 4 == 0 && reinterpret_cast<uintptr_t>(dz) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(NSRC == 2 ? dv : dz) % 16 == 0;
  const bool vec_w = H % 4 == 0 && reinterpret_cast<uintptr_t>(we) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(NSRC == 2 ? wv : we) % 16 == 0;
  const bool vec_dh = d_in % 4 == 0 && reinterpret_cast<uintptr_t>(dh) % 16 == 0;

  float acc[RM][8] = {};  // [row i][32-column half h * 4 + j]
  accumulate_nt<RM, NSRC>(acc, w_s, a_s, a, w, pairs, row0, d_in, col0, H, kw, vec_a,
                          vec_w, [] {});

  const int rbase = tile_row<RM>(), cbase = tile_col();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long row = row0 + rbase + 4 * i;
    if (row >= pairs) continue;
    float* out = dh + ((long long)s * pairs + row) * d_in;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + cbase + 32 * h;
      if (col >= d_in) continue;
      if (vec_dh) {
        *reinterpret_cast<float4*>(out + col) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < d_in) out[col + j] = acc[i][4 * h + j];
        }
      }
    }
  }
}

template <int RM, int NSRC>
int launch(const float* dz, const float* dv, const float* we, const float* wv, const int* us,
           float* dh, long long rb, long long pairs, long long d_in, long long H, int kw,
           dim3 grid, cudaStream_t stream) {
  const size_t smem = smem_bytes(RM, kw, 0);
  cudaError_t err = cudaFuncSetAttribute(stacked_attn_dh_kernel<RM, NSRC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stacked_attn_dh_kernel<RM, NSRC><<<grid, kThreads, smem, stream>>>(
      dz, dv, we, wv, us, dh, (int)rb, pairs, (int)d_in, (int)H, kw);
  return (int)cudaGetLastError();
}

template <int NSRC>
int launch_rm(int rm, const float* dz, const float* dv, const float* we, const float* wv,
              const int* us, float* dh, long long rb, long long pairs, long long d_in,
              long long H, int kw, long long col_tiles, cudaStream_t stream) {
  const long long gx = (pairs + 16 * rm - 1) / (16 * rm);
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)col_tiles, (unsigned)rb);
  if (rm == 8) return launch<8, NSRC>(dz, dv, we, wv, us, dh, rb, pairs, d_in, H, kw, grid, stream);
  if (rm == 4) return launch<4, NSRC>(dz, dv, we, wv, us, dh, rb, pairs, d_in, H, kw, grid, stream);
  return launch<1, NSRC>(dz, dv, we, wv, us, dh, rb, pairs, d_in, H, kw, grid, stream);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  dv and wv
// are both null (one product) or both given.  The caller guarantees shapes,
// contiguity and 0 <= us[k][s] < the rows of the stack it indexes.
extern "C" int stacked_attn_dh(const float* dz, const float* dv, const float* we,
                               const float* wv, const int* us, float* dh, long long rb,
                               long long n, long long f, long long d_in, long long H,
                               void* stream) {
  const long long pairs = n * f;
  const long long col_tiles = (d_in + kBN - 1) / kBN;
  if (rb < 1 || rb > 65535 || n < 1 || f < 1 || d_in < 1 || H < 1 ||
      d_in > 0x7fffffffLL || H > 0x3fffffffLL || (dv == nullptr) != (wv == nullptr) ||
      col_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bool two = dv != nullptr;
  const long long depth = (two ? 2 : 1) * ((H + kKC - 1) / kKC * kKC);  // the virtual depth
  const int kw = slice_depth(depth);
  const int rm = rows_per_thread(rb, pairs, col_tiles, 8);
  cudaStream_t st = (cudaStream_t)stream;
  return two ? launch_rm<2>(rm, dz, dv, we, wv, us, dh, rb, pairs, d_in, H, kw, col_tiles, st)
             : launch_rm<1>(rm, dz, nullptr, we, nullptr, us, dh, rb, pairs, d_in, H, kw,
                            col_tiles, st);
}
