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
// What bounds it on an H100: the f-fold write of dh and the fp32 product.
// It writes rb*n*f*d_in*4 bytes of dh and reads rb*n*d_out*4 bytes of g plus
// the mask and the weights, against 2*rb*n*d_in*d_out operations: at the
// R-GCN leaf (f = 3, d_in 128, d_out 64) 10 FLOP per byte, bytes-bound; at
// the attention models' q side (f = 1) 26 FLOP per byte, bound by the fp32
// CUDA cores (67 TFLOP/s).  So the product has to run near the fp32 rate,
// which a kernel that issues a shared-memory load per FMA cannot do.
//
// Design: an fp32 GEMM on the CUDA cores, dmean = g @ w[u]^T per slot
// (M = rows, N = d_in, K = d_out), with a broadcast epilogue; the product
// is the "nt" core of fp32_tile.cuh (shared with stacked_attn_dh.cu).
//   * one block per (tile of BM = 128 rows, tile of BN = 64 d_in columns,
//     slot); 128 threads in 4 warps, each warp over 32 rows x 64 columns,
//     each thread owning an 8 x 8 register micro-tile (rows ly + 4 i,
//     columns 4 lx + j and 32 + 4 lx + j for lane (ly, lx) = (lane / 8,
//     lane % 8)); up to 3 blocks share an SM (no spills);
//   * the block reads slot_u[s] itself and stages that slot's weight slice
//     [BN][d_out] (as it lies in memory, 16-byte chunks XOR-swizzled by row)
//     in shared memory once, when d_out <= 128 (every path: d_out = 64); a
//     wider d_out is staged in 128-deep slices, one after the other;
//   * g streams through a two-stage ring of [BM][32] chunks (row-major, as g
//     lies in memory); both g and w are copied by cp.async (16-byte copies
//     when d_out % 4 == 0, else 4-byte; out-of-range elements zero-filled by
//     the copy itself), and the next g chunk is in flight while the current
//     one is multiplied;
//   * per 4-deep k step a thread reads 8 float4 of g (4 deep in each of its
//     8 rows) and 8 float4 of w (4 deep in each of its 8 columns): 16
//     16-byte loads feed 256 FMAs, against one load per FMA before.  A
//     16-byte load costs the shared memory 4 cycles a warp whatever the
//     addresses, so the loads per FMA, not bank conflicts, set the pace:
//     8 x 8 balances them with the FMA rate (8 x 4 left the kernel bound by
//     shared-memory loads).  The swizzle keeps the 8 column rows of w a warp
//     reads at once in 8 different bank groups;
//   * the epilogue takes cnt and the first 32 mask bits of each row from
//     shared memory (read from the mask while the first chunk is in
//     flight), scales by 1 / max(cnt, 1) and writes the f masked copies as
//     float4 stores (d_in % 4 == 0; scalar stores otherwise, chosen inside
//     the kernel);
//   * ragged n, d_in and d_out are masked in the kernel: no padded copies.
// Precision: full fp32 FMAs, no TF32 and no tensor cores (atol = rtol =
// 1e-5 against the plain version).  A 3xTF32 mma.sync version (each operand
// split into tf32 high and low parts, three products) was faster and inside
// 1e-5 of the plain version at every shape checked, but three training steps
// of Adam on the learnable tables amplified its low-bit differences past the
// card-vs-CPU 1e-5 on the embeddings (chip_smoke.py phase 8), so the product
// stays on the CUDA cores.  No atomics: every sum runs over d_out in
// increasing order, so the result is the same bit for bit from run to run.

#include "fp32_tile.cuh"

namespace {

using namespace fp32_tile;

constexpr int kBM = 128;  // rows of a block: 4 warps of 32 (RM = 8)
static_assert(kThreads == kBM, "one thread reads the mask row of each row");

__global__ void __launch_bounds__(kThreads, 3) stacked_mean_linear_dh_kernel(
    const float* __restrict__ g, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const int* __restrict__ slot_u,
    float* __restrict__ dh, long long n, int f, int d_in, int d_out, int kw) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                   // [kBN][kw], 16-byte chunks swizzled
  float* g_s = w_s + kBN * kw;         // [2][kBM][kAP]
  // per row: the count of visible neighbours and the mask bits of its first 32
  int* cnt_s = reinterpret_cast<int*>(g_s + 2 * kBM * kAP);  // [kBM]
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(cnt_s + kBM);  // [kBM]

  const int s = blockIdx.z;
  const int col0 = blockIdx.y * kBN;
  const long long row0 = (long long)blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int rbase = tile_row<8>();  // this thread's rows rbase + 4 i
  const int cbase = tile_col();     // columns cbase + 32 h + j
  const int u = slot_u[s];
  const uint8_t* ms = mask + (long long)s * n * f;
  const float* const gs[1] = {g + (long long)s * n * d_out};
  const float* const wu[1] = {w + (long long)u * d_in * d_out};
  const bool vec_g = d_out % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const bool vec_w = d_out % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool vec_dh = d_in % 4 == 0 && reinterpret_cast<uintptr_t>(dh) % 16 == 0;

  float acc[8][8] = {};  // [row i][32-column half h * 4 + j]
  // the block's mask rows, read while the first copies are in flight
  accumulate_nt<8, 1>(acc, w_s, g_s, gs, wu, n, row0, d_in, col0, d_out, kw, vec_g, vec_w,
                      [&] {
    const long long row = row0 + tid;  // kThreads == kBM
    int cnt = 0;
    uint32_t bits = 0;
    if (row < n) {
      const uint8_t* mp = ms + row * f;
      for (int j = 0; j < f; ++j) {
        const int m = mp[j] ? 1 : 0;
        cnt += m;
        if (j < 32) bits |= (uint32_t)m << j;
      }
    }
    cnt_s[tid] = max(cnt, 1);
    bits_s[tid] = bits;
  });

  // the epilogue: f masked copies of each row's mean gradient
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rbase + 4 * i;
    const long long row = row0 + r;
    if (row >= n) continue;
    const float inv = 1.f / (float)cnt_s[r];
    const uint32_t bits = bits_s[r];
    const uint8_t* mp = ms + row * f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + cbase + 32 * h;
      if (col >= d_in) continue;
      const float4 dm = make_float4(acc[i][4 * h] * inv, acc[i][4 * h + 1] * inv,
                                    acc[i][4 * h + 2] * inv, acc[i][4 * h + 3] * inv);
      float* out = dh + ((long long)s * n + row) * f * d_in + col;
      for (int j = 0; j < f; ++j) {
        const float m = (j < 32 ? (bits >> j) & 1u : mp[j]) ? 1.f : 0.f;
        const float4 v = make_float4(dm.x * m, dm.y * m, dm.z * m, dm.w * m);
        float* o = out + (long long)j * d_in;
        if (vec_dh) {
          *reinterpret_cast<float4*>(o) = v;
        } else {
          o[0] = v.x;
          if (col + 1 < d_in) o[1] = v.y;
          if (col + 2 < d_in) o[2] = v.z;
          if (col + 3 < d_in) o[3] = v.w;
        }
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller guarantees shapes, contiguity and 0 <= slot_u[s] < U.
extern "C" int stacked_mean_linear_dh(
    const float* g, const uint8_t* mask, const float* w, const int* slot_u,
    float* dh, long long rb, long long n, long long f, long long d_in,
    long long d_out, void* stream) {
  if (rb < 1 || rb > 65535 || n < 1 || f < 1 || d_in < 1 || d_out < 0 ||
      d_in > 0x7fffffffLL || d_out > 0x7fffffffLL || f > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int kw = slice_depth(d_out);
  const size_t smem = smem_bytes(8, kw, 2 * kBM * sizeof(int));
  const long long gx = (n + kBM - 1) / kBM;
  if (gx > 0x7fffffffLL || (d_in + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stacked_mean_linear_dh_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)gx, (unsigned)((d_in + kBN - 1) / kBN), (unsigned)rb);
  stacked_mean_linear_dh_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      g, mask, w, slot_u, dh, n, (int)f, (int)d_in, (int)d_out, kw);
  return (int)cudaGetLastError();
}
