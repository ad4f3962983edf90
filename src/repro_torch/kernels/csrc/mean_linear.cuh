// The masked-mean + projection kernel shared by stacked_mean_linear.cu
// (kernel 1: every branch slot of one metatree level, each slot's weight
// picked through slot_u) and relation_agg.cu (kernel 6: one relation, one
// weight), for sm_90a.  Both compute, per slot s,
//
//   out[s, i, :] = (sum_j mask[s,i,j] * h[s,i,j,:]) / max(sum_j mask[s,i,j], 1)
//                  @ w[u] + b[u]
//
// with u = slot_u[s] (ONE = false) or u = 0 and a single slot (ONE = true:
// the compile-time single-slot form reads no slot_u).
//
// Design: an fp32 GEMM on the CUDA cores per slot, M = rows, N = d_out,
// K = d_in, on the "nn" core of fp32_tile.cuh, whose A tile is the mean:
//   * one block per (tile of 16 * RM rows, tile of 64 d_out columns, slot),
//     128 threads, each owning an RM x 8 register micro-tile fed by 16-byte
//     shared loads (12 loads per 128 FMAs at RM = 4); d_out = 64 on every
//     path, so the rows supply the blocks: RM = 4 when 64-row tiles give each
//     of the 132 SMs a block (the leaves, 24,576 rows: 384 blocks, three an
//     SM), else 1 (the tops and serving blocks, 2,048-3,072 rows: 128-192
//     blocks of 16 rows instead of 16-24 of 128), chosen from the shape in
//     the C entry point unless the caller passes RM (the tuning table's
//     launch parameter; layout_rm).  At the leaves 128-row tiles (8 x 8 a thread) left
//     too few warps an SM to hide latency: 0.022 against 0.019 ms at f = 1,
//     0.047 against 0.037 at f = 3.  No split of K across blocks: a
//     cross-block sum would need atomics or a second pass;
//   * the block reads slot_u[s] itself (ONE: u = 0) and stages w[u]'s slice
//     [d_in][64] once, by cp.async, as it lies in memory (a quarter-warp reads 8
//     consecutive float4 of one row: 8 bank groups, no swizzle needed);
//     d_in up to 128 stays resident (every path), a deeper d_in is restaged
//     in 128-deep slices;
//   * the A tile, 32 d_in columns deep: at f = 1 the mean is h itself (the
//     mask bit scales the row's output), so h streams straight through a
//     two-stage cp.async ring, the next chunk in flight while the current one
//     is multiplied; at f > 1 the block builds it from the raw neighbour rows,
//     which stream through a cp.async ring of 16 KB stages (16 RM rows x 8 /
//     RM neighbours x 32 columns; 8 neighbouring threads copy one row's
//     128-byte segment), one stage in flight at RM = 4 (two stages keep
//     three blocks on an SM: 73 KB) and three at RM = 1: each thread sums its
//     RM float4 columns over the stage's neighbours from shared memory
//     (masked by bits held there), and after a chunk's last stage divides by
//     max(cnt, 1) into the mean tile, which is then multiplied while the
//     next stages are in flight (a register-fed mean without the ring ran
//     0.077 ms at the R-GCN leaf: too few loads in flight);
//   * the epilogue adds b[u] and writes float4 stores when d_out % 4 == 0,
//     scalar stores otherwise, chosen inside the kernel; ragged n, f, d_in
//     and d_out are masked in the kernel: no padded copies.
// Precision: full fp32 FMAs; the mean is summed over j in order and divided,
// each output summed over d_in in increasing order inside one thread: the
// first version's arithmetic, whose outputs these equal.  No TF32, no tensor
// cores (a 3xTF32 mma.sync version of kernel 2 passed 1e-5 at the kernel but
// failed the card-vs-CPU 1e-5 after three Adam steps, chip_smoke.py phase
// 8), no atomics, so the result is the same bit for bit from run to run.

#pragma once

#include "fp32_tile.cuh"

namespace mean_linear {

using namespace fp32_tile;

// f > 1: raw neighbour rows stream through a ring of kRaw-float stages,
// each [16 RM rows][FG neighbours][32 columns] of one d_in chunk: two
// stages at RM = 4 (three blocks an SM), four at RM = 1
constexpr int kRaw = 4096;
template <int RM, bool F1>
struct Ring {
  static constexpr int kStages = F1 ? 0 : RM >= 4 ? 2 : 4;
};

template <int RM, bool F1, bool ONE>
__global__ void __launch_bounds__(kThreads, 3) mean_linear_kernel(
    const float* __restrict__ h, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ b,
    const int* __restrict__ slot_u, float* __restrict__ out,
    long long n, int f, int d_in, int d_out, int kw) {
  constexpr int BM = 16 * RM;
  constexpr int S = Ring<RM, F1>::kStages;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                          // [kw][kBN]
  float* a_s = w_s + kw * kBN;                // [F1 ? 2 : 1][BM][kAP]: the mean
  float* raw_s = a_s + (F1 ? 2 : 1) * BM * kAP;  // f > 1: [S][kRaw]
  int* cnt_s = reinterpret_cast<int*>(raw_s + S * kRaw);  // [BM] visible neighbours
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(cnt_s + BM);  // [BM] first 32 mask bits

  const int s = blockIdx.z;
  const int col0 = blockIdx.y * kBN;
  const long long row0 = (long long)blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int u = ONE ? 0 : slot_u[s];  // one slot: the weight itself
  const float* hs = h + (long long)s * n * f * d_in;
  const uint8_t* ms = mask + (long long)s * n * f;
  const float* wu = w + (long long)u * d_in * d_out;
  const int nk = max(1, (d_in + kKC - 1) / kKC);  // A chunks
  const int nkw = kw / kKC;                     // A chunks per weight slice
  const bool vec_h = d_in % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const bool vec_w = d_out % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool vec_out = d_out % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  // f > 1: FG neighbours a stage (a fixed count, so the copy and reduce
  // loops unroll; slots past f are neither copied nor read), ng stages a
  // chunk, nt in all
  constexpr int FG = F1 ? 1 : kRaw / (BM * kKC);
  static_assert(FG >= 1, "a raw stage holds at least one neighbour row per row");
  const int ng = max(1, (f + FG - 1) / FG);
  const int nt = nk * ng;

  // f > 1: stage t's raw rows h[row][j][k0 .. k0 + 32] (chunk t / ng,
  // neighbours (t % ng) * FG ..) as raw[r][jj][32], one cp.async group;
  // out-of-range elements zero-filled by the copy itself
  auto stage_raw = [&](int t) {
    if (t >= nt) {
      cp_async_commit();  // an empty group keeps the wait counts uniform
      return;
    }
    const int k0 = (t / ng) * kKC, j0 = (t % ng) * FG;
    float* dst = raw_s + (t % S) * kRaw;
    if (vec_h) {
#pragma unroll
      for (int e = tid; e < BM * FG * (kKC / 4); e += kThreads) {
        const int r = e / (FG * (kKC / 4)), jj = e / (kKC / 4) % FG, c = (e % (kKC / 4)) * 4;
        if (j0 + jj >= f) continue;
        const long long row = row0 + r;
        const bool in = row < n && k0 + c < d_in;
        cp_async16(dst + (r * FG + jj) * kKC + c,
                   in ? hs + (row * f + j0 + jj) * d_in + k0 + c : hs, in);
      }
    } else {
      for (int e = tid; e < BM * FG * kKC; e += kThreads) {
        const int r = e / (FG * kKC), jj = e / kKC % FG, c = e % kKC;
        if (j0 + jj >= f) continue;
        const long long row = row0 + r;
        const bool in = row < n && k0 + c < d_in;
        cp_async4(dst + (r * FG + jj) * kKC + c,
                  in ? hs + (row * f + j0 + jj) * d_in + k0 + c : hs, in);
      }
    }
    cp_async_commit();
  };

  stage_w_nn(w_s, wu, d_in, d_out, col0, 0, kw, vec_w);
  if (F1) {
    stage_a<RM>(a_s, hs, n, row0, d_in, 0, 0, vec_h);  // f = 1: h rows are the A rows
  } else {
    for (int t = 0; t < S - 1; ++t) stage_raw(t);
  }
  // the block's mask rows, read while the first copies are in flight
  for (int r = tid; r < BM; r += kThreads) {
    const long long row = row0 + r;
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
    cnt_s[r] = cnt;
    bits_s[r] = bits;
  }

  float acc[RM][8] = {};  // [row i][32-column half h * 4 + j]
  if (F1) {
    for (int q = 0; q < nk; ++q) {
      // a deeper d_in restages the weight slice (the previous iteration's
      // closing barrier has freed it) and drains the copies in flight
      const bool restage = q > 0 && q % nkw == 0;
      if (restage) stage_w_nn(w_s, wu, d_in, d_out, col0, q * kKC, kw, vec_w);
      if (q + 1 < nk) stage_a<RM>(a_s, hs, n, row0, d_in, (q + 1) * kKC, (q + 1) % 2, vec_h);
      else cp_async_commit();
      if (restage) cp_async_wait<0>();
      else cp_async_wait<1>();
      __syncthreads();  // chunk q (and the weight slice, the mask rows) visible to all
      product_nn<RM>(acc, a_s + (q % 2) * BM * kAP, w_s, (q % nkw) * kKC);
      __syncthreads();  // ring slot q % 2 (and the weight slice) free again
    }
  } else {
    // this thread sums the float4 column c of rows r0 + 16 o (o < RM)
    const int r0 = tid / 8, c = (tid % 8) * 4;
    float4 sum[RM];
#pragma unroll
    for (int o = 0; o < RM; ++o) sum[o] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < nt; ++t) {
      const int q = t / ng, g = t % ng;
      stage_raw(t + S - 1);  // in flight while stage t is reduced
      cp_async_wait<S - 1>();
      __syncthreads();  // stage t (and the weight slice, the mask rows) visible to all
      const float* src = raw_s + (t % S) * kRaw;
      const int j0 = g * FG;
#pragma unroll
      for (int o = 0; o < RM; ++o) {
        const int r = r0 + 16 * o;
        const uint32_t bits = bits_s[r];
#pragma unroll
        for (int jj = 0; jj < FG; ++jj) {
          const int j = j0 + jj;
          if (j >= f) break;
          const float m = j < 32 ? (float)((bits >> j) & 1u)
                                 : (row0 + r < n && ms[(row0 + r) * f + j] ? 1.f : 0.f);
          const float4 v = *reinterpret_cast<const float4*>(src + (r * FG + jj) * kKC + c);
          sum[o].x = fmaf(v.x, m, sum[o].x);
          sum[o].y = fmaf(v.y, m, sum[o].y);
          sum[o].z = fmaf(v.z, m, sum[o].z);
          sum[o].w = fmaf(v.w, m, sum[o].w);
        }
      }
      if (g == ng - 1) {
        // chunk q's mean into the tile (chunk q - 1's product is done: the
        // last iteration's closing barrier)
#pragma unroll
        for (int o = 0; o < RM; ++o) {
          const float cnt = fmaxf((float)cnt_s[r0 + 16 * o], 1.f);
          *reinterpret_cast<float4*>(a_s + (r0 + 16 * o) * kAP + c) =
              make_float4(sum[o].x / cnt, sum[o].y / cnt, sum[o].z / cnt, sum[o].w / cnt);
          sum[o] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        // a deeper d_in restages the weight slice and drains the copies
        if (q > 0 && q % nkw == 0) {
          stage_w_nn(w_s, wu, d_in, d_out, col0, q * kKC, kw, vec_w);
          cp_async_wait<0>();
        }
        __syncthreads();  // the mean tile (and the weight slice) visible to all
        product_nn<RM>(acc, a_s, w_s, (q % nkw) * kKC);
      }
      __syncthreads();  // raw stage t (and the mean tile) free again
    }
  }

  const float* bu = b + (long long)u * d_out;
  const int rbase = tile_row<RM>(), cbase = tile_col();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = rbase + 4 * i;
    const long long row = row0 + r;
    if (row >= n) continue;
    // f = 1: the product ran on h itself; the mask bit scales it (the mean
    // of a masked row is 0)
    const float m = F1 ? (float)(bits_s[r] & 1u) : 1.f;
    float* o = out + ((long long)s * n + row) * d_out;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int col = col0 + cbase + 32 * hh;
      if (col >= d_out) continue;
      if (vec_out) {
        const float4 bv = *reinterpret_cast<const float4*>(bu + col);
        *reinterpret_cast<float4*>(o + col) = make_float4(
            F1 ? fmaf(acc[i][4 * hh], m, bv.x) : acc[i][4 * hh] + bv.x,
            F1 ? fmaf(acc[i][4 * hh + 1], m, bv.y) : acc[i][4 * hh + 1] + bv.y,
            F1 ? fmaf(acc[i][4 * hh + 2], m, bv.z) : acc[i][4 * hh + 2] + bv.z,
            F1 ? fmaf(acc[i][4 * hh + 3], m, bv.w) : acc[i][4 * hh + 3] + bv.w);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < d_out) {
            const float a = acc[i][4 * hh + j];
            o[col + j] = F1 ? fmaf(a, m, bu[col + j]) : a + bu[col + j];
          }
        }
      }
    }
  }
}

template <int RM, bool F1, bool ONE>
int launch(const float* h, const uint8_t* mask, const float* w, const float* b,
           const int* slot_u, float* out, long long n, long long f, long long d_in,
           long long d_out, int kw, dim3 grid, cudaStream_t stream) {
  // F1: the two-stage A ring; f > 1: one mean tile and the raw ring
  const size_t extra = sizeof(float) * (F1 ? 0 : Ring<RM, F1>::kStages * kRaw - 16 * RM * kAP) +
                       2 * 16 * RM * sizeof(int);
  const size_t smem = smem_bytes(RM, kw, extra);
  cudaError_t err = cudaFuncSetAttribute(mean_linear_kernel<RM, F1, ONE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mean_linear_kernel<RM, F1, ONE><<<grid, kThreads, smem, stream>>>(
      h, mask, w, b, slot_u, out, n, (int)f, (int)d_in, (int)d_out, kw);
  return (int)cudaGetLastError();
}

template <bool F1, bool ONE>
int launch_rm(int rm, const float* h, const uint8_t* mask, const float* w, const float* b,
              const int* slot_u, float* out, long long rb, long long n, long long f,
              long long d_in, long long d_out, long long col_tiles, cudaStream_t stream) {
  const long long gx = (n + 16 * rm - 1) / (16 * rm);
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int kw = slice_depth(d_in);
  dim3 grid((unsigned)gx, (unsigned)col_tiles, (unsigned)rb);
  if (rm == 4) return launch<4, F1, ONE>(h, mask, w, b, slot_u, out, n, f, d_in, d_out, kw, grid, stream);
  return launch<1, F1, ONE>(h, mask, w, b, slot_u, out, n, f, d_in, d_out, kw, grid, stream);
}


// The rows per thread a launch of rb slots takes: `rm` when it is 1 or 4
// (tiles of 16 or 64 rows; both launch at every shape), the shape's rule
// (rows_per_thread) when it is 0, and 0 (refused) for any other value.
inline int layout_rm(long long rb, long long n, long long d_out, int rm) {
  if (rm == 1 || rm == 4) return rm;
  if (rm != 0) return 0;
  return rows_per_thread(rb, n, (d_out + kBN - 1) / kBN, 4);
}

// The checked launch of rb slots (ONE: rb = 1 and no slot_u) at `rm` rows
// per thread (0: the shape's rule; see layout_rm); returns
// cudaGetLastError() (0 = launched).
template <bool ONE>
int forward(const float* h, const uint8_t* mask, const float* w, const float* b,
            const int* slot_u, float* out, long long rb, long long n, long long f,
            long long d_in, long long d_out, int rm, cudaStream_t stream) {
  const long long col_tiles = (d_out + kBN - 1) / kBN;
  if (rb < 1 || rb > 65535 || n < 1 || d_out < 1 || d_in < 0 || f < 0 ||
      d_in > 0x7fffffffLL || d_out > 0x7fffffffLL || f > 0x7fffffffLL || col_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  rm = layout_rm(rb, n, d_out, rm);
  if (rm == 0) return (int)cudaErrorInvalidValue;
  return f == 1 ? launch_rm<true, ONE>(rm, h, mask, w, b, slot_u, out, rb, n, f, d_in, d_out,
                                       col_tiles, stream)
                : launch_rm<false, ONE>(rm, h, mask, w, b, slot_u, out, rb, n, f, d_in, d_out,
                                        col_tiles, stream);
}

}  // namespace mean_linear
