// The fp32 register-tiled product core shared by mean_linear.cuh (the kernel
// of stacked_mean_linear.cu and relation_agg.cu), stacked_mean_linear_dh.cu,
// stacked_attn_dh.cu and stacked_attn_epilogue.cu, for sm_90a.
//
// A block of 128 threads (4 warps) computes a tile of 16 * RM rows x 64
// columns of C = A . B on the CUDA cores in full fp32.  Lane (ly, lx) =
// (lane / 8, lane % 8) of warp w owns rows w * 4 * RM + ly + 4 i (i < RM)
// and columns 4 lx + j and 32 + 4 lx + j (j < 4): an RM x 8 register
// micro-tile.  A streams through shared memory in chunks of [16 * RM][32]
// (row-major, as A lies in memory); per 4-deep k step a thread reads RM
// float4 of A and 8 float4 of B, so at RM = 8 16 16-byte loads feed 256
// FMAs.  A 16-byte shared load costs a warp 4 cycles whatever its
// addresses, so the loads per FMA, not bank conflicts, set the pace: RM = 8
// balances them with the FMA rate.  Smaller RM trades that balance for more
// blocks, and so more warps an SM to hide latency, when the rows are few
// (see rows_per_thread).
//
// Two layouts of B:
//   * "nt": B is W^T with W [columns][K] in memory (a thread's columns are
//     W's rows): W's slice is staged as it lies, [64][kw], its 16-byte chunks
//     XOR-swizzled by row so that the 8 column groups of a warp, reading
//     rows 4 lx + j at one chunk, hit 8 different bank groups;
//   * "nn": B is W [K][columns] in memory: W's slice is staged as it lies,
//     [kw][64]; at one k a quarter-warp (lx = 0..7) reads 8 consecutive
//     float4 of one row, 8 different bank groups without a swizzle.
// The weight slice is staged once per block by cp.async when the depth is at
// most kMaxKW (every path of the port); a deeper K is restaged in kMaxKW-deep
// slices, one after the other.
//
// A block may hold several such groups of 128 threads (stacked_attn_epilogue.cu
// runs HGT's two projections as two groups over one A chunk): a thread's
// place in its tile is taken from threadIdx.x % kThreads, and the staging
// helpers take the count NT of the threads that stage (default kThreads).
//
// Every output is summed over k in increasing order inside one thread, in
// fp32 FMAs: no TF32, no tensor cores, no atomics, so a result is the same
// bit for bit from run to run and does not depend on RM.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fp32_tile {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBN = 64;        // columns of a block
constexpr int kKC = 32;        // depth of one streamed A chunk
constexpr int kAP = kKC + 4;   // row pitch of an A chunk (16-byte aligned rows)
constexpr int kMaxKW = 128;    // deepest weight slice a block keeps resident
constexpr int kSMs = 132;      // streaming multiprocessors of an H100 SXM

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// the depth of the resident weight slice: K in whole chunks, at most kMaxKW
inline int slice_depth(long long K) {
  const long long dk = ((K > 0 ? K : 1) + kKC - 1) / kKC * kKC;
  return (int)(dk <= kMaxKW ? dk : kMaxKW);
}

// Rows per thread of a launch: the largest of max_rm (8 or 4), 4 and 1
// whose 16 * RM-row tiles still give every SM a block: a launch over few
// rows trades the load-to-FMA balance for SMs at work.  Chosen from the
// shape alone; the result does not depend on it.
inline int rows_per_thread(long long rb, long long rows, long long col_tiles, int max_rm) {
  if (max_rm >= 8 && rb * ((rows + 127) / 128) * col_tiles >= kSMs) return 8;
  if (rb * ((rows + 63) / 64) * col_tiles >= kSMs) return 4;
  return 1;
}

// Shared memory of a block: the weight slice, the two-stage A ring and
// `extra` bytes after them.
inline size_t smem_bytes(int rm, int kw, size_t extra) {
  return sizeof(float) * ((size_t)kw * kBN + 2 * (size_t)16 * rm * kAP) + extra;
}

// this thread's first row and column in the block's tile
template <int RM>
__device__ __forceinline__ int tile_row() {
  return (threadIdx.x % kThreads / 32) * 4 * RM + (threadIdx.x % 32) / 8;
}
__device__ __forceinline__ int tile_col() { return (threadIdx.x % 8) * 4; }

// A chunk at depth k0 of `rows` x K (row-major) into ring slot `slot`,
// by cp.async in a group of its own; out-of-range elements zero-filled by the
// copy itself.  16-byte copies when `vec` (K % 4 == 0 and a 16-byte aligned
// base), else 4-byte.
template <int RM, int NT = kThreads>
__device__ __forceinline__ void stage_a(float* a_s, const float* a, long long rows,
                                        long long row0, int K, int k0,
                                        int slot, bool vec) {
  constexpr int BM = 16 * RM;
  float* dst = a_s + slot * BM * kAP;
  if (vec) {
    for (int e = threadIdx.x; e < BM * (kKC / 4); e += NT) {
      const int r = e / (kKC / 4), c = (e % (kKC / 4)) * 4;
      const bool in = row0 + r < rows && k0 + c < K;
      cp_async16(dst + r * kAP + c, in ? a + (row0 + r) * K + k0 + c : a, in);
    }
  } else {
    for (int e = threadIdx.x; e < BM * kKC; e += NT) {
      const int r = e / kKC, c = e % kKC;
      const bool in = row0 + r < rows && k0 + c < K;
      cp_async4(dst + r * kAP + c, in ? a + (row0 + r) * K + k0 + c : a, in);
    }
  }
  cp_async_commit();
}

// "nn" weight slice: rows k0 .. k0 + kw of w [K][ncols], columns col0 ..
// col0 + 64, as w_s[k][c] (pitch kBN), by cp.async in a group of its own,
// staged by NT threads (threadIdx.x % NT: one group of a larger block may
// stage a slice of its own).
template <int NT = kThreads>
__device__ __forceinline__ void stage_w_nn(float* w_s, const float* w, int K, int ncols,
                                           int col0, int k0, int kw, bool vec) {
  if (vec) {
    for (int e = threadIdx.x % NT; e < kw * (kBN / 4); e += NT) {
      const int k = e / (kBN / 4), c = (e % (kBN / 4)) * 4;
      const bool in = k0 + k < K && col0 + c < ncols;
      cp_async16(w_s + k * kBN + c, in ? w + (long long)(k0 + k) * ncols + col0 + c : w, in);
    }
  } else {
    for (int e = threadIdx.x % NT; e < kw * kBN; e += NT) {
      const int k = e / kBN, c = e % kBN;
      const bool in = k0 + k < K && col0 + c < ncols;
      cp_async4(w_s + k * kBN + c, in ? w + (long long)(k0 + k) * ncols + col0 + c : w, in);
    }
  }
  cp_async_commit();
}

// "nt" weight slice of NSRC sources laid end to end along a virtual depth:
// each source's K is padded to whole chunks (nkc of them), so virtual chunk
// q is chunk q % nkc of source q / nkc.  Virtual chunks q0 .. q0 + kw / 32 of
// the rows col0 .. col0 + 64 of each w[src] [ncols][K] as w_s[c][k], the
// 16-byte chunk j of row c at chunk j ^ (c / 4 % 8); one cp.async group.
template <int NSRC>
__device__ __forceinline__ void stage_w_nt(float* w_s, const float* const (&w)[NSRC], int K,
                                           int nkc, int ncols, int col0, int q0, int kw,
                                           bool vec) {
  const int nk = NSRC * nkc;
  if (vec) {
    for (int e = threadIdx.x; e < kBN * (kw / 4); e += kThreads) {
      const int c = e / (kw / 4), j = e % (kw / 4);
      const int q = q0 + j / (kKC / 4);
      const int src = NSRC == 1 ? 0 : min(q / nkc, NSRC - 1);
      const int k = (q - src * nkc) * kKC + (j % (kKC / 4)) * 4;
      const bool in = q < nk && col0 + c < ncols && k < K;
      const float* ws = src == 0 ? w[0] : w[NSRC - 1];  // no runtime index: no stack frame
      cp_async16(w_s + c * kw + ((j ^ (c / 4 % 8)) * 4),
                 in ? ws + (long long)(col0 + c) * K + k : w[0], in);
    }
  } else {
    for (int e = threadIdx.x; e < kBN * kw; e += kThreads) {
      const int c = e / kw, o = e % kw;
      const int q = q0 + o / kKC;
      const int src = NSRC == 1 ? 0 : min(q / nkc, NSRC - 1);
      const int k = (q - src * nkc) * kKC + o % kKC;
      const bool in = q < nk && col0 + c < ncols && k < K;
      const float* ws = src == 0 ? w[0] : w[NSRC - 1];
      cp_async4(w_s + c * kw + ((o / 4) ^ (c / 4 % 8)) * 4 + o % 4,
                in ? ws + (long long)(col0 + c) * K + k : w[0], in);
    }
  }
  cp_async_commit();
}

// acc += one A chunk (ring slot a_b) x the "nt" weight slice's chunk j0 / 8
// (j0: the chunk's first 16-byte column in w_s)
template <int RM>
__device__ __forceinline__ void product_nt(float (&acc)[RM][8], const float* a_b,
                                           const float* w_s, int kw, int j0) {
  const int rbase = tile_row<RM>();
  const float* wb = w_s + tile_col() * kw;  // rows cbase + 32 h + j
  const int sw = threadIdx.x % 8;           // the rows' swizzle: (cbase + 32 h) / 4 % 8
#pragma unroll 1  // unrolled, the loads of the next step spill registers
  for (int kk = 0; kk < kKC; kk += 4) {
    float4 bw[8];  // w[c][k .. k + 3] of this thread's 8 columns c
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bw[j] = *reinterpret_cast<const float4*>(wb + ((j / 4) * 32 + j % 4) * kw +
                                               ((j0 + kk / 4) ^ sw) * 4);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(a_b + (rbase + 4 * i) * kAP + kk);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const float av = lane4(a, k4);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, lane4(bw[j], k4), acc[i][j]);
      }
    }
  }
}

// acc += one A chunk (ring slot a_b) x rows k_b .. k_b + 32 of the "nn"
// weight slice
template <int RM>
__device__ __forceinline__ void product_nn(float (&acc)[RM][8], const float* a_b,
                                           const float* w_s, int k_b) {
  const int rbase = tile_row<RM>();
  const float* wb = w_s + k_b * kBN + tile_col();  // columns cbase + 32 h + j
#pragma unroll 1
  for (int kk = 0; kk < kKC; kk += 4) {
    float4 bw[8];  // w[k + j / 2][cbase + 32 (j % 2) .. + 3]
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bw[j] = *reinterpret_cast<const float4*>(wb + (kk + j / 2) * kBN + (j % 2) * 32);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(a_b + (rbase + 4 * i) * kAP + kk);
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const float av = lane4(a, k4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(av, lane4(bw[2 * k4 + j / 4], j % 4), acc[i][j]);
      }
    }
  }
}

// The whole "nt" product of a block: acc = sum over the virtual depth (NSRC
// sources of depth K, in order) of a[src][row][k] * w[src][col][k], for the
// block's 16 * RM rows from row0 (of `rows`) and 64 columns from col0 (of
// `ncols`).  The weight slice is staged first, then A chunk 0; `first()`
// runs while they are in flight; the next A chunk is in flight while the
// current one is multiplied.  w_s holds [64][kw], a_s the [2][16 RM][kAP]
// ring.  Ends with a barrier, so the caller may reuse the shared memory.
template <int RM, int NSRC, class First>
__device__ __forceinline__ void accumulate_nt(
    float (&acc)[RM][8], float* w_s, float* a_s, const float* const (&a)[NSRC],
    const float* const (&w)[NSRC], long long rows, long long row0, int ncols, int col0,
    int K, int kw, bool vec_a, bool vec_w, First first) {
  const int nkc = max(1, (K + kKC - 1) / kKC);  // chunks per source
  const int nk = NSRC * nkc;
  const int nkw = kw / kKC;                     // chunks per weight slice
  auto stage = [&](int q) {
    const int src = NSRC == 1 ? 0 : q / nkc;
    stage_a<RM>(a_s, src == 0 ? a[0] : a[NSRC - 1], rows, row0, K, (q - src * nkc) * kKC,
                q % 2, vec_a);
  };
  stage_w_nt<NSRC>(w_s, w, K, nkc, ncols, col0, 0, kw, vec_w);
  stage(0);
  first();
  for (int q = 0; q < nk; ++q) {
    // a deeper K restages the weight slice (the previous iteration's closing
    // barrier has freed it) in a group older than chunk q + 1's, so the wait
    // below covers it
    if (q > 0 && q % nkw == 0) stage_w_nt<NSRC>(w_s, w, K, nkc, ncols, col0, q, kw, vec_w);
    if (q + 1 < nk) {
      stage(q + 1);  // in flight while chunk q is multiplied
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk q and the weight slice visible to all
    product_nt<RM>(acc, a_s + (q % 2) * 16 * RM * kAP, w_s, kw, (q % nkw) * (kKC / 4));
    __syncthreads();  // ring slot q % 2 (and the weight slice) free again
  }
}

}  // namespace fp32_tile
