// Blocked online-softmax attention (forward) with causal and sliding-window
// masks, a query offset and grouped-query heads, for sm_90a.
//
//   out[b, i, h, :] = sum_j softmax_j(q[b,i,h,:] . k[b,j,h//g,:] / sqrt(d)) v[b,j,h//g,:]
//
// over the keys j that query i (at position q_offset + i) may see: j < sk,
// j <= q_offset + i if causal, j > q_offset + i - window with a window.  A
// query that sees no key gets 0.
//
// Replaces the Pallas TPU kernel flash_attention_pallas (_kernel) in
// src/repro/kernels/flash_attention/kernel.py.  That kernel walked a grid
// (bh, q block, k block) whose k axis ran in order on one core, carrying the
// running max, denominator and accumulator in VMEM scratch, and skipped whole
// k blocks outside the causal/window band.  Its caller (ops.py) repeated the
// kv heads for GQA and padded sq and sk to block multiples with copies, and
// fell back to the oracle for ragged non-causal inputs.
//
// What bounds it on an H100: operations.  At the LM workbench's prefill
// (b, h, kv, s, d) = (4, 24, 8, 2048, 128) in bf16 the causal band holds
// 1.03e11 FLOP (two products of 2 s^2 d / 2 per head), 0.104 ms at
// 989 TFLOP/s, against 134 MB of q, k, v and out, 0.040 ms at 3.35 TB/s.
//
// Design, common to the three kernels below:
//   * one block per (batch * head, tile of kBQ = 64 queries, 128 in the
//     wgmma kernel); the TPU's sequential k axis is a loop inside the block
//     over tiles of kBK = 64 keys (128), staged in dynamic shared memory;
//   * the loop bounds skip every k tile outside the causal/window band,
//     computed once per q tile (the longest causal tiles are scheduled
//     first); inside a tile each score is masked explicitly (key < sk,
//     causal, window), so ragged sq and sk need no padded copies, causal or
//     not;
//   * GQA by indexing: head h reads kv head h / (H / KV), no repeat copy;
//   * strides in, so the model's [b, s, h, d] q/k/v go in without
//     transposes (the last dimension must be contiguous);
//   * the running max, the denominator and the accumulator stay in fp32
//     registers; as the Pallas kernel does, p is rounded to the input type
//     before the p @ v product, and the output is written in the input
//     type.  Masked scores are skipped explicitly instead of set to a
//     finite -1e30, so a row with no visible key inside a visited tile stays
//     0 (the Pallas kernel gives such a row the mean of the masked v rows,
//     since exp(-1e30 - (-1e30)) = 1; the oracle gives 0).
//
// bf16 (the model's type), two kernels; the C entry point picks one by sq:
//   * sq >= 128 (every prefill, every long prompt), at each head dim the op
//     takes (32, 64, 80, 128): the Hopper kernel flash_attention_wgmma_kernel<D>.
//     One block per (batch * head, tile of 128 queries), 384 threads in three
//     warpgroups.  Warpgroup 2 is the producer: after `setmaxnreg` drops it to
//     40 registers, one of its threads loads the q tile once and keeps a
//     two-stage ring of 128-key K and V tiles full with TMA
//     (cp.async.bulk.tensor from tensor maps built on the operands' own [b, s,
//     h, d] strides, so GQA is a coordinate and ragged sq and sk are the TMA's
//     zero fill), completing on `full` mbarriers and waiting on `empty` ones.
//     Every tile is ceil(D / 64) column blocks of [128][64] bf16 in the
//     128-byte swizzle; the tensor maps' d extent is D, so at d 80 and 32 the
//     columns D..64 ceil(D / 64) - 1 of the last block are the TMA's zero fill
//     (no padded copy in device memory, no read of a neighbouring head's
//     columns when q/k/v are views of a fused projection).  Warpgroups 0 and 1
//     (232 registers each) own 64 query rows apiece: s = q k^T by D / 16 steps
//     of wgmma m64n128k16 with both operands in shared memory (K-major,
//     128-byte swizzle; no step touches the zero columns), fp32 accumulate;
//     the online softmax in registers (scores in log2 units, masked scores
//     skipped as -inf, masks evaluated only on tiles that cross sk or the
//     band's edge); then o += p v by wgmma m64nDk16 with p as the register A
//     operand (bf16; the accumulator layout of s is the A layout) and v as B
//     through the transpose bit (v stays d-contiguous; at d 80 one
//     instruction's N spans the first column block and 16 columns of the
//     second, lbo apart, the layout d 128 uses across its two blocks, so d 80
//     needs no second swizzle mode and no second tensor map).  The two
//     warpgroups run their softmax and their products in turn against the same
//     ring, so one's wgmma overlaps the other's softmax, and TMA overlaps both.
//   * sq < 128 (decode, sq = 1, and short prompts, which no path times at
//     length): the mma.sync kernel flash_attention_bf16_kernel, m16n8k16 from
//     4 warps over 64-query x 64-key tiles, K and V staged with 16-byte loads
//     (the first tensor-core version; a 128-query tile would leave a decode
//     step's block idle).  The scores' C fragments are the A fragments of p,
//     so p never goes through shared memory.
// Both keep the rounding of the Pallas kernel: p is rounded to bf16 before
// p @ v, the output written in bf16.
//
// What bounds the wgmma kernel at hubert-xlarge's prefill (b, h, kv, s, d) =
// (4, 16, 16, 2048, 80), non-causal: on paper operations, 8.6e10 FLOP, 0.087
// ms at 989 TFLOP/s, against 84 MB of q, k, v and out, 0.025 ms.  On the
// card neither: the softmax's per-tile work (exp2, max, sum, the rescale of
// o on the CUDA cores) does not shrink with d, and the two-stage ring holds
// each block's next K/V tile back until both warpgroups release a stage, so
// at d 80 and 32 the loads and the exponentials take most of each k tile.
// tools/flash_variants.py times copies of this source with one part of the
// tile loop taken out (PERF.md records what it measured).

// fp32 (tests, reduced configs): scalar fp32 FMAs on the CUDA cores (the
// tensor cores would round the operands): 256 threads, each owning 4 query
// rows x 4 key columns of the score tile and 4 rows x d/16 columns of the
// output; a row's max and sum are reduced across its 16 threads with
// shuffles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // queries per block
constexpr int kBK = 64;  // keys per tile of the inner loop

struct Strides {  // element strides of a [b, s, h, d] operand (d contiguous)
  long long b, s, h;
};

struct Problem {
  Strides qs, ks, vs, os;
  int H, group, sq, sk, causal, window, q_offset;
  float scale;
};

// the band of keys a q tile starting at q0 can see: [k_begin, k_end)
__device__ __forceinline__ void key_band(const Problem& p, int q0, int& k_begin, int& k_end) {
  const int qpos_lo = q0 + p.q_offset;
  const int qpos_hi = min(q0 + kBQ, p.sq) - 1 + p.q_offset;
  k_begin = 0;
  k_end = p.sk;
  if (p.causal) k_end = min(k_end, qpos_hi + 1);
  if (p.window >= 0) k_begin = max(0, qpos_lo - p.window + 1);
}

__device__ __forceinline__ bool visible(const Problem& p, int qpos, int kpos) {
  return kpos < p.sk && (!p.causal || kpos <= qpos) && (p.window < 0 || kpos > qpos - p.window);
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kThreads32 = 256;
constexpr int kLdP = kBK + 1;

// row pitch of the staged fp32 tiles: odd, so the 16 key rows a warp reads at
// once fall in 16 different banks
template <int D>
__host__ __device__ constexpr size_t smem_fp32() {
  return (size_t)(kBQ + 2 * kBK) * (D + 1) * sizeof(float) + (size_t)kBQ * kLdP * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads32) flash_attention_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, Problem p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* p_s = v_s + kBK * LD;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, hk = h / p.group;
  // the longest causal tiles first: blockIdx.y = 0 is the last q tile
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // key columns tx + 16 j, output columns tx + 16 c

  const float* qb = q + b * p.qs.b + h * p.qs.h;
  const float* kb = k + b * p.ks.b + hk * p.ks.h;
  const float* vb = v + b * p.vs.b + hk * p.vs.h;
  for (int e = tid; e < kBQ * D; e += kThreads32) {
    const int r = e / D, c = e % D;
    q_s[r * LD + c] = q0 + r < p.sq ? qb[(long long)(q0 + r) * p.qs.s + c] : 0.f;
  }
  int k_begin, k_end;
  key_band(p, q0, k_begin, k_end);

  float m_i[4], l_i[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBK * D; e += kThreads32) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < p.sk;
      k_s[r * LD + c] = in ? kb[(long long)(k0 + r) * p.ks.s + c] : 0.f;
      v_s[r * LD + c] = in ? vb[(long long)(k0 + r) * p.vs.s + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty * 4 + i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = k_s[(tx + 16 * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i + p.q_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(p, qp, k0 + tx + 16 * j) ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      // a row with nothing visible so far keeps m = -inf, l = 0, acc = 0
      const float alpha = m_i[i] == -INFINITY ? 0.f : expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sum += pj;
        p_s[(ty * 4 + i) * kLdP + tx + 16 * j] = pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pr[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = p_s[(ty * 4 + i) * kLdP + j];
#pragma unroll
      for (int c = 0; c < NJ; ++c) vv[c] = v_s[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NJ; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

  float* ob = out + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.sq) continue;
    const float l = fmaxf(l_i[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < NJ; ++c) ob[(long long)r * p.os.s + tx + 16 * c] = acc[i][c] / l;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;  // 16 query rows each
constexpr int kThreads16 = 32 * kWarps;

// row pitch of the staged bf16 tiles: D + 8 elements keeps rows 16-byte
// aligned and puts the 8 rows a fragment load touches in distinct banks
template <int D>
__host__ __device__ constexpr size_t smem_bf16() {
  return (size_t)(kBQ + 2 * kBK) * (D + 8) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a @ b for one m16n8k16 tile: a row-major 16 x 16 (4 registers of 2
// bf16), b column-major 16 x 8 (2 registers), c 16 x 8 fp32 (PTX ISA
// fragment layouts: lane = 4 * g + t holds a, c rows g and g + 8, columns
// 2t, 2t + 1 (+ 8 for a2, a3); b rows 2t, 2t + 1 (+ 8 for b1), column g)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// rows [row0, row0 + 64) of a [s, d] operand into a shared tile, 16 bytes a
// load, zeros past `rows`
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long stride,
                                           int row0, int rows) {
  constexpr int LD = D + 8, V = D / 8;
  for (int e = threadIdx.x; e < kBK * V; e += kThreads16) {
    const int r = e / V, c = (e % V) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads16) flash_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, Problem p) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;   // k steps of q k^T
  constexpr int NT = D / 8;    // n tiles of the output
  constexpr int ST = kBK / 8;  // n tiles of the score tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kBQ * LD;
  bf16* v_s = k_s + kBK * LD;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the longest causal tiles first
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16 + g;  // this lane's rows r0 and r0 + 8 of the tile
  const int qp0 = q0 + r0 + p.q_offset, qp1 = qp0 + 8;

  stage_tile<D>(q_s, q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.sq);
  const bf16* kb = k + b * p.ks.b + hk * p.ks.h;
  const bf16* vb = v + b * p.vs.b + hk * p.vs.h;
  int k_begin, k_end;
  key_band(p, q0, k_begin, k_end);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const bf16* row = q_s + r0 * LD + kk * 16 + 2 * t;
    qa[kk][0] = ld32(row);
    qa[kk][1] = ld32(row + 8 * LD);
    qa[kk][2] = ld32(row + 8);
    qa[kk][3] = ld32(row + 8 * LD + 8);
  }

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K and V are consumed
    stage_tile<D>(k_s, kb, p.ks.s, k0, p.sk);
    stage_tile<D>(v_s, vb, p.vs.s, k0, p.sk);
    __syncthreads();

    float sc[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const bf16* krow = k_s + (8 * j + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(sc[j], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], ld32(krow + kk * 16),
                 ld32(krow + kk * 16 + 8));
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < ST; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * j + 2 * t + e;
        sc[j][e] = visible(p, qp0, kp) ? sc[j][e] * p.scale : -INFINITY;
        sc[j][2 + e] = visible(p, qp1, kp) ? sc[j][2 + e] * p.scale : -INFINITY;
        mx0 = fmaxf(mx0, sc[j][e]);
        mx1 = fmaxf(mx1, sc[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // across the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    // a row with nothing visible so far keeps m = -inf, l = 0, o = 0
    const float alpha0 = m0 == -INFINITY ? 0.f : expf(m0 - n0);
    const float alpha1 = m1 == -INFINITY ? 0.f : expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[ST][2];  // p rounded to bf16, rows r0 and r0 + 8
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      float e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        e[c] = sc[j][c] == -INFINITY ? 0.f : expf(sc[j][c] - (c < 2 ? n0 : n1));
      sum0 += e[0] + e[1];
      sum1 += e[2] + e[3];
      pa[j][0] = pack(e[0], e[1]);
      pa[j][1] = pack(e[2], e[3]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // o += p @ v: the score tile's C fragments are the A fragments of p
#pragma unroll
    for (int s16 = 0; s16 < kBK / 16; ++s16) {
      const bf16* vrow = v_s + (16 * s16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* vp = vrow + 8 * n;
        mma_bf16(o[n], pa[2 * s16][0], pa[2 * s16][1], pa[2 * s16 + 1][0], pa[2 * s16 + 1][1],
                 pack(vp[0], vp[LD]), pack(vp[8 * LD], vp[9 * LD]));
      }
    }
  }

  bf16* ob = out + b * p.os.b + h * p.os.h;
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  const int row = q0 + r0;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
    if (row < p.sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)row * p.os.s + c) = pack(o[n][0] * inv0, o[n][1] * inv0);
    if (row + 8 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)(row + 8) * p.os.s + c) = pack(o[n][2] * inv1, o[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// bf16 with sq >= 128, every head dim (32, 64, 80, 128): wgmma + TMA,
// warp-specialized
// ---------------------------------------------------------------------------

constexpr int kWQ = 128;        // queries per block: two consumer warpgroups of 64
constexpr int kWK = 128;        // keys per tile
constexpr int kStages = 2;      // depth of the K/V ring
constexpr int kWThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kAtom = 64;       // bf16 columns of one 128-byte swizzled row

// byte offsets inside the 1024-aligned dynamic shared memory; each operand
// tile is ceil(D / 64) column blocks of [rows][64] bf16 in TMA's 128-byte
// swizzle.  At d 80 and 32 the last block is partly out of the tensor map's
// d extent: TMA writes those columns as zeros and counts the whole box in its
// transaction bytes, so the tile sizes below (shared-memory offsets and the
// mbarriers' expected bytes alike) are whole blocks
template <int D>
struct WgLayout {
  static constexpr int kCB = (D + kAtom - 1) / kAtom;
  static constexpr int kBlock = kWQ * kAtom * 2;  // one column block (kWQ == kWK)
  static constexpr int kQBytes = kCB * kBlock;
  static constexpr int kKVBytes = kCB * kBlock;   // one K or one V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;  // q_full, full[kStages], empty[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// until the phase of `bar` with this parity has completed; a wait of more
// than 10 s is a fault of the pipeline and traps (a launch error, not a hung
// card)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing on `bar`; out-of-range elements arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; lbo and sbo in 16-byte
// units (K-major: lbo unused, sbo = 1024 bytes between 8-row groups;
// MN-major: lbo between 64-column blocks, sbo between 8-row groups of K)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)sbo << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of wgmma's registers across the
// asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x 128) = (accum ? d : 0) + a (64 x 16) b (16 x 128); a and b K-major in
// shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accum) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accum));
}

// d (64 x 128) += a (64 x 16, registers) b (16 x 128); b MN-major in shared
// memory (128-byte swizzle, the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += a (64 x 16, registers) b (16 x 64); b MN-major in shared
// memory (128-byte swizzle, the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80) += a (64 x 16, registers) b (16 x 80); b MN-major in shared
// memory (128-byte swizzle, the transpose bit set): columns 0..63 from one
// column block, 64..79 from the next, lbo further on
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) += a (64 x 16, registers) b (16 x 32); b MN-major in shared
// memory (128-byte swizzle, the transpose bit set): the first 32 columns of
// one column block
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(D == 32 || D == 64 || D == 80 || D == 128, "no p v product for this head dim");
  if constexpr (D == 128) wgmma_rs_n128(o, a, db);
  else if constexpr (D == 80) wgmma_rs_n80(o, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n32(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(kWThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out, Problem p) {
  using L = WgLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle needs 1024
  const uint32_t q_full = base + L::kBar;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + kStages + s); };

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWQ;  // the longest causal tiles first
  // the band of keys the tile can see, in whole key tiles
  const int qpos_hi = min(q0 + kWQ, p.sq) - 1 + p.q_offset;
  int k_begin = 0, k_end = p.sk;
  if (p.causal) k_end = min(k_end, qpos_hi + 1);
  if (p.window >= 0) k_begin = max(0, q0 + p.q_offset - p.window + 1);
  const int kt0 = (k_begin / kWK) * kWK;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + kWK - 1) / kWK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int cb = 0; cb < L::kCB; ++cb)
        tma_load_4d(base + L::kQ + cb * L::kBlock, &q_map, q_full, cb * kAtom, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages, k0 = kt0 + j * kWK;
        mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full(s), 2 * L::kKVBytes);
        for (int cb = 0; cb < L::kCB; ++cb) {
          tma_load_4d(base + L::kK + s * L::kKVBytes + cb * L::kBlock, &k_map, full(s),
                      cb * kAtom, hk, k0, b);
          tma_load_4d(base + L::kV + s * L::kKVBytes + cb * L::kBlock, &v_map, full(s),
                      cb * kAtom, hk, k0, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows [wg * 64, wg * 64 + 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row0 = q0 + wg * 64 + (tid / 32) * 16 + g;  // this lane's rows row0, row0 + 8
    const int qp0 = row0 + p.q_offset, qp1 = qp0 + 8;
    const int wq_lo = q0 + wg * 64 + p.q_offset;
    const int wq_hi = min(q0 + wg * 64 + 64, p.sq) - 1 + p.q_offset;
    const float sl2 = p.scale * 1.4426950408889634f;  // scores in log2 units
    const uint32_t q_s = base + L::kQ + wg * 64 * kAtom * 2;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this lane's share
    if (n_tiles > 0) mbar_wait(q_full, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages, k0 = kt0 + j * kWK;
      const uint32_t k_s = base + L::kK + s * L::kKVBytes;
      const uint32_t v_s = base + L::kV + s * L::kKVBytes;
      mbar_wait(full(s), (j / kStages) & 1);

      // sc = q k^T: 64 rows x 128 keys, D / 16 steps along d
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * L::kBlock + (kk % 4) * 32;
        wgmma_ss_n128(sc, sw128_desc(q_s + off, 1, 64), sw128_desc(k_s + off, 1, 64), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // masks only where the tile reaches past sk or the band's edges
      const bool full_tile = k0 + kWK <= p.sk && (!p.causal || k0 + kWK - 1 <= wq_lo) &&
                             (p.window < 0 || k0 > wq_hi - p.window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * jn + e] * sl2;
          if (!full_tile && !visible(p, e < 2 ? qp0 : qp1, k0 + 8 * jn + 2 * t + (e & 1)))
            x = -INFINITY;
          sc[4 * jn + e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // across the 4 lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      // a row with nothing visible so far keeps m = -inf, l = 0, o = 0
      const float b0 = n0 == -INFINITY ? 0.f : n0, b1 = n1 == -INFINITY ? 0.f : n1;
      const float alpha0 = exp2f(m0 - b0), alpha1 = exp2f(m1 - b1);
      m0 = n0;
      m1 = n1;
      uint32_t pa[8][4];  // p rounded to bf16: the A fragments of the 8 steps of p v
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const float e0 = exp2f(sc[4 * jn] - b0), e1 = exp2f(sc[4 * jn + 1] - b0);
        const float e2 = exp2f(sc[4 * jn + 2] - b1), e3 = exp2f(sc[4 * jn + 3] - b1);
        sum0 += e0 + e1;
        sum1 += e2 + e3;
        pa[jn / 2][(jn % 2) * 2] = pack(e0, e1);
        pa[jn / 2][(jn % 2) * 2 + 1] = pack(e2, e3);
      }
      l0 = alpha0 * l0 + sum0;
      l1 = alpha1 * l1 + sum1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha0;
        o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1;
        o[4 * i + 3] *= alpha1;
      }

      // o += p v: 8 steps of 16 keys; v is MN-major (d contiguous)
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk)
        wgmma_pv<D>(o, pa[kk], sw128_desc(v_s + kk * 16 * kAtom * 2, L::kBlock / 16, 64));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
    bf16* ob = out + b * p.os.b + h * p.os.h;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int c = 8 * i + 2 * t;
      if (row0 < p.sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)row0 * p.os.s + c) =
            pack(o[4 * i] * inv0, o[4 * i + 1] * inv0);
      if (row0 + 8 < p.sq)
        *reinterpret_cast<uint32_t*>(ob + (long long)(row0 + 8) * p.os.s + c) =
            pack(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// a [B, S, Hx, D] bf16 operand with element strides st as a 4-d tensor map
// (d, head, position, batch) whose box is 64 columns x one head x 128 rows.
// The d extent is D itself: at d 80 the box at column 64 reads columns 64..79
// and fills 80..127 with zeros, at d 32 the one box fills 32..63, so no
// column past D (a neighbouring head's, in a fused projection) is read
bool encode_map(CUtensorMap* map, const void* ptr, long long B, long long S, long long Hx, int D,
                const Strides& st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hx, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kAtom, 1, (cuuint32_t)kWK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, const Problem& p,
                 long long B, long long KV, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!encode_map(&qm, q, B, p.sq, p.H, D, p.qs) || !encode_map(&km, k, B, p.sk, KV, D, p.ks) ||
      !encode_map(&vm, v, B, p.sk, KV, D, p.vs))
    return (int)cudaErrorInvalidValue;
  const int smem = WgLayout<D>::kBytes + 1024;  // + room to align the base to 1024
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * p.H), (unsigned)((p.sq + kWQ - 1) / kWQ));
  flash_attention_wgmma_kernel<D><<<grid, kWThreads, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(out), p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, const Problem& p,
           long long B, long long KV, cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  // bf16 with a whole query tile: the wgmma kernel at every head dim.  A
  // refused launch returns its error (no retry on another kernel).  sk = 0
  // has no tensor map; the mma.sync kernel writes its zeros
  if constexpr (!kF32) {
    if (p.sq >= kWQ && p.sk >= 1) return launch_wgmma<D>(q, k, v, out, p, B, KV, stream);
  }
  constexpr size_t smem = kF32 ? smem_fp32<D>() : smem_bf16<D>();
  const dim3 grid((unsigned)(B * p.H), (unsigned)((p.sq + kBQ - 1) / kBQ));
  cudaError_t err;
  if constexpr (kF32) {
    err = cudaFuncSetAttribute(flash_attention_fp32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_fp32_kernel<D><<<grid, kThreads32, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), p);
  } else {
    err = cudaFuncSetAttribute(flash_attention_bf16_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_attention_bf16_kernel<D><<<grid, kThreads16, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(long long d, const void* q, const void* k, const void* v, void* out,
               const Problem& p, long long B, long long KV, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, p, B, KV, s);
    case 64: return launch<T, 64>(q, k, v, out, p, B, KV, s);
    case 80: return launch<T, 80>(q, k, v, out, p, B, KV, s);
    case 128: return launch<T, 128>(q, k, v, out, p, B, KV, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr, const long long* st) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && st[0] % 8 == 0 && st[1] % 8 == 0 &&
         st[2] % 8 == 0;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (b, s, h)
// of q, k, v and out in that order; the d axis of each is contiguous; in
// bf16 every operand is 16-byte aligned with strides that are multiples of
// 8.  window < 0 means no window.  The caller guarantees shapes, types and
// pointers on one device; out is [B, sq, H, d] in the strides given.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, long long B, long long H, long long KV,
                                   long long sq, long long sk, long long d,
                                   const long long* strides, int causal, long long window,
                                   long long q_offset, float scale, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV != 0 || sq < 1 || sk < 0 || B * H > 0x7fffffffLL ||
      (sq + kBQ - 1) / kBQ > 65535 || sq + q_offset > 0x7fffffffLL || sk > 0x7fffffffLL ||
      q_offset < 0 || window < -1 || window > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Problem p;
  Strides* st[4] = {&p.qs, &p.ks, &p.vs, &p.os};
  for (int i = 0; i < 4; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.H = (int)H;
  p.group = (int)(H / KV);
  p.sq = (int)sq;
  p.sk = (int)sk;
  p.causal = causal;
  p.window = (int)window;
  p.q_offset = (int)q_offset;
  p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(d, q, k, v, out, p, B, KV, s);
  if (dtype == 1) {
    const void* ptrs[4] = {q, k, v, out};
    for (int i = 0; i < 4; ++i)
      if (!aligned16(ptrs[i], strides + 3 * i)) return (int)cudaErrorMisalignedAddress;
    return dispatch_d<bf16>(d, q, k, v, out, p, B, KV, s);
  }
  return (int)cudaErrorInvalidValue;
}
