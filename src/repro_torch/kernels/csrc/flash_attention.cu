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
// Design, common to both kernels below:
//   * one block per (batch * head, tile of kBQ = 64 queries); the TPU's
//     sequential k axis is a loop inside the block over tiles of kBK = 64
//     keys, staged in dynamic shared memory;
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
// bf16 (the model's type): the two products run on the tensor cores as
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), 4 warps of 16 query rows
// each.  A warp keeps its q fragments, its 16 x 64 score tile and its
// 16 x d accumulator in registers; the score fragments are the A operand of
// p @ v as they stand (the m16n8k16 C and A layouts line up), so p never
// goes through shared memory.  K and V tiles are staged with 16-byte loads
// (operands 16-byte aligned, strides multiples of 8: the wrapper checks).
// wgmma, TMA and double-buffered staging are later work.
//
// fp32 (tests, reduced configs): scalar fp32 FMAs on the CUDA cores (the
// tensor cores would round the operands): 256 threads, each owning 4 query
// rows x 4 key columns of the score tile and 4 rows x d/16 columns of the
// output; a row's max and sum are reduced across its 16 threads with
// shuffles.

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, const Problem& p,
           long long BH, cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr size_t smem = kF32 ? smem_fp32<D>() : smem_bf16<D>();
  const dim3 grid((unsigned)BH, (unsigned)((p.sq + kBQ - 1) / kBQ));
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
               const Problem& p, long long BH, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, p, BH, s);
    case 64: return launch<T, 64>(q, k, v, out, p, BH, s);
    case 80: return launch<T, 80>(q, k, v, out, p, BH, s);
    case 128: return launch<T, 128>(q, k, v, out, p, BH, s);
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
  if (dtype == 0) return dispatch_d<float>(d, q, k, v, out, p, B * H, s);
  if (dtype == 1) {
    const void* ptrs[4] = {q, k, v, out};
    for (int i = 0; i < 4; ++i)
      if (!aligned16(ptrs[i], strides + 3 * i)) return (int)cudaErrorMisalignedAddress;
    return dispatch_d<bf16>(d, q, k, v, out, p, B * H, s);
  }
  return (int)cudaErrorInvalidValue;
}
