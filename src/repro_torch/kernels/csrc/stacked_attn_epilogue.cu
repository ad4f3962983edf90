// Fused attention AGG_r (R-GAT, HGT) for every branch slot of one metatree
// level, for sm_90a.
//
//   z0 = h[s] @ we[ue[s]]                 [n*f, H]      H = nh * dh
//   v0 = h[s] @ wv[uv[s]]                 (z0 when wv is null: R-GAT)
//   e  = (z0 . pe[ua[s]]) . qv * scale (+ eb), per head; leaky_relu if slope
//   a  = masked softmax of e over the f neighbours
//   out[s, i] = sum_j a_j * (v0_j . pv[ua[s]])
//
// Replaces the Pallas TPU kernel stacked_attn_epilogue_pallas
// (_attn_epilogue_kernel) in src/repro/kernels/stacked_relation_agg/kernel.py.
// That kernel walked a sequential grid (slot, node block, d_in chunk), kept
// the [bn, f, H] projections in VMEM scratch across the d_in chunks, picked
// the weight blocks through a scalar-prefetched slot->stack index and ran
// the epilogue on the last chunk.
//
// What bounds it on an H100: at the training leaf level (rb, n, f, d_in,
// H = 6, 4096, 3, 128, 64) R-GAT moves about 70 MB (h 38, z0 residual 19)
// against 1.2 GFLOP, so bytes bound it; HGT's second projection and
// transforms double the FLOPs (2.7 G) and it becomes bound by the fp32 CUDA
// cores (67 TFLOP/s) rather than by HBM.
//
// Design:
//   * one block per (tile of destination rows, slot); the d_in loop that the
//     TPU grid carried in scratch runs inside the block;
//   * the block reads us[0..2][s] itself and offsets into the [U, d_in, H]
//     stacks, so no weight is copied per slot;
//   * a tile holds rows = max(1, block_n / f) rows, shrunk further until its
//     shared memory fits: every f of a row stays in one block, so the
//     softmax over f never crosses blocks.  The projections of the tile's
//     rows*f (row, neighbour) pairs are computed in passes of 64 pairs x 64
//     columns: per d_in chunk the h tile and the weight tile(s) are staged
//     in shared memory and each of the 256 threads accumulates a 4 x 4
//     register tile (two for HGT) with fp32 FMAs; the results land in
//     shared memory as z0 (and v0), [rows*f, H] fp32;
//   * the epilogue runs from shared memory in the same block: per row the
//     query q' = pe . qv (HGT) or qv, the logits z0 . q' * scale (+ eb),
//     leaky_relu, the masked softmax (finfo.min fill, max, expf, sum clamped
//     at 1e-9, divide: the reference's numerics; no --use_fast_math), the
//     combine sum_j a_j v0_j and, for HGT, one product with pv.  HGT's two
//     [dh, dh] transforms are thus applied once per row instead of once per
//     neighbour (z0.pe.qv = z0.(pe.qv), sum_j a_j (v0_j.pv) = (sum_j a_j
//     v0_j).pv): the same function, summed in another order;
//   * with residual pointers z0 (and v0) are also written out for the
//     backward, each tile one contiguous run;
//   * qv is read through a slot stride and a node stride: R-GAT passes its
//     per-slot a_src vector with node stride 0 (no [rb, n, H] copy), HGT
//     its materialized [rb, n, H] queries;
//   * ragged n, d_in, f and H are masked inside the kernel: no padded copies
//     of any operand (the reference pads and slices).
// Limit: one destination row's f neighbours must fit in shared memory,
//   4 * (f * (H * (1 + two) + nh) + H * (1 + post)) bytes plus the staging
//   tiles, within 227 KB: f <= 392 for HGT and f <= 792 for R-GAT at H = 64,
//   nh = 4, block_in = 32.  The wrapper raises a named error beyond that.
// Later work (not here): wgmma/TMA for the projections, cp.async double
// buffering of the staging tiles, bf16 storage.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 64;     // (row, neighbour) pairs of one projection pass
constexpr int kCols = 64;      // projection columns of one pass
constexpr int kMaxChunk = 64;  // largest d_in chunk (block_in)
constexpr size_t kMaxSmem = 232448;  // opt-in shared memory of one block on sm_90

size_t smem_floats(int rows, int f, int H, int nh, int bc, bool two, bool post) {
  const size_t m = (size_t)rows * f;
  return m * H * (two ? 2 : 1) + (size_t)kPairs * (bc + 1) +
         (size_t)bc * kCols * (two ? 2 : 1) + (size_t)rows * H * (post ? 2 : 1) + m * nh;
}

template <bool kTwo>
__global__ void __launch_bounds__(kThreads) stacked_attn_epilogue_kernel(
    const float* __restrict__ h, const uint8_t* __restrict__ mask,
    const float* __restrict__ qv, long long qv_ss, long long qv_ns,
    const float* __restrict__ eb, const float* __restrict__ we,
    const float* __restrict__ wv, const float* __restrict__ pe,
    const float* __restrict__ pv, const int* __restrict__ us,
    float* __restrict__ out, float* __restrict__ z0, float* __restrict__ v0,
    int rb, long long n, int f, int d_in, int nh, int dh, float scale, float slope,
    int has_slope, int rows, int bc) {
  extern __shared__ float smem[];
  const int H = nh * dh;
  const bool post = pe != nullptr;
  const int s = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrow = (int)min((long long)rows, n - row0);
  const int M = nrow * f;
  const size_t mcap = (size_t)rows * f;
  float* zs = smem;                                  // [rows*f][H]
  float* vs = kTwo ? zs + mcap * H : zs;             // [rows*f][H] (HGT)
  float* hs = zs + mcap * H * (kTwo ? 2 : 1);        // [kPairs][bc + 1]
  float* ws = hs + kPairs * (bc + 1);                // [bc][kCols]
  float* wvs = ws + bc * kCols;                      // [bc][kCols] (HGT)
  float* qs = ws + bc * kCols * (kTwo ? 2 : 1);      // [rows][H]
  float* os = qs + (size_t)rows * H;                 // [rows][H] (with pv)
  float* es = os + (post ? (size_t)rows * H : 0);    // [rows*f][nh]

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int ue = us[s], uv = us[rb + s], ua = us[2 * rb + s];
  const long long pair0 = ((long long)s * n + row0) * f;
  const float* hb = h + pair0 * d_in;
  const float* weu = we + (long long)ue * d_in * H;
  const float* wvu = kTwo ? wv + (long long)uv * d_in * H : nullptr;

  // 1. the projections of the tile's M pairs, into shared memory
  for (int p0 = 0; p0 < M; p0 += kPairs) {
    for (int c0 = 0; c0 < H; c0 += kCols) {
      float az[4][4], av[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) az[i][j] = av[i][j] = 0.f;
      }
      for (int k0 = 0; k0 < d_in; k0 += bc) {
        const int kk = min(bc, d_in - k0);
        for (int e = tid; e < kPairs * bc; e += kThreads) {
          const int m = e / bc, k = e % bc;
          hs[m * (bc + 1) + k] =
              (p0 + m < M && k < kk) ? hb[(long long)(p0 + m) * d_in + k0 + k] : 0.f;
        }
        for (int e = tid; e < bc * kCols; e += kThreads) {
          const int k = e / kCols, c = e % kCols;
          const bool ok = k < kk && c0 + c < H;
          const long long off = (long long)(k0 + k) * H + c0 + c;
          ws[e] = ok ? weu[off] : 0.f;
          if (kTwo) wvs[e] = ok ? wvu[off] : 0.f;
        }
        __syncthreads();
        for (int k = 0; k < kk; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = hs[(tr + 16 * i) * (bc + 1) + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = ws[k * kCols + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) az[i][j] = fmaf(a[i], b[j], az[i][j]);
          }
          if (kTwo) {
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = wvs[k * kCols + tc + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j) av[i][j] = fmaf(a[i], b[j], av[i][j]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = p0 + tr + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tc + 16 * j;
          if (m < M && c < H) {
            zs[(size_t)m * H + c] = az[i][j];
            if (kTwo) vs[(size_t)m * H + c] = av[i][j];
          }
        }
      }
    }
  }
  __syncthreads();

  // 2. the residuals for the backward: one contiguous run per tile
  if (z0 != nullptr) {
    float* zg = z0 + pair0 * H;
    for (int e = tid; e < M * H; e += kThreads) zg[e] = zs[e];
    if (kTwo) {
      float* vg = v0 + pair0 * H;
      for (int e = tid; e < M * H; e += kThreads) vg[e] = vs[e];
    }
  }

  // 3. per row and head the query the logits contract with: pe . qv (HGT)
  const float* peu = post ? pe + (long long)ua * nh * dh * dh : nullptr;
  const float* pvu = post ? pv + (long long)ua * nh * dh * dh : nullptr;
  for (int e = tid; e < nrow * H; e += kThreads) {
    const int r = e / H, c = e % H;
    const float* q = qv + (long long)s * qv_ss + (row0 + r) * qv_ns;
    float x;
    if (post) {
      const int hd = c / dh, d = c % dh;
      const float* pr = peu + ((long long)hd * dh + d) * dh;
      const float* qh = q + hd * dh;
      x = 0.f;
      for (int t = 0; t < dh; ++t) x = fmaf(pr[t], qh[t], x);
    } else {
      x = q[c];
    }
    qs[e] = x;
  }
  __syncthreads();

  // 4. logits
  for (int e = tid; e < M * nh; e += kThreads) {
    const int m = e / nh, hd = e % nh, r = m / f;
    const float* z = zs + (size_t)m * H + hd * dh;
    const float* q = qs + (size_t)r * H + hd * dh;
    float x = 0.f;
    for (int d = 0; d < dh; ++d) x = fmaf(z[d], q[d], x);
    x *= scale;
    if (eb != nullptr) x += eb[((long long)s * n + row0 + r) * nh + hd];
    if (has_slope) x = x >= 0.f ? x : slope * x;
    es[e] = x;
  }
  __syncthreads();

  // 5. masked softmax over the f neighbours of each (row, head)
  for (int e = tid; e < nrow * nh; e += kThreads) {
    const int r = e / nh, hd = e % nh;
    const uint8_t* mk = mask + ((long long)s * n + row0 + r) * f;
    float* er = es + (size_t)r * f * nh + hd;
    float mx = -FLT_MAX;
    for (int j = 0; j < f; ++j) mx = fmaxf(mx, mk[j] ? er[j * nh] : -FLT_MAX);
    float sum = 0.f;
    for (int j = 0; j < f; ++j) {
      const float z = mk[j] ? expf(er[j * nh] - mx) : 0.f;
      er[j * nh] = z;
      sum += z;
    }
    const float den = fmaxf(sum, 1e-9f);
    for (int j = 0; j < f; ++j) er[j * nh] = er[j * nh] / den;
  }
  __syncthreads();

  // 6. the combine, then (HGT) the values transform
  const float* V = kTwo ? vs : zs;
  for (int e = tid; e < nrow * H; e += kThreads) {
    const int r = e / H, c = e % H, hd = c / dh;
    float x = 0.f;
    for (int j = 0; j < f; ++j) {
      const size_t m = (size_t)r * f + j;
      x = fmaf(es[m * nh + hd], V[m * H + c], x);
    }
    if (post) {
      os[e] = x;
    } else {
      out[((long long)s * n + row0 + r) * H + c] = x;
    }
  }
  if (post) {
    __syncthreads();
    for (int e = tid; e < nrow * H; e += kThreads) {
      const int r = e / H, c = e % H, hd = c / dh, t = c % dh;
      const float* o = os + (size_t)r * H + hd * dh;
      const float* pc = pvu + (long long)hd * dh * dh + t;
      float x = 0.f;
      for (int d = 0; d < dh; ++d) x = fmaf(o[d], pc[d * dh], x);
      out[((long long)s * n + row0 + r) * H + c] = x;
    }
  }
}

}  // namespace

// Shared memory in bytes of one block holding `rows` destination rows.
extern "C" long long stacked_attn_epilogue_smem(int rows, int f, int nh, int dh,
                                                int block_in, int two, int post) {
  return (long long)(sizeof(float) *
                     smem_floats(rows, f, nh * dh, nh, block_in, two != 0, post != 0));
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  wv null
// shares z0 as the values (R-GAT); pe and pv are both null or both given;
// eb, z0 and v0 may be null (v0 is written only with wv).  The caller
// guarantees shapes, contiguity of every operand but qv (read through
// qv_ss / qv_ns) and 0 <= us[k][s] < the rows of the stack it indexes.
extern "C" int stacked_attn_epilogue(
    const float* h, const uint8_t* mask, const float* qv, long long qv_ss,
    long long qv_ns, const float* eb, const float* we, const float* wv,
    const float* pe, const float* pv, const int* us, float* out, float* z0, float* v0,
    long long rb, long long n, long long f, long long d_in, int nh, int dh,
    float scale, float slope, int has_slope, int rows, int block_in, void* stream) {
  const bool two = wv != nullptr, post = pe != nullptr;
  if (rows < 1 || block_in < 1 || block_in > kMaxChunk || rb < 1 || rb > 65535 ||
      n < 1 || f < 1 || d_in < 1 || nh < 1 || dh < 1 || (pe == nullptr) != (pv == nullptr) ||
      (two && z0 != nullptr && v0 == nullptr) || f * rows > (1LL << 24) ||
      (n + rows - 1) / rows > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(float) * smem_floats(rows, (int)f, nh * dh, nh, block_in, two, post);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n + rows - 1) / rows), (unsigned)rb);
  cudaError_t err;
  if (two) {
    err = cudaFuncSetAttribute(stacked_attn_epilogue_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    stacked_attn_epilogue_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        h, mask, qv, qv_ss, qv_ns, eb, we, wv, pe, pv, us, out, z0, v0, (int)rb, n,
        (int)f, (int)d_in, nh, dh, scale, slope, has_slope, rows, block_in);
  } else {
    err = cudaFuncSetAttribute(stacked_attn_epilogue_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    stacked_attn_epilogue_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        h, mask, qv, qv_ss, qv_ns, eb, we, nullptr, pe, pv, us, out, z0, nullptr,
        (int)rb, n, (int)f, (int)d_in, nh, dh, scale, slope, has_slope, rows, block_in);
  }
  return (int)cudaGetLastError();
}
