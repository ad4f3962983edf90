// Masked softmax over the fanout + head-wise combine, for every branch slot
// of one metatree level (the attention epilogue of R-GAT and HGT when the
// logit and value projections run outside the kernel), for sm_90a.
//
//   alpha[s,i,j,h] = masked_softmax_j(e[s,i,:,h], mask[s,i,:])
//   out[s,i,h*dh+d] = sum_j alpha[s,i,j,h] * v[s,i,j,h,d]
//
// Replaces the Pallas TPU kernel stacked_softmax_combine_pallas
// (_softmax_combine_kernel) in
// src/repro/kernels/stacked_relation_agg/kernel.py:227, whose grid (slot,
// node block) held a [bn, f, nh*dh] block of v in VMEM so that the attention
// probabilities never reached HBM.
//
// Numerics are relmod.masked_softmax's, step for step: masked logits are
// replaced by the float32 minimum, the max over f is subtracted, z =
// exp(e - max) * mask, alpha = z / max(sum z, 1e-9); a fully masked row
// therefore gives alpha = 0 and out = 0, never NaN.
//
// What bounds it on an H100: memory.  Per (row, column) it reads f values
// of v and does about 4 f operations; e and the mask are f * nh and f
// values per row, shared by the dh columns of a head.  At the training
// leaf (rb, n, f, nh, dh) = (6, 4096, 3, 4, 16) the call moves about 26 MB
// (v 18.9, out 6.3, e 1.2), some 7.9 us of HBM time.
//
// What held the first version back (0.78 TB/s at the leaf, 0.55-0.69 at the
// serving blocks): one thread per (row, column) redid its head's whole
// softmax (three passes over f, 2 f expf and f divisions, repeated by the dh
// threads of a head), and read v last, one 4-byte load per neighbour after
// two dependent passes over e, so few bytes of v were ever in flight.
//
// Design:
//   * a block of 256 threads takes R = 256 / ceil(H / 4) rows of one slot
//     (16 at H = 64; the C entry point picks R from H unless the caller
//     names fewer: the tuning table's launch parameter, choose); a thread
//     owns one 16-byte chunk (4 columns) of a row (threads past R rows idle);
//   * first the block's logits go out by cp.async (4-byte copies through
//     e's strides, one group), then each thread's loads of v for its first
//     KJ neighbours (KJ = 4 at f <= 4, else 16) into registers, then the
//     mask bytes: so v is in flight while the softmax is taken, and the
//     logits do not queue behind it.  v loads as float4 (__ldg) when dh % 4
//     == 0 and v's base and strides lie on the 16-byte grid, else 4-byte
//     loads (a thread's columns may then straddle heads): the C entry point
//     picks the instantiation, which keeps the float4 one's registers low;
//   * the softmax is taken once per (row, head), not per column: the max and
//     the sum of z in order of j by one thread per (row, head), z = exp(e -
//     max) and alpha = z / max(sum, 1e-9) spread over every thread of the
//     block, all in shared memory;
//   * each thread then sums alpha_j * v_j over its neighbours in order, with
//     fmaf, from the registers its loads filled;
//   * any f: logits are staged kF = 16 neighbours at a time; at f <= kF the
//     staged chunk serves every step, beyond it the max and the sum take a
//     pass over the chunks first, then alpha and the combine go chunk by
//     chunk, so shared memory does not grow with f;
//   * H > 1024 spreads a row's columns over blocks (grid.z), each taking the
//     row's softmax itself; ragged n is masked in the kernel;
//   * e and v are read through their strides (v's last dimension
//     contiguous): HGT's values arrive as a permuted view [rb, nh, n, f, dh]
//     from its einsum, and a contiguous copy in front of the kernel would
//     move more bytes than the kernel does.
// The outputs equal the first version's bit for bit: the same expf, the same
// division per term, the sum of z and each column's sum over j in order.
// On the card (H100, variants timed in one call): 1.6 TB/s at the leaf;
// without any load of v the kernel still takes three quarters of its time,
// so what bounds it now is each block's serial chain (logits in, max, z,
// sum, alpha, each behind a barrier) with too few blocks an SM to hide it,
// not the bytes of v (PERF.md has the variants and their times).

#include <cfloat>

#include "fp32_tile.cuh"  // the cp.async helpers

namespace {

using fp32_tile::cp_async4;
using fp32_tile::cp_async_commit;
using fp32_tile::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kF = 16;  // neighbours of one staged chunk of logits

struct Strides {
  long long s, n, f, h;  // of e [rb, n, f, nh]; of v [rb, n, f, nh, dh] (d: 1)
};

// VEC: dh % 4 == 0 and v's base and strides on the 16-byte grid, so a
// thread's 4 columns lie in one head and load as one float4
template <int KJ, bool VEC>
__global__ void __launch_bounds__(kThreads, KJ <= 4 ? 4 : 2) stacked_softmax_combine_kernel(
    const float* __restrict__ e, const uint8_t* __restrict__ mask,
    const float* __restrict__ v, float* __restrict__ out, long long n, int f, int nh,
    int dh, int R, int fcd, Strides es, Strides vs) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = (fcd + 1) * nh;  // a row's logits; + nh keeps rows off each other's banks
  float* a_s = smem;                 // [R][pitch]: a chunk's logits, then z, then alpha
  float* mx_s = a_s + R * pitch;     // [R * nh] max over f
  float* den_s = mx_s + R * nh;      // [R * nh] running sum of z, then max(sum, 1e-9)
  uint8_t* m_s = reinterpret_cast<uint8_t*>(den_s + R * nh);  // [R][fcd] mask bytes

  const int s = blockIdx.y;
  const int H = nh * dh;
  const int C = (H + 3) / 4;                  // 16-byte chunks of a row
  const int c0 = blockIdx.z * kThreads;       // this block's first chunk
  const int Cb = min(C - c0, kThreads);       // and its chunk count
  const long long row0 = (long long)blockIdx.x * R;
  const int t = threadIdx.x;
  const int r = t / Cb;
  const int col = 4 * (c0 + t % Cb);
  const long long row = row0 + r;
  const bool active = r < R && row < n;
  const int nch = (f + fcd - 1) / fcd;
  const float* vrow = v + (long long)s * vs.s + (active ? row : 0) * vs.n;
  const int head = min(col, H - 1) / dh;  // the head of this thread's first column

  float4 vr[KJ];
  // neighbours j0 .. j0 + cnt of this thread's 4 columns into vr
  auto load_group = [&](int j0, int cnt) {
#pragma unroll
    for (int q = 0; q < KJ; ++q) {
      if (!active || q >= cnt) continue;
      const float* p = vrow + (long long)(j0 + q) * vs.f;
      if constexpr (VEC) {
        vr[q] = __ldg(reinterpret_cast<const float4*>(p + head * vs.h + col % dh));
      } else {
        float x[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = col + k;
          x[k] = c < H ? __ldg(p + (c / dh) * vs.h + c % dh) : 0.f;
        }
        vr[q] = make_float4(x[0], x[1], x[2], x[3]);
      }
    }
  };
  // the elements (j, h) of this thread's row of a staged chunk, walked by
  // carries with no division: the lanes of a row take j * nh + h = lane,
  // lane + Cb, ... (coalesced in e when e is contiguous)
  const int lane = t % Cb, dj = Cb / nh, dhh = Cb % nh;
  auto each_of_row = [&](int fc, auto&& body) {
    if (r >= R) return;
    int jj = lane / nh, hh = lane % nh;
    for (int idx = lane; idx < fc * nh; idx += Cb) {
      body(jj, hh);
      jj += dj;
      hh += dhh;
      if (hh >= nh) {
        hh -= nh;
        ++jj;
      }
    }
  };
  // logits of neighbours j0 .. j0 + fc of the block's rows, by cp.async (one
  // group; rows past n zero-filled)
  auto stage_e = [&](int j0, int fc) {
    each_of_row(fc, [&](int jj, int hh) {
      cp_async4(a_s + r * pitch + jj * nh + hh,
                row < n ? e + s * es.s + row * es.n + (j0 + jj) * es.f + hh * es.h : e, row < n);
    });
    cp_async_commit();
  };
  auto stage_mask = [&](int j0, int fc) {
    for (int q = t; q < R * fc; q += kThreads) {
      const int rr = q / fc, jj = q - rr * fc;
      const long long rw = row0 + rr;
      m_s[rr * fcd + jj] = rw < n ? mask[((long long)s * n + rw) * f + j0 + jj] : 0;
    }
  };
  // a chunk staged and visible to all (the previous one read by all first)
  auto stage = [&](int j0, int fc) {
    __syncthreads();
    stage_e(j0, fc);
    stage_mask(j0, fc);
    cp_async_wait<0>();
    __syncthreads();
  };
  // z = exp(e - max) where the mask is set, over the staged chunk, spread
  // over every thread (masked terms are never read)
  auto exp_chunk = [&](int fc) {
    each_of_row(fc, [&](int jj, int hh) {
      float* a = a_s + r * pitch + jj * nh + hh;
      *a = expf((m_s[r * fcd + jj] ? *a : -FLT_MAX) - mx_s[r * nh + hh]);
    });
  };

  // the first chunk's logits, then this thread's first values, are in
  // flight while the mask bytes are read
  const int fc0 = min(f, fcd);
  stage_e(0, fc0);
  load_group(0, min(fc0, KJ));
  stage_mask(0, fc0);
  cp_async_wait<0>();
  __syncthreads();

  // the softmax's max, one thread per (row, head), over every chunk
  for (int c = 0; c < nch; ++c) {
    const int fc = min(fcd, f - c * fcd);
    if (c > 0) stage(c * fcd, fc);
    for (int p = t; p < R * nh; p += kThreads) {
      const int rr = p / nh, hh = p - rr * nh;
      float mx = c == 0 ? -FLT_MAX : mx_s[p];
#pragma unroll 4
      for (int jj = 0; jj < fc; ++jj)
        mx = fmaxf(mx, m_s[rr * fcd + jj] ? a_s[rr * pitch + jj * nh + hh] : -FLT_MAX);
      mx_s[p] = mx;
    }
  }
  // then z over every thread, and the sum of z in order of j, one thread per
  // (row, head)
  for (int c = 0; c < nch; ++c) {
    const int fc = min(fcd, f - c * fcd);
    if (nch > 1) stage(c * fcd, fc);
    __syncthreads();  // the max (and the chunk) visible to all
    exp_chunk(fc);
    __syncthreads();
    for (int p = t; p < R * nh; p += kThreads) {
      const int rr = p / nh, hh = p - rr * nh;
      float sum = c == 0 ? 0.f : den_s[p];
#pragma unroll 4
      for (int jj = 0; jj < fc; ++jj)
        sum += a_s[rr * pitch + jj * nh + hh] * (m_s[rr * fcd + jj] ? 1.f : 0.f);
      den_s[p] = c == nch - 1 ? fmaxf(sum, 1e-9f) : sum;
    }
  }

  // alpha = z / max(sum, 1e-9) over every thread, and the combine, chunk by
  // chunk (one chunk at f <= fcd: z is still staged)
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nch; ++c) {
    const int j0 = c * fcd, fc = min(fcd, f - j0);
    if (nch > 1) {
      stage(j0, fc);
      exp_chunk(fc);
    }
    __syncthreads();  // z (and the denominators) visible to all
    each_of_row(fc, [&](int jj, int hh) {
      a_s[r * pitch + jj * nh + hh] /= den_s[r * nh + hh];
    });
    __syncthreads();
    for (int jg = 0; jg < fc; jg += KJ) {
      const int cnt = min(KJ, fc - jg);
      if (c > 0 || jg > 0) load_group(j0 + jg, cnt);
      if (!active) continue;
      const float* al = a_s + r * pitch + jg * nh;
      const uint8_t* ml = m_s + r * fcd + jg;
#pragma unroll
      for (int q = 0; q < KJ; ++q) {
        if (q >= cnt) break;
        if (!ml[q]) continue;  // alpha is exactly 0 there
        const float* aq = al + q * nh;
        float a[4];
        if constexpr (VEC) {
          a[0] = a[1] = a[2] = a[3] = aq[head];
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) a[k] = aq[min(col + k, H - 1) / dh];
        }
        acc.x = fmaf(a[0], vr[q].x, acc.x);
        acc.y = fmaf(a[1], vr[q].y, acc.y);
        acc.z = fmaf(a[2], vr[q].z, acc.z);
        acc.w = fmaf(a[3], vr[q].w, acc.w);
      }
    }
  }

  if (!active) return;
  float* o = out + ((long long)s * n + row) * H + col;
  if (H % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    *reinterpret_cast<float4*>(o) = acc;
  } else {
    o[0] = acc.x;
    if (col + 1 < H) o[1] = acc.y;
    if (col + 2 < H) o[2] = acc.z;
    if (col + 3 < H) o[3] = acc.w;
  }
}

template <int KJ, bool VEC>
int launch(const float* e, const uint8_t* mask, const float* v, float* out, long long n,
           int f, int nh, int dh, int R, int fcd, Strides es, Strides vs, dim3 grid,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(stacked_softmax_combine_kernel<KJ, VEC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  stacked_softmax_combine_kernel<KJ, VEC><<<grid, kThreads, smem, stream>>>(
      e, mask, v, out, n, f, nh, dh, R, fcd, es, vs);
  return (int)cudaGetLastError();
}

template <int KJ>
int launch_kj(bool vec, const float* e, const uint8_t* mask, const float* v, float* out,
              long long n, int f, int nh, int dh, int R, int fcd, Strides es, Strides vs,
              dim3 grid, size_t smem, cudaStream_t stream) {
  return vec ? launch<KJ, true>(e, mask, v, out, n, f, nh, dh, R, fcd, es, vs, grid, smem, stream)
             : launch<KJ, false>(e, mask, v, out, n, f, nh, dh, R, fcd, es, vs, grid, smem,
                                 stream);
}

// shared bytes of a block of R rows at chunk depth fcd
size_t smem_bytes(long long R, long long nh, long long fcd) {
  return sizeof(float) * (size_t)(R * (fcd + 1) * nh + 2 * R * nh) + (size_t)(R * fcd);
}

constexpr size_t kMaxSmem = 232448;  // opt-in shared memory of one block on sm_90

// The layout of a launch: R rows per block and the chunk depth fcd.  The
// rule (R = 0, fcd = 0): the most rows 256 threads hold, 256 / ceil(H / 4),
// and kF neighbours a chunk, fewer when that would not fit in the default
// 48 KB (many heads a row); past 48 KB only at depth 1.  A caller (the
// tuning table) may name R in 1 .. that most and fcd in 1 .. kF; R = 0 in
// the result: refused (outside those ranges, or past 227 KB).
struct Layout {
  long long R = 0, fcd = 0;
  size_t smem = 0;
};

Layout choose(long long nh, long long dh, long long R, long long fcd) {
  Layout L;
  const long long C = (nh * dh + 3) / 4;
  const long long rmax = C >= kThreads ? 1 : kThreads / C;
  if (R < 0 || R > rmax || fcd < 0 || fcd > kF) return L;
  if (R == 0) R = rmax;
  if (fcd == 0) {
    fcd = kF;
    while (fcd > 1 && smem_bytes(R, nh, fcd) > 48 * 1024) fcd /= 2;
  }
  const size_t smem = smem_bytes(R, nh, fcd);
  if (smem > kMaxSmem) return L;
  L.R = R, L.fcd = fcd, L.smem = smem;
  return L;
}

}  // namespace

// The rows per block and the chunk depth stacked_softmax_combine_fwd takes
// for this head shape, R and fcd (0 = refused): what the wrapper records
// beside each launch's shape.
extern "C" long long stacked_softmax_combine_rows(long long nh, long long dh, long long R,
                                                  long long fcd) {
  if (nh < 1 || dh < 1 || nh * dh > 0x7fffffff - 3) return 0;
  return choose(nh, dh, R, fcd).R;
}
extern "C" long long stacked_softmax_combine_depth(long long nh, long long dh, long long R,
                                                   long long fcd) {
  if (nh < 1 || dh < 1 || nh * dh > 0x7fffffff - 3) return 0;
  return choose(nh, dh, R, fcd).fcd;
}

// Launches on `stream` with R rows per block and chunk depth fcd (0 each:
// the rule; see choose; the launch parameters the tuning table sets);
// returns cudaGetLastError() (0 = launched; cudaErrorInvalidValue for a
// layout choose refuses).  e and v
// are read through their element strides (es_*, vs_*: slot, row, neighbour,
// head; v's last dimension has stride 1); mask [rb, n, f] and out [rb, n,
// nh * dh] are contiguous.  The caller guarantees shapes and fp32.
extern "C" int stacked_softmax_combine_fwd(
    const float* e, const uint8_t* mask, const float* v, float* out, long long rb,
    long long n, long long f, long long nh, long long dh, long long es_s, long long es_n,
    long long es_f, long long es_h, long long vs_s, long long vs_n, long long vs_f,
    long long vs_h, long long rows, long long depth, void* stream) {
  if (rb < 1 || rb > 65535 || n < 1 || f < 0 || nh < 1 || dh < 1 || f > 0x7fffffff ||
      nh * dh > 0x7fffffff - 3) {
    return (int)cudaErrorInvalidValue;
  }
  const long long C = (nh * dh + 3) / 4;
  const Layout L = choose(nh, dh, rows, depth);
  const long long R = L.R, fcd = L.fcd;
  const long long col_tiles = (C + kThreads - 1) / kThreads;
  if (R == 0 || col_tiles > 65535 || (n + R - 1) / R > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = L.smem;
  // a dimension of one element reads at index 0 only: its stride may be
  // anything, and must not turn the 16-byte loads off
  const Strides es{rb > 1 ? es_s : 0, n > 1 ? es_n : 0, f > 1 ? es_f : 0, nh > 1 ? es_h : 0};
  const Strides vs{rb > 1 ? vs_s : 0, n > 1 ? vs_n : 0, f > 1 ? vs_f : 0, nh > 1 ? vs_h : 0};
  const bool vec = dh % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   (vs.s | vs.n | vs.f | vs.h) % 4 == 0;
  const dim3 grid((unsigned)((n + R - 1) / R), (unsigned)rb, (unsigned)col_tiles);
  cudaStream_t st = (cudaStream_t)stream;
  return f <= 4 ? launch_kj<4>(vec, e, mask, v, out, n, (int)f, (int)nh, (int)dh, (int)R,
                               (int)fcd, es, vs, grid, smem, st)
                : launch_kj<16>(vec, e, mask, v, out, n, (int)f, (int)nh, (int)dh, (int)R,
                                (int)fcd, es, vs, grid, smem, st);
}
