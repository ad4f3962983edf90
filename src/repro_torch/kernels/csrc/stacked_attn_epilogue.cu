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
// (_attn_epilogue_kernel) in src/repro/kernels/stacked_relation_agg/kernel.py:336.
// That kernel walked a sequential grid (slot, node block, d_in chunk), kept
// the [bn, f, H] projections in VMEM scratch across the d_in chunks, picked
// the weight blocks through a scalar-prefetched slot->stack index and ran
// the epilogue on the last chunk.
//
// What bounds it on an H100: the fp32 projections.  At the serving blocks
// (rb, n, f, d_in, H = 2-3, 1024, 16, 128, 64) they are 0.5-1.6 GFLOP
// against 8-25 MB, past the ~20 FLOP per byte at which the fp32 CUDA cores
// (67 TFLOP/s) become the limit; at the R-GAT training leaf (6, 4096, 3,
// 128, 64) the bytes of h and of the z0 residual bind.  The first version
// ran at 15-19 % of its bound: each thread's 4 x 4 tile issued 8 scalar
// shared loads per 16 FMAs (12 per 32 with HGT's second product), h and the
// weights were staged by scalar loads with no copy in flight during the
// FMAs, and its softmax ran on one thread per (row, head), each walking f
// three times while the block's other threads waited.  In this version the
// projections alone run at 27-29 TFLOP/s (as kernel 5's); the epilogue's
// short, barrier-separated steps take the rest, about a quarter of the time
// at the serving blocks and a third at the training leaves (21 rows a
// block), spread over every step (measured by leaving one step out at a
// time), and not hidden behind the other block's product on the SM.
//
// Design:
//   * one block per (tile of destination rows, slot); a tile holds rows =
//     max(1, 16 * RM / f) whole rows and all their f neighbours, so the
//     softmax over f never crosses blocks.  The tile's rows*f (row,
//     neighbour) pairs are contiguous in h, so they are the A rows of a
//     product on the "nn" core of fp32_tile.cuh: 16 * RM pairs x 64 columns
//     a pass, each thread of a 128-thread group an RM x 8 register
//     micro-tile fed by 16-byte shared loads (RM = 4: 12 loads per 128
//     FMAs), h streamed through the two-stage cp.async ring, the next
//     32-deep chunk in flight while the current one is multiplied.  A row
//     wider than the tile is projected in several passes over its pairs;
//     H > 64 in several column passes;
//   * HGT runs its two projections as two groups of 128 threads over the
//     same A chunk, group 0 against we[ue], group 1 against wv[uv], each
//     staging its own weight slice: a block of 256 threads, two blocks an
//     SM (one block an SM, with 64- or 128-pair tiles, ran 14-35 % slower
//     at the serving blocks); R-GAT one group of 128 threads, four blocks
//     an SM (three leave the serving blocks 1.3 waves instead of one);
//   * the weight slice [d_in][64] is staged by cp.async as it lies in
//     memory, 32 rows at a time with the A chunk that needs them, so the
//     first product waits for one chunk of each and not the whole 32-64 KB
//     slice; it stays resident for the block's tile, and when the tile is
//     one pass the epilogue's buffers reuse the staging memory (82-88 KB a
//     block for HGT, 50-56 KB for R-GAT at d_in = 128, with the epilogue's
//     inputs);
//   * the epilogue's inputs (the tile's qv, eb and mask rows) are staged
//     by cp.async at the start, beside the staging memory, so that no step
//     of the epilogue waits on device memory behind its barriers;
//   * the accumulators go to shared memory (pitch H + 1, so the logits'
//     reads of 32 pairs hit distinct banks) and, with residual pointers,
//     straight to z0 / v0 in global memory (float4 stores where H % 4 == 0);
//   * the epilogue runs from shared memory on all of the block's threads,
//     its items counted by carries (Walk) rather than integer divisions:
//     HGT's pe[ua] and pv[ua] are copied into the freed staging memory
//     (pitch dh + 1) where they fit; per (row, column) the query q' =
//     pe . qv (HGT) or qv; per (row, head) a group of lanes (the smallest
//     power of two >= f, at most 32): on each lane the logits of its
//     neighbours, z0 . q' * scale (+ eb), leaky_relu, then the max over f
//     across the group (exact in any order), expf of each neighbour on its
//     own lane (masked: 0), the sum over f in neighbour order on the
//     group's first lane, the clamp at 1e-9 and the divide on every lane
//     (the reference's numerics: finfo.min fill, no --use_fast_math); per
//     (row, column) the combine sum_j a_j v0_j and, for HGT, one product
//     with pv, in the same pass where a warp holds whole heads.  HGT's [dh, dh]
//     transforms are applied once per row instead of once per neighbour
//     (z0.pe.qv = z0.(pe.qv), sum_j a_j (v0_j.pv) = (sum_j a_j v0_j).pv):
//     the same function, summed in another order;
//   * qv is read through a slot stride and a node stride: R-GAT passes its
//     per-slot a_src vector with node stride 0 (no [rb, n, H] copy), HGT
//     its materialized [rb, n, H] queries;
//   * ragged n, f, d_in and H are masked inside the kernel (the copies
//     zero-fill what lies outside): no padded copies of any operand.
// Two layouts: the tile, RM = 4 (64 pairs a pass), and, where that layout's
// shared memory does not fit (a row of f > 64 neighbours beside resident
// 128-deep weight slices at large f or H), the lean layout: one row a
// block, 16-pair passes, one 32-deep weight chunk at a time.  The entry
// point takes the tile wherever it fits unless the caller names a layout
// (the tuning table's launch parameter rm; choose).
// Limit (the first version's arithmetic, kept so that the fanouts it took
// stay the ones it takes): 4 * (f * (H * (1 + two) + nh) + H * (1 + post) +
// 64 * 33 + 32 * 64 * (1 + two)) bytes within 227 KB: f <= 392 for HGT and
// f <= 792 for R-GAT at H = 64, nh = 4.  The lean layout needs less there
// (and is refused with the limit where it would not, at H near 1000).  The
// wrapper raises a named error beyond the limit (attn_max_fanout in
// stacked_relation_agg/ops.py); the entry point refuses it too.
// Precision: full fp32 FMAs; each projection output summed over d_in in
// increasing order inside one thread (the first version's order, so z0 and
// v0 equal its outputs bit for bit), every sum of the epilogue in the first
// version's order too.  No TF32, no tensor cores (a 3xTF32 version of
// kernel 2 failed the card-vs-CPU 1e-5 after three Adam steps), no atomics:
// the result is the same bit for bit from run to run.

#include <float.h>

#include "fp32_tile.cuh"

namespace {

using namespace fp32_tile;

constexpr size_t kMaxSmem = 232448;  // opt-in shared memory of one block on sm_90
constexpr int kRM = 4;               // rows per thread of the tile: 64 pairs a pass

// The layout of a launch.  rm = 0: a row of this fanout does not fit.
struct Layout {
  int rm = 0;          // rows per thread of a product pass (16 * rm pairs)
  int kw = 0;          // depth of the weight slice in shared memory
  long long rows = 0;  // destination rows per block
  int zp = 0;          // pitch of the projections in shared memory
  bool alias = false;  // the epilogue's buffers reuse the staging memory
  size_t smem = 0;     // bytes
};

// floats of the staging memory: the weight slice(s) and the A ring
inline size_t stage_floats(int rm, int kw, int k) {
  return (size_t)k * kw * kBN + 2 * (size_t)16 * rm * kAP;
}

// floats of the epilogue's buffers: the projections, the logits, the
// queries and (pv) the combined rows
inline size_t epi_floats(long long rows, long long f, int H, int zp, int nh, int k,
                         bool post) {
  const size_t P = (size_t)(rows * f);
  return P * zp * k + P * nh + (size_t)rows * H * (post ? 2 : 1);
}

// floats of the epilogue's inputs, staged at the start: the tile's qv rows,
// eb rows and mask bytes (as words, one more for an unaligned start)
inline size_t in_floats(long long rows, long long f, int H, int nh) {
  return (size_t)(rows * H + rows * nh + (rows * f + 7) / 4);
}

// floats before the inputs: the staging memory and the epilogue's buffers,
// shared (alias) or one after the other, rounded to 16 bytes
__host__ __device__ inline size_t main_floats(size_t st, size_t ep, bool alias) {
  return ((alias ? (st > ep ? st : ep) : st + ep) + 3) / 4 * 4;
}

// the fanout limit (source note)
inline bool fanout_fits(long long f, int H, int nh, int k, bool post) {
  const double floats = (double)f * ((double)H * k + nh) + (double)H * (post ? 2 : 1) +
                        64.0 * 33 + 32.0 * 64 * k;
  return 4 * floats <= (double)kMaxSmem;
}

// The layout of a launch at `rm` rows per thread: 4 the 64-pair tile, 1
// the lean layout, 0 the shape's rule (the tile where its shared memory
// fits, else the lean layout); rm = 0 in the result: refused (a row of
// this fanout does not fit, the tile's shared memory does not fit, or rm
// is none of 0, 1 and 4).
Layout choose(long long f, long long d_in, int nh, int dh, bool two, bool post, int rm) {
  Layout L;
  if (rm != 0 && rm != 1 && rm != kRM) return L;
  const int H = nh * dh, k = two ? 2 : 1;
  // the lean layout: one row a block, 16-pair passes, one 32-deep weight
  // chunk at a time; within the limit wherever H + nh + f / 4 stay under
  // some 950 floats (its staging is 960 floats smaller than the limit's and
  // its buffers are the limit's per-row terms), refused with it otherwise
  const size_t lean = f < 1 ? 0 : sizeof(float) * (main_floats(stage_floats(1, kKC, k),
                                                               epi_floats(1, f, H, H, nh, k, post),
                                                               false) +
                                                   in_floats(1, f, H, nh));
  if (f < 1 || !fanout_fits(f, H, nh, k, post) || lean > kMaxSmem) return L;
  const long long rows = f >= 16 * kRM ? 1 : 16 * kRM / f;
  const int kw = slice_depth(d_in);
  const bool one = rows * f <= 16 * kRM && H <= kBN && d_in <= kw;
  const size_t st = stage_floats(kRM, kw, k), ep = epi_floats(rows, f, H, H + 1, nh, k, post);
  const size_t smem = sizeof(float) * (main_floats(st, ep, one) + in_floats(rows, f, H, nh));
  if (rm == kRM || (rm == 0 && smem <= kMaxSmem)) {
    if (smem > kMaxSmem) return L;
    L.rm = kRM, L.kw = kw, L.rows = rows, L.zp = H + 1, L.alias = one, L.smem = smem;
  } else {
    L.rm = 1, L.kw = kKC, L.rows = 1, L.zp = H, L.alias = false, L.smem = lean;
  }
  return L;
}

// The items (a, b, c) of an [A][B][C] grid that thread `first` takes when
// `step` threads deal out the flat index (a * B + b) * C + c in turn, found
// by carries instead of the two or three integer divisions an item (some 20
// instructions each) that a flat index needs: at 21 rows a block the
// epilogue's divisions cost more issue slots than its FMAs.
struct Walk {
  int a, b, c;
  int da, db, dc, B, C;
  __device__ Walk(int first, int step, int b_extent, int c_extent)
      : a(first / c_extent / b_extent), b(first / c_extent % b_extent), c(first % c_extent),
        da(step / c_extent / b_extent), db(step / c_extent % b_extent), dc(step % c_extent),
        B(b_extent), C(c_extent) {}
  __device__ void next() {
    c += dc;
    int k = c >= C;
    c -= k ? C : 0;
    b += db + k;
    k = b >= B;
    b -= k ? B : 0;
    a += da + k;
  }
};

template <bool kTwo, int RM>
__global__ void __launch_bounds__(kTwo ? 2 * kThreads : kThreads, RM == 1 ? 1 : kTwo ? 2 : 4)
stacked_attn_epilogue_kernel(
    const float* __restrict__ h, const uint8_t* __restrict__ mask,
    const float* __restrict__ qv, long long qv_ss, long long qv_ns,
    const float* __restrict__ eb, const float* __restrict__ we,
    const float* __restrict__ wv, const float* __restrict__ pe,
    const float* __restrict__ pv, const int* __restrict__ us,
    float* __restrict__ out, float* __restrict__ z0, float* __restrict__ v0,
    int rb, long long n, int f, int d_in, int nh, int dh, float scale, float slope,
    int has_slope, int rows, int kw, int zp, int alias) {
  constexpr int T = kTwo ? 2 * kThreads : kThreads;
  constexpr int BM = 16 * RM;
  constexpr int K = kTwo ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  const int H = nh * dh;
  const bool post = pe != nullptr;
  const int s = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrow = (int)min((long long)rows, n - row0);
  const int M = nrow * f;            // the tile's (row, neighbour) pairs
  const size_t P = (size_t)rows * f;  // their capacity
  const int tid = threadIdx.x;
  const int g = kTwo ? tid / kThreads : 0;  // product group: 0 -> z0, 1 -> v0
  float* w_s = smem;                         // [K][kw][kBN]
  float* a_s = w_s + K * kw * kBN;           // [2][BM][kAP]
  const long long pair0 = ((long long)s * n + row0) * f;
  const float* hb = h + pair0 * d_in;
  const bool vec_h = d_in % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const bool vec_w = H % 4 == 0 && reinterpret_cast<uintptr_t>(we) % 16 == 0 &&
                     (!kTwo || reinterpret_cast<uintptr_t>(wv) % 16 == 0);

  // 0. the epilogue's inputs (the tile's qv rows, eb rows and mask bytes)
  // into shared memory past the staging memory and the epilogue's buffers,
  // by cp.async in a group older than any chunk's, so that the epilogue
  // does not wait on device memory behind its barriers (it did: some 10 %
  // of the kernel's time)
  const size_t st = (size_t)K * kw * kBN + 2 * BM * kAP;
  const size_t ep = P * zp * K + P * nh + (size_t)rows * H * (post ? 2 : 1);
  float* qv_s = smem + main_floats(st, ep, alias);  // [rows or 1][H]
  float* eb_s = qv_s + (size_t)rows * H;            // [rows][nh]
  const uint8_t* mk_s;                              // the tile's mask bytes
  {
    const long long rowp = (long long)s * n + row0;
    const int nq = qv_ns == 0 ? 1 : nrow;  // a per-slot qv is one row
    const float* qg = qv + s * qv_ss + row0 * qv_ns;
    if (H % 4 == 0 && reinterpret_cast<uintptr_t>(qv) % 16 == 0 && qv_ss % 4 == 0 &&
        qv_ns % 4 == 0) {
      for (Walk w(tid, T, 1, H / 4); w.a < nq; w.next())
        cp_async16(qv_s + w.a * H + 4 * w.c, qg + w.a * qv_ns + 4 * w.c, true);
    } else {
      for (Walk w(tid, T, 1, H); w.a < nq; w.next())
        cp_async4(qv_s + w.a * H + w.c, qg + w.a * qv_ns + w.c, true);
    }
    if (eb != nullptr) {
      for (int e = tid; e < nrow * nh; e += T) cp_async4(eb_s + e, eb + rowp * nh + e, true);
    }
    // whole words from the one holding the first byte; the last word copies
    // only the bytes of the tile
    const uintptr_t first = reinterpret_cast<uintptr_t>(mask + rowp * f);
    const uintptr_t end = first + (uintptr_t)nrow * f, w0 = first & ~(uintptr_t)3;
    float* mw = eb_s + (size_t)rows * nh;
    for (uintptr_t a = w0 + 4 * (uintptr_t)tid; a < end; a += 4 * (uintptr_t)T) {
      const unsigned bytes = (unsigned)(end - a < 4 ? end - a : 4);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(smem_addr(mw + (a - w0) / 4)), "l"(a), "r"(bytes));
    }
    mk_s = reinterpret_cast<const uint8_t*>(mw) + (first - w0);
    cp_async_commit();
  }

  // 1. the projections of the tile's M pairs: 16 RM pairs x 64 columns a pass
  const int nk = max(1, (d_in + kKC - 1) / kKC);  // A chunks
  const int nkw = kw / kKC;                      // A chunks per weight slice
  // one slice holds every column and all of d_in: staged once for the tile
  const bool resident = H <= kBN && nk <= nkw;
  constexpr int kGroups = 2;  // cp.async groups of one chunk: its weight rows, its A rows
  // this group's weights: we[ue] (group 0) or, for HGT, wv[uv] (group 1);
  // each group stages its own slice
  const float* wg = kTwo && g == 1 ? wv + (long long)us[rb + s] * d_in * H
                                   : we + (long long)us[s] * d_in * H;
  // chunk q's 32 weight rows go to their place q % nkw in the group's slice;
  // with_w false: an empty group, so that the counts stay uniform
  auto stage_w = [&](int c0, int q, bool with_w) {
    if (with_w) {
      stage_w_nn<kThreads>(w_s + (g * kw + (q % nkw) * kKC) * kBN, wg, d_in, H, c0, q * kKC,
                           kKC, vec_w);
    } else {
      cp_async_commit();
    }
  };
  for (int p0 = 0; p0 < M; p0 += BM) {
    for (int c0 = 0; c0 < H; c0 += kBN) {
      // the weight rows stream in with the A chunks, so the first product
      // waits for one chunk of each, not the whole slice
      const bool with_w = !resident || p0 == 0;
      stage_w(c0, 0, with_w);
      stage_a<RM, T>(a_s, hb, M, p0, d_in, 0, 0, vec_h);
      float acc[RM][8] = {};  // [row i][32-column half hh * 4 + j]
      for (int q = 0; q < nk; ++q) {
        // one place in the slice (the lean layout): chunk q's rows go in
        // now that chunk q - 1's product has freed it (the closing barrier)
        if (nkw == 1 && q > 0) stage_w(c0, q, with_w);
        if (q + 1 < nk) {
          stage_w(c0, q + 1, with_w && nkw > 1);
          stage_a<RM, T>(a_s, hb, M, p0, d_in, (q + 1) * kKC, (q + 1) % 2, vec_h);
        } else {
          cp_async_commit();
          cp_async_commit();
        }
        cp_async_wait<kGroups>();  // all but chunk q + 1's groups
        __syncthreads();  // chunk q and its weight rows visible to all
        product_nn<RM>(acc, a_s + (q % 2) * BM * kAP, w_s + g * kw * kBN, (q % nkw) * kKC);
        __syncthreads();  // ring slot q % 2 (and one place of the slice) free again
      }
      // into shared memory (one pass: over the staging memory, which every
      // thread is done with) and, with residuals, straight to global memory
      float* zd = (alias ? smem : a_s + 2 * BM * kAP) + (size_t)g * P * zp;  // zs or vs
      float* zg = g == 0 ? z0 : v0;  // this group's residual, or null
      const bool vec_z =
          zg != nullptr && H % 4 == 0 && reinterpret_cast<uintptr_t>(zg) % 16 == 0;
      const int rbase = tile_row<RM>(), cbase = tile_col();
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = p0 + rbase + 4 * i;
        if (m >= M) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int c = c0 + cbase + 32 * hh;
          if (c >= H) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (c + j < H) zd[(size_t)m * zp + c + j] = acc[i][4 * hh + j];
          }
          if (zg == nullptr) continue;
          float* o = zg + (pair0 + m) * H + c;
          if (vec_z) {
            *reinterpret_cast<float4*>(o) = make_float4(
                acc[i][4 * hh], acc[i][4 * hh + 1], acc[i][4 * hh + 2], acc[i][4 * hh + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (c + j < H) o[j] = acc[i][4 * hh + j];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  float* zs = alias ? smem : a_s + 2 * BM * kAP;  // [P][zp]
  float* vs = zs + (kTwo ? P * zp : 0);      // [P][zp] (HGT)
  float* es = zs + P * zp * K;               // [P][nh]
  float* qs = es + P * nh;                   // [rows][H]
  float* os = qs + (size_t)rows * H;         // [rows][H] (pv)
  const int ua = us[2 * rb + s];

  // 2. HGT's transforms pe[ua] and pv[ua] into the staging memory the
  // projections are done with, rows at pitch dh + 1 (a warp's lanes read 32
  // rows of pe at one column: distinct banks), where they fit; else they are
  // read from global memory.  Then per row and column the query the logits
  // contract with: pe . qv (HGT) or qv.
  const float* pe_t = post ? pe + (long long)ua * nh * dh * dh : nullptr;
  const float* pv_t = post ? pv + (long long)ua * nh * dh * dh : nullptr;
  int tp = dh;  // row pitch of the transforms
  {
    const size_t free0 = alias ? ep : 0;
    const size_t tf = (size_t)nh * dh * (dh + 1);
    if (post && free0 + 2 * tf <= st) {
      float* ps = smem + free0;
      for (Walk w(tid, T, 1, dh); w.a < nh * dh; w.next()) {
        const int e = w.a * dh + w.c;
        ps[w.a * (dh + 1) + w.c] = pe_t[e];
        ps[tf + w.a * (dh + 1) + w.c] = pv_t[e];
      }
      pe_t = ps, pv_t = ps + tf, tp = dh + 1;
      __syncthreads();
    }
  }
  for (Walk w(tid, T, nh, dh); w.a < nrow; w.next()) {  // (row, head, d)
    const int r = w.a, hd = w.b, d = w.c, c = hd * dh + d;
    const float* q = qv_s + (qv_ns == 0 ? 0 : r * H);
    float x;
    if (post) {
      const float* pr = pe_t + (hd * dh + d) * tp;
      const float* qh = q + hd * dh;
      x = 0.f;
#pragma unroll 8
      for (int t = 0; t < dh; ++t) x = fmaf(pr[t], qh[t], x);
    } else {
      x = q[c];
    }
    qs[r * H + c] = x;
  }
  __syncthreads();

  // 3. per (row, head) a group of G lanes, the smallest power of two >= f
  // (at most a warp): each lane the logits of its neighbours j, z0_j . q'
  // * scale (+ eb), leaky_relu; then the masked softmax over f across the
  // group with G-wide shuffles
  const int G = f > 16 ? 32 : f > 8 ? 16 : f > 4 ? 8 : f > 2 ? 4 : f;
  const int lane = tid % 32, gl = lane % G;
  const int items = nrow * nh;
  for (int it0 = tid / 32 * (32 / G); it0 < items; it0 += T / G) {
    const int it = it0 + lane / G;  // this group's (row, head); past the end: idle
    const bool live = it < items;
    const int r = live ? it / nh : 0, hd = live ? it % nh : 0;
    const uint8_t* mk = mk_s + r * f;
    const float* qr = qs + (size_t)r * H + hd * dh;
    float* er = es + (size_t)r * f * nh + hd;
    for (int j = gl; live && j < f; j += G) {
      const float* z = zs + (size_t)(r * f + j) * zp + hd * dh;
      float x = 0.f;
#pragma unroll 8
      for (int d = 0; d < dh; ++d) x = fmaf(z[d], qr[d], x);
      x *= scale;
      if (eb != nullptr) x += eb_s[r * nh + hd];
      if (has_slope) x = x >= 0.f ? x : slope * x;
      er[j * nh] = x;
    }
    float mx = -FLT_MAX;
    for (int j = gl; live && j < f; j += G) mx = fmaxf(mx, mk[j] ? er[j * nh] : -FLT_MAX);
    for (int o = G / 2; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o, G));
    for (int j = gl; live && j < f; j += G) er[j * nh] = mk[j] ? expf(er[j * nh] - mx) : 0.f;
    __syncwarp();
    float sum = 0.f;
    if (live && gl == 0) {
      for (int j = 0; j < f; ++j) sum += er[j * nh];
    }
    const float den = fmaxf(__shfl_sync(0xffffffffu, sum, 0, G), 1e-9f);
    for (int j = gl; live && j < f; j += G) er[j * nh] = er[j * nh] / den;
  }
  __syncthreads();

  // 4. per (row, column) the combine sum_j a_j v0_j, then (HGT) the values
  // transform.  The flat (row, head, d) index runs over consecutive lanes, so
  // when dh divides 32 a warp holds whole heads and the transform needs only
  // the warp's own combine (__syncwarp; every lane of a warp takes the same
  // number of turns); else a block barrier and a second pass.
  const float* V = kTwo ? vs : zs;
  const bool warp_heads = post && 32 % dh == 0;
  auto transform = [&](int r, int hd, int t) {
    const float* o = os + (size_t)r * H + hd * dh;
    const float* pc = pv_t + hd * dh * tp + t;
    float x = 0.f;
#pragma unroll 8
    for (int d = 0; d < dh; ++d) x = fmaf(o[d], pc[d * tp], x);
    out[((long long)s * n + row0 + r) * H + hd * dh + t] = x;
  };
  for (Walk w(tid, T, nh, dh); __any_sync(0xffffffffu, w.a < nrow); w.next()) {
    const bool in = w.a < nrow;  // (row, head, d)
    const int r = w.a, hd = w.b, c = hd * dh + w.c;
    if (in) {
      float x = 0.f;
#pragma unroll 4
      for (int j = 0; j < f; ++j) {
        const size_t m = (size_t)r * f + j;
        x = fmaf(es[m * nh + hd], V[m * zp + c], x);
      }
      if (post) {
        os[r * H + c] = x;
      } else {
        out[((long long)s * n + row0 + r) * H + c] = x;
      }
    }
    if (warp_heads) {
      __syncwarp();
      if (in) transform(r, hd, w.c);
    }
  }
  if (post && !warp_heads) {
    __syncthreads();
    for (Walk w(tid, T, nh, dh); w.a < nrow; w.next()) transform(w.a, w.b, w.c);
  }
}

template <bool kTwo, int RM>
int launch(const Layout& L, dim3 grid, cudaStream_t stream, const float* h,
           const uint8_t* mask, const float* qv, long long qv_ss, long long qv_ns,
           const float* eb, const float* we, const float* wv, const float* pe, const float* pv,
           const int* us, float* out, float* z0, float* v0, int rb, long long n, int f,
           int d_in, int nh, int dh, float scale, float slope, int has_slope) {
  cudaError_t err = cudaFuncSetAttribute(stacked_attn_epilogue_kernel<kTwo, RM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.smem);
  if (err != cudaSuccess) return (int)err;
  stacked_attn_epilogue_kernel<kTwo, RM>
      <<<grid, kTwo ? 2 * kThreads : kThreads, L.smem, stream>>>(
          h, mask, qv, qv_ss, qv_ns, eb, we, wv, pe, pv, us, out, z0, v0, rb, n, f, d_in,
          nh, dh, scale, slope, has_slope, (int)L.rows, L.kw, L.zp, (int)L.alias);
  return (int)cudaGetLastError();
}

}  // namespace

// Destination rows per block of a launch at this fanout, d_in, head shape
// and rm (0: the shape's rule; see choose), or 0 when it is refused; the
// tests read the layout here.
extern "C" long long stacked_attn_epilogue_rows(long long f, long long d_in, int nh, int dh,
                                                int two, int post, int rm) {
  if (d_in < 1 || nh < 1 || dh < 1) return 0;
  return choose(f, d_in, nh, dh, two != 0, post != 0, rm).rows;
}

// The rows per thread (4: the 64-pair tile, 1: the lean layout) of a launch
// at this shape and rm, or 0 when it is refused: what the wrapper records
// beside each launch's shape.
extern "C" int stacked_attn_epilogue_rm(long long f, long long d_in, int nh, int dh, int two,
                                        int post, int rm) {
  if (d_in < 1 || nh < 1 || dh < 1) return 0;
  return choose(f, d_in, nh, dh, two != 0, post != 0, rm).rm;
}

// Launches on `stream` in the layout of `rm` (0: the shape's rule; 4 or 1:
// the tile or the lean layout, the launch parameter the tuning table sets);
// returns cudaGetLastError() (0 = launched; cudaErrorInvalidValue for a
// layout this shape cannot take).  wv null
// shares z0 as the values (R-GAT); pe and pv are both null or both given;
// eb, z0 and v0 may be null (v0 is written only with wv).  The caller
// guarantees shapes, contiguity of every operand but qv (read through
// qv_ss / qv_ns) and 0 <= us[k][s] < the rows of the stack it indexes.
extern "C" int stacked_attn_epilogue(
    const float* h, const uint8_t* mask, const float* qv, long long qv_ss,
    long long qv_ns, const float* eb, const float* we, const float* wv,
    const float* pe, const float* pv, const int* us, float* out, float* z0, float* v0,
    long long rb, long long n, long long f, long long d_in, int nh, int dh,
    float scale, float slope, int has_slope, int rm, void* stream) {
  const bool two = wv != nullptr, post = pe != nullptr;
  if (rb < 1 || rb > 65535 || n < 1 || f < 1 || d_in < 1 || d_in > 0x7fffffffLL || nh < 1 ||
      dh < 1 || (long long)nh * dh > 0x7fffffffLL / 4 || (pe == nullptr) != (pv == nullptr) ||
      (two && z0 != nullptr && v0 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = choose(f, d_in, nh, dh, two, post, rm);
  if (L.rm == 0 || (n + L.rows - 1) / L.rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n + L.rows - 1) / L.rows), (unsigned)rb);
  cudaStream_t st = (cudaStream_t)stream;
  if (two) {
    auto fn = L.rm == kRM ? launch<true, kRM> : launch<true, 1>;
    return fn(L, grid, st, h, mask, qv, qv_ss, qv_ns, eb, we, wv, pe, pv, us, out, z0, v0,
              (int)rb, n, (int)f, (int)d_in, nh, dh, scale, slope, has_slope);
  }
  auto fn = L.rm == kRM ? launch<false, kRM> : launch<false, 1>;
  return fn(L, grid, st, h, mask, qv, qv_ss, qv_ns, eb, we, nullptr, pe, pv, us, out, z0,
            nullptr, (int)rb, n, (int)f, (int)d_in, nh, dh, scale, slope, has_slope);
}
