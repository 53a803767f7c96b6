// The grid kNN's candidate scoring and canonical selection, fused: for each
// query, the squared distances to the candidates of its grid rows, the k
// nearest in the canonical ascending (distance², point index) order, their
// point indices and their slots.  No distance is written to memory.
//
// Replaces the XLA programs the JAX package fuses around its selection
// (each fenced by an `optimization_barrier` before `top_k`):
//   * `_dilated_select` (the JAX package's ops/knn.py:593): the
//     dilated entry.  With sorted rows (each row's candidates ascending by
//     index, the single-device layout) the k smallest by (sq, slot) are the
//     canonical order already; with unsorted rows (a shard's) the k + 8
//     smallest by (sq, slot) are re-sorted by (sq, idx) and the first k
//     kept, as `_topk_canonical` (:341) does.
//   * `_grid_query_kernel` (:360: `_grid_candidates` :317 + `_topk_canonical`)
//     and the ring's `do_ring` (engine/tree.py:1124-1163, radius 4): the
//     blocked entry, over the (2r+1)^d slabs [C, d] of a query's
//     neighbourhood cells, kk = min(k + 8, R*C) by (sq, slot), slots in
//     neighbour-offset order then member order, re-sorted by (sq, idx).
//
// Bit for bit the port's plain chain (ops/grid_select.py):
//   * delta = q - p with __fsub_rn; sq = d0*d0 with __fmul_rn, then for
//     every later axis sq = f32(f64(da)*f64(da) + f64(sq)) through
//     __dmul_rn / __dadd_rn / __double2float_rn: the port's `_fma`, which
//     emulates the fused multiply-add of XLA's CPU backend through f64.
//     `fmaf` rounds once and differs from that in about 2^-29 of cases.
//     (The product of two f32 is exact in f64, so a contraction of the
//     dmul and dadd into one DFMA would give the same bits.)
//   * ties at equal (sq, idx) go to the lower slot: pad slots share the pad
//     index, and the plain chain's two stable sorts keep their slot order.
//   * the selection kernel's caveat: a +inf distance is selected as slot 0.
//   * pad slots hold coordinates clamped to 1e15, so their distances are
//     finite (about 1e30 to 3e30) and rank as in the plain chain.
//   * a row the optional mask (blocked entry) leaves out is written as the
//     filler (+inf, index 0, slot 0) and costs one byte's read.
//
// What bounds it: the candidates' coordinates are read once (Q*W*d*4 bytes
// at most; neighbouring queries share cells, so fewer distinct bytes), and
// k (sq, idx, sel) triples are written; the f64 additions (d - 1 of them a
// candidate, with their conversions) are the operations.  The ring pass of
// the 3D workloads, [1024, 729*32] candidates, reads at most 287 MB, 0.086
// ms at 3.35 TB/s; the epoch's dilated [65536, 384] 302 MB, 0.090 ms.  The
// bytes mostly come from L2 (a call's distinct slabs are a few MB).  What
// held both first designs back was the warp queue (grid_select_compare.py
// --ablate on an H100; PERF.md): without it the blocked ring pass took
// 0.058 of 0.107 ms, with or without the coordinate loads, and without the
// f64 chain 0.014 ms less; the dilated rows, whose queue started blind and
// took 128 keys before its first threshold, took 0.097 of 0.220 ms
// ([65536, 384] k=26), 0.036 of 0.113 ([50263, 192] k=8) and 0.265 of
// 0.607 (a shard's [71040, 864] k=26 + 8), the f64 chain at most 0.06 ms
// of any, rows a block and the rows' order (1.1-1.5 queries in a run of
// one row) next to nothing.
//
// What the design does about it:
//   * Each lane takes groups of four consecutive candidates (4*d floats,
//     16-byte aligned), d 16-byte vector loads a group, four groups in
//     flight, and computes their four distances in registers (csrc/
//     topk_smallest.cu uses the same queue, warp_select.cuh).
//   * The dilated entry scores a row in f32 first and bounds its kk-th
//     distance from each lane's nearest (refined by counting where a
//     shard's pads leave that loose), so that only the candidates under the
//     bound, about kk of them, take the f64 chain and the queue, 32 at a
//     time and one a lane: about one merge a row instead of four to six,
//     one f64 pass instead of twelve (the section below).  Dilated rows
//     (<= 2048 candidates) take one warp a row, four rows a block; wider
//     rows one block of up to 8 warps a row, each warp over a strided range
//     of groups, the warps' queues merged pairwise in shared memory.
//   * The blocked entry scans a row's slabs nearest first (kSlabOrder: the
//     offsets sorted by length), so the queue's threshold falls within the
//     first slabs and later groups are rarely offered; the slots keep their
//     neighbour-offset numbering, and the kk smallest (sq, slot) keys are
//     one set whatever the order.  A group whose f32 FMA distances all lie
//     above the threshold by more than their rounding (skip_above) skips
//     the f64 chain, and a group whose four distances all lie above the
//     queue's threshold costs four compares and one vote.  A block takes a
//     chunk of 1-8 consecutive rows, 8-1 warps a row, and first reads each
//     row's cell ids, in scan order, into shared memory; rows of the chunk
//     then read their slabs in the same order at about the same pace, so a
//     run of rows with one neighbourhood finds in L1 what its first row
//     brought (on the main path such runs are short: 1.03 rows on grid3d's
//     ring).  Staging a run's slabs in shared memory with cp.async was
//     built and measured slower: each tile's copy latency held the run's
//     warps at a barrier (PERF.md).
//   * A blocked group never straddles two slabs (C is a power of two, at
//     least 4): its slab's cell id is one shared read.
//   * The re-sort by (sq, idx, slot) is a bitonic network over the kk keys
//     in the warp's registers and shuffles.
//
// Limits: d in {2, 3}; 1 <= k <= kk <= min(W, 256); W a multiple of 4 (the
// dilated width) or C a power of two of at least 4 (the blocked slabs);
// 16-byte aligned coordinates.
#include <cuda_runtime.h>

#include "warp_select.cuh"

namespace {

constexpr int kUnroll = 4;  // groups of four candidates in flight a lane

// float j of a group's 4*D coordinates, loaded as D float4 (j known at
// compile time once the loops are unrolled, so no local memory)
template <int D>
__device__ __forceinline__ float coord(const float4 (&v)[D], int j) {
  const float4 w = v[j / 4];
  switch (j % 4) {
    case 0: return w.x;
    case 1: return w.y;
    case 2: return w.z;
    default: return w.w;
  }
}

// sq of the candidate at c, rounded as the port's `_sqsum`
template <int D>
__device__ __forceinline__ float exact_sq(const float (&qv)[D],
                                          const float (&c)[D]) {
  const float d0 = __fsub_rn(qv[0], c[0]);
  float out = __fmul_rn(d0, d0);
#pragma unroll
  for (int a = 1; a < D; ++a) {
    const double da = (double)__fsub_rn(qv[a], c[a]);
    out = __double2float_rn(__dadd_rn(__dmul_rn(da, da), (double)out));
  }
  return out;
}

// sq of candidate t of a group
template <int D>
__device__ __forceinline__ float sq_distance(const float (&qv)[D],
                                             const float4 (&v)[D], int t) {
  float c[D];
#pragma unroll
  for (int a = 0; a < D; ++a) c[a] = coord<D>(v, t * D + a);
  return exact_sq<D>(qv, c);
}

// sq of candidate t of a group in f32 fused multiply-adds.  Both this and
// sq_distance round a sum of the same non-negative terms three times (the
// f64 sum's rounding adds 2^-53), so sq_distance is at least this times
// (1 - 6.01 * 2^-24), less 3 * 2^-150 where the sums underflow, and at
// most this times (1 + 6.01 * 2^-24), plus 7 * 2^-150.
template <int D>
__device__ __forceinline__ float approx_sq(const float (&qv)[D],
                                           const float4 (&v)[D], int t) {
  const float d0 = __fsub_rn(qv[0], coord<D>(v, t * D));
  float out = __fmul_rn(d0, d0);
#pragma unroll
  for (int a = 1; a < D; ++a) {
    const float da = __fsub_rn(qv[a], coord<D>(v, t * D + a));
    out = __fmaf_rn(da, da, out);
  }
  return out;
}

// An approx_sq above this puts sq_distance above th: th(1 + 2^-20) +
// 2^-126 by the bound of approx_sq; +inf (skip nothing) while th is +inf,
// NaN or above 1e38, near the end of the f32 range, where an approx_sq
// that overflows would not bound sq_distance.  By the other half of the
// bound, an approx_sq of x puts sq_distance at or below skip_above(x).
__device__ __forceinline__ float skip_above(float th) {
  return th < 1e38f ? __fmaf_rn(th, 1.0f + 0x1p-20f, 0x1p-126f)
                    : __uint_as_float(0x7f800000u);
}

__device__ __forceinline__ bool pair_less(u64 a, unsigned as, u64 b,
                                          unsigned bs) {
  return a < b || (a == b && as < bs);
}

// Ascending bitonic sort of 32*Q (key, slot) pairs, element r*32 + lane in
// (key[r], slot[r]), by key, then slot.
template <int Q>
__device__ __forceinline__ void sort_pairs(u64 (&key)[Q], unsigned (&slot)[Q],
                                           int lane) {
#pragma unroll
  for (int size = 2; size <= kWarp * Q; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      if (stride >= kWarp) {  // partners in two registers of one lane
        const int rs = stride / kWarp;
#pragma unroll
        for (int r = 0; r < Q; ++r) {
          if ((r & rs) == 0) {
            const bool up = ((r * kWarp) & size) == 0;
            const u64 a = key[r], b = key[r + rs];
            const unsigned sa = slot[r], sb = slot[r + rs];
            if (up ? pair_less(b, sb, a, sa) : pair_less(a, sa, b, sb)) {
              key[r] = b;
              key[r + rs] = a;
              slot[r] = sb;
              slot[r + rs] = sa;
            }
          }
        }
      } else {  // partners in two lanes
#pragma unroll
        for (int r = 0; r < Q; ++r) {
          const bool up = ((r * kWarp + lane) & size) == 0;
          const bool low = (lane & stride) == 0;
          const u64 ok = __shfl_xor_sync(kFull, key[r], stride);
          const unsigned os = __shfl_xor_sync(kFull, slot[r], stride);
          const bool other_first = pair_less(ok, os, key[r], slot[r]);
          if (low == up ? other_first : !other_first) {
            key[r] = ok;
            slot[r] = os;
          }
        }
      }
    }
  }
}

// ---- The dilated entry ---------------------------------------------------
//
// One warp a row (four rows a block), or for rows wider than
// kNarrowMaxWidth a block of warps a row, each over a strided range of
// groups, their queues merged pairwise.  A warp takes its groups in
// segments of kUnroll groups a lane (512 candidates; the epoch's rows are
// one segment, a shard's 864 two), each read once:
//   1. Score the segment in f32 FMAs (approx_sq), into registers, and keep
//      each lane's seed_best smallest over the segments so far.  The kk-th
//      smallest T of the warp's lane bests is at least the kk-th smallest
//      approx_sq of its candidates (they are a subset), so kk candidates
//      have approx_sq <= T and thus sq <= skip_above(T): the kk-th
//      smallest sq is at most skip_above(T), and at most the queue's
//      threshold, the exact kk-th of the keys merged so far.
//   2. Where that keeps more than two batches (lanes of pads only leave T
//      loose), bisect T's bits down while the segment still has kk
//      approx_sq at or below it (refine_bound): the same argument holds.
//   3. A candidate whose approx_sq lies above skip_above of the bound has
//      its sq above the bound, so it is none of the kk smallest (sq, slot)
//      keys.  The others' slots are compacted in shared memory and, 32 at
//      a time, each lane takes one, reads its coordinates again (from L1
//      or L2: the row was just read), computes its sq in the f64 chain and
//      merges the key into the warp queue.  The kk smallest keys of the
//      candidates kept are those of the whole row, whatever order or
//      subset the bounds come from.
// A row with fewer than kk real candidates keeps every candidate up to
// the pads' (about 1e30, all tied): correct, at about the first design's
// cost.  A NaN or +inf bound keeps every candidate.

// lane bests that seed the bound: one where k is small against the 32
// lanes (the port's 2D selection takes 8), two in 3D (26)
template <int D>
__device__ constexpr int seed_best() {
  return D == 2 ? 1 : 2;
}
// blocks of 256 threads a multiprocessor the registers are bounded for:
// 64 registers a thread (measured faster than the 80 ptxas takes unbounded)
constexpr int kDilatedMinBlocks = 4;
// kept candidates above which a segment's bound is refined (two batches),
// and the most counts the refinement takes
constexpr int kRefineAbove = 2 * kWarp;
constexpr int kRefineSteps = 12;
// slots a warp holds compacted at most: fewer than 32 left over, plus one
// segment's (kUnroll groups of four a lane)
constexpr int kPendSlots = kWarp + kUnroll * 4 * kWarp;

// shared memory of one warp, in keys: its compacted slots, which the
// pairwise merge of a wide row then reuses for the warp's sorted queue
__host__ __device__ constexpr int dilated_slots(int q) {
  return kPendSlots / 2 > kWarp * q ? kPendSlots / 2 : kWarp * q;
}

struct DilatedArgs {
  const float* queries;        // [q, d]
  const float* pts;            // [rows, W*d]
  const int* cand;             // [rows, W]
  const long long* flat;       // [q]
  float* sq;                   // [q, k]
  long long* idx;              // [q, k]
  int* sel;                    // [q, k]
  int q, width, k, kk, wpr;
  bool canonical;              // re-sort the kk by (sq, idx, slot)
};

// ascending bitonic sort of one value a lane across the warp
__device__ __forceinline__ unsigned sort32(unsigned c, int lane) {
#pragma unroll
  for (int size = 2; size <= kWarp; size <<= 1) {
    const bool up = (lane & size) == 0;
#pragma unroll
    for (int s = size >> 1; s > 0; s >>= 1) {
      const unsigned o = __shfl_xor_sync(kFull, c, s);
      c = (((lane & s) == 0) == up) ? min(c, o) : max(c, o);
    }
  }
  return c;
}

// ascending merge of a bitonic sequence of one value a lane
__device__ __forceinline__ unsigned merge32(unsigned c, int lane) {
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1) {
    const unsigned o = __shfl_xor_sync(kFull, c, s);
    c = (lane & s) == 0 ? min(c, o) : max(c, o);
  }
  return c;
}

// The kk-th smallest of the lanes' P bests b0 (and b1), approx_sq bits
// (non-negative floats order as unsigned; ~0u, a NaN, for none); ~0u
// where kk exceeds them.
template <int P>
__device__ __forceinline__ unsigned seed_threshold(unsigned b0, unsigned b1,
                                                   int kk, int lane) {
  if (kk > P * kWarp) return ~0u;
  b0 = sort32(b0, lane);
  if (P == 1) return __shfl_sync(kFull, b0, kk - 1);
  // b0 ascending against b1 descending: the elementwise min holds the 32
  // smallest of both and the max the 32 largest, each a bitonic run
  const unsigned r = __shfl_sync(kFull, sort32(b1, lane), kWarp - 1 - lane);
  return kk <= kWarp ? __shfl_sync(kFull, merge32(min(b0, r), lane), kk - 1)
                     : __shfl_sync(kFull, merge32(max(b0, r), lane),
                                   kk - 1 - kWarp);
}

// approx_sq of this lane's kUnroll groups of the segment at s (groups s +
// u*stride + lane), kUnroll groups' loads in flight
template <int D>
__device__ __forceinline__ void score_segment(float (&sq)[kUnroll][4],
                                              const float* base,
                                              const float (&qv)[D], int s,
                                              int stride, int groups,
                                              int lane) {
  float4 v[kUnroll][D];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = s + u * stride + lane;
    if (i < groups) {
      const float4* p = reinterpret_cast<const float4*>(base + i * 4 * D);
#pragma unroll
      for (int a = 0; a < D; ++a) v[u][a] = __ldg(p + a);
    } else {
#pragma unroll
      for (int a = 0; a < D; ++a) v[u][a] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      sq[u][t] = s + u * stride < groups ? approx_sq<D>(qv, v[u], t) : 0.f;
}

// Candidates of the warp's segment (score_segment's) whose approx_sq is at
// or below t (NaN counted, as the filter keeps it).
__device__ __forceinline__ int count_at_most(const float (&sq)[kUnroll][4],
                                             float t, int s, int stride,
                                             int groups, int lane) {
  unsigned c = 0;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool ok = s + u * stride + lane < groups;
#pragma unroll
    for (int j = 0; j < 4; ++j) c += ok && !(sq[u][j] > t);
  }
  return (int)__reduce_add_sync(kFull, c);
}

// A lower bound than `hi` for the kk-th smallest approx_sq of the row,
// where the segment alone has kk candidates at or below hi (else hi): a
// bisection of the values' bits between 0 and hi, at most kRefineSteps
// counts, kept at a value with kk or more candidates at or below it and
// stopped once they are at most kRefineAbove.
__device__ __forceinline__ unsigned refine_bound(
    const float (&sq)[kUnroll][4], unsigned hi, int kk, int s, int stride,
    int groups, int lane) {
  hi = min(hi, 0x7f800000u);  // a NaN bound as +inf
  if (count_at_most(sq, __uint_as_float(hi), s, stride, groups, lane) < kk)
    return hi;
  unsigned lo = 0u;
  for (int step = 0; step < kRefineSteps && hi - lo > 1u; ++step) {
    const unsigned mid = lo + (hi - lo) / 2u;
    const int c =
        count_at_most(sq, __uint_as_float(mid), s, stride, groups, lane);
    if (c < kk) {
      lo = mid;
    } else {
      hi = mid;
      if (c <= kRefineAbove) break;
    }
  }
  return hi;
}

// The f64 chain of n (<= 32) compacted slots, one a lane, and their keys
// merged into the queue; the first merge of a warp (`fresh`) sorts them
// into the empty queue.
template <int Q, int D>
__device__ __forceinline__ void score_pending(WarpSelect<Q>& ws, bool& fresh,
                                              const unsigned* pend, int n,
                                              const float* base,
                                              const float (&qv)[D],
                                              int lane) {
  __syncwarp();
  const bool has = lane < n;
  const unsigned slot = has ? pend[lane] : 0u;
  __syncwarp();
  float c[D];
#pragma unroll
  for (int a = 0; a < D; ++a)
    c[a] = has ? __ldg(base + (size_t)slot * D + a) : 0.f;
  const u64 key = make_key(exact_sq<D>(qv, c), slot);
  const bool take = has && key < ws.thresh;
  if (fresh) {
    ws.q[0] = warp_sort32(take ? key : kEmpty, lane);
    ws.update_thresh();
    fresh = false;
  } else if (__any_sync(kFull, take)) {
    ws.merge(take ? key : kEmpty);
  }
}

// This warp's kk smallest (sq, slot) keys of its groups of one row (warp
// wr of wpr takes groups wr*32 + lane, (wr + wpr)*32 + lane, ...), one
// segment (kUnroll groups a lane) at a time: its approx_sq in registers,
// the lane bests, the bound of the kk-th sq (the seed's over the
// candidates scored so far, or the queue's threshold, the lower), then
// the slots kept compacted in `pend` (the warp's kPendSlots slots of
// shared memory) and scored 32 at a time.  Without `seed` (a shard's
// rows, whose slabs each end in pads: with C = 32 the lanes that hold a
// slab's last groups hold pads only, so the lane bests are mostly pads)
// the bound comes from the counts alone.
template <int Q, int D>
__device__ __forceinline__ void select_dilated(WarpSelect<Q>& ws,
                                               unsigned* pend,
                                               const float* base,
                                               const float (&qv)[D],
                                               int groups, int wr, int wpr,
                                               bool seed, int lane) {
  constexpr int P = seed_best<D>();
  const int stride = kWarp * wpr;
  const int step = kUnroll * stride;
  unsigned b0 = ~0u, b1 = ~0u;  // this lane's P smallest approx_sq bits
  int n = 0;
  bool fresh = true;
  for (int s = wr * kWarp; s < groups; s += step) {
    float sq[kUnroll][4];
    score_segment<D>(sq, base, qv, s, stride, groups, lane);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const unsigned x =
            s + u * stride + lane < groups ? __float_as_uint(sq[u][t]) : ~0u;
        if (P == 2) b1 = min(b1, max(b0, x));
        b0 = min(b0, x);
      }
    unsigned bound = seed ? seed_threshold<P>(b0, b1, ws.k, lane) : ~0u;
    const float queue_lim = skip_above(ws.thresh_value);
    float lim =
        fminf(skip_above(skip_above(__uint_as_float(bound))), queue_lim);
    if (count_at_most(sq, lim, s, stride, groups, lane) > kRefineAbove) {
      // lanes of pads only (a row short of real candidates) leave the
      // seed loose
      bound = refine_bound(sq, bound, ws.k, s, stride, groups, lane);
      lim = fminf(skip_above(skip_above(__uint_as_float(bound))), queue_lim);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s + u * stride >= groups) break;  // the same for the whole warp
      const int i = s + u * stride + lane;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool keep = i < groups && !(sq[u][t] > lim);
        const unsigned m = __ballot_sync(kFull, keep);
        if (keep) pend[n + __popc(m & ((1u << lane) - 1u))] = 4u * i + t;
        n += __popc(m);
      }
    }
    while (n >= kWarp) {
      n -= kWarp;
      score_pending<Q, D>(ws, fresh, pend + n, kWarp, base, qv, lane);
    }
  }
  if (n > 0) score_pending<Q, D>(ws, fresh, pend, n, base, qv, lane);
}

template <int Q, int D>
__global__ void __launch_bounds__(kMaxWarpsPerRow * kWarp, kDilatedMinBlocks)
grid_select_dilated_kernel(const DilatedArgs a) {
  constexpr int kSlots = dilated_slots(Q);
  extern __shared__ u64 smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int rows_per_block = blockDim.x / (kWarp * a.wpr);
  const int wr = warp % a.wpr;
  const long long row = (long long)blockIdx.x * rows_per_block + warp / a.wpr;
  // only narrow blocks (wpr == 1) hold rows past the end, and they never
  // reach a block barrier
  if (row >= a.q) return;

  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qv[d] = __ldg(a.queries + row * D + d);
  const long long f = __ldg(a.flat + row);
  const float* base = a.pts + f * a.width * D;
  const int* cand = a.cand + f * a.width;
  u64* mine = smem + (size_t)warp * kSlots;
  WarpSelect<Q> ws;
  ws.init(mine, lane, a.kk);
  select_dilated<Q, D>(ws, reinterpret_cast<unsigned*>(mine), base, qv,
                       a.width / 4, wr, a.wpr, !a.canonical, lane);
  if (a.wpr > 1) {
    __syncwarp();
    merge_row_queues<Q>(ws, mine, kSlots, wr, a.wpr);
  }
  if (wr != 0) return;

  // the kk selected by (sq, slot); a +inf distance takes slot 0 (the
  // selection kernel's caveat)
  float* out_sq = a.sq + row * a.k;
  long long* out_idx = a.idx + row * a.k;
  int* out_sel = a.sel + row * a.k;
  u64 key[Q];
  unsigned slot[Q];
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    unsigned ord = (unsigned)(ws.q[r] >> 32);
    unsigned s = (unsigned)ws.q[r];
    if (ord >= kInfOrd) {
      ord = kInfOrd;
      s = 0;
    }
    key[r] = (u64)ord << 32;
    slot[r] = s;
  }
  if (a.canonical) {
    // (sq, idx) keys, slots beside them; the queue's places past kk last
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      if (r * kWarp + lane < a.kk) {
        key[r] |= (unsigned)__ldg(cand + slot[r]);
      } else {
        key[r] = kEmpty;
        slot[r] = ~0u;
      }
    }
    sort_pairs<Q>(key, slot, lane);
  }
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    const int j = r * kWarp + lane;
    if (j < a.k) {
      out_sq[j] = key_value(key[r]);
      out_sel[j] = (int)slot[r];
      out_idx[j] = a.canonical ? (long long)(unsigned)key[r]
                               : (long long)__ldg(cand + slot[r]);
    }
  }
}

template <int Q, int D>
cudaError_t launch_dilated(DilatedArgs a, cudaStream_t stream) {
  a.wpr = warps_per_row(a.width);
  const int threads =
      a.wpr == 1 ? kNarrowRowsPerBlock * kWarp : a.wpr * kWarp;
  const int rows_per_block = threads / (kWarp * a.wpr);
  const unsigned blocks =
      (unsigned)((a.q + (long long)rows_per_block - 1) / rows_per_block);
  const size_t smem = (size_t)(threads / kWarp) * dilated_slots(Q) *
                      sizeof(u64);
  grid_select_dilated_kernel<Q, D><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dilated_q(const DilatedArgs& a, cudaStream_t stream) {
  if (a.kk <= 32) return launch_dilated<1, D>(a, stream);
  if (a.kk <= 64) return launch_dilated<2, D>(a, stream);
  if (a.kk <= 128) return launch_dilated<4, D>(a, stream);
  return launch_dilated<8, D>(a, stream);
}

bool aligned16(const void* p) { return ((size_t)p & 15u) == 0; }

// ---- The blocked entry ---------------------------------------------------
//
// A block of kBlockWarps warps takes `chunk` consecutive rows, `wpr` warps
// a row; the warps of a row the mask leaves out write its filler and
// return (a ring pass's left-out rows are its last).  The block first
// reads each row's cell ids, in the scan order, into shared memory; then
// each warp scores its groups of its row straight from L2 (kUnroll groups
// of four candidates in flight a lane), in step with the chunk's other
// rows, so that rows of a run (consecutive rows with one neighbourhood)
// read each slab at about the same time and all but the first find it in
// L1.  After the block's two barriers a row's warps synchronise only with
// each other, on barrier 1 + the row's place in the chunk.

constexpr int kBlockWarps = 8;
// the scan order of the slabs of the radius 1 to kMaxOrderRadius
// neighbourhoods, d = 2 then d = 3, each radius after the last
constexpr int kMaxOrderRadius = 4;
constexpr int kOrderEntries = 9 + 25 + 49 + 81 + 27 + 125 + 343 + 729;
__device__ unsigned short kSlabOrder[kOrderEntries];
// per device, filled by grid_select_setup: multiprocessors and the shared
// memory a block may opt in to
constexpr int kMaxDevices = 64;
int g_sm_count[kMaxDevices];
int g_smem_optin[kMaxDevices];

struct BlockedArgs {
  const float* queries;        // [q, d]
  const float* pts;            // [rows, C, d]
  const int* cand;             // [rows, C]
  const long long* flat;       // [q, r]
  const unsigned char* mask;   // [q] bool, or null: every row
  float* sq;                   // [q, k]
  long long* idx;              // [q, k]
  int* sel;                    // [q, k]
  int q, r, log2c, k, kk;
  int order;                   // the slab order's offset in kSlabOrder, or -1
  int chunk, wpr;              // rows a block, warps a row
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// This warp's groups of one row (warp wr of wpr takes groups wr*32 + lane,
// (wr + wpr)*32 + lane, ...).  Group i holds members 4(i & (C/4 - 1)) ..
// + 3 of the row's slab at scan position i >> (log2c - 2), whose cell id is
// cells[that] and whose slab kSlabOrder[order + that] (slot s*C + m).  A
// group whose f32 distances all lie above skip_above costs no f64 work; the
// others are scored as in the dilated rows and offered to the queue.
template <int Q, int D>
__device__ __forceinline__ void select_blocked(WarpSelect<Q>& ws,
                                               const unsigned* cells,
                                               const BlockedArgs& a,
                                               const float (&qv)[D], int wr,
                                               int lane) {
  const int shift = a.log2c - 2;
  const int in_slab = (1 << shift) - 1;
  const int groups = (a.r << a.log2c) / 4;
  const int stride = kWarp * a.wpr;
  for (int s = wr * kWarp; s < groups; s += kUnroll * stride) {
    float4 v[kUnroll][D];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = s + u * stride + lane;
      if (i < groups) {
        const size_t cell = cells[i >> shift];
        const float4* p = reinterpret_cast<const float4*>(
            a.pts + ((cell << a.log2c) + 4 * (i & in_slab)) * D);
#pragma unroll
        for (int c = 0; c < D; ++c) v[u][c] = __ldg(p + c);
      } else {
#pragma unroll
        for (int c = 0; c < D; ++c) v[u][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s + u * stride >= groups) break;  // the same for the whole warp
      const int i = s + u * stride + lane;
      const bool ok = i < groups;
      const float lim = skip_above(ws.thresh_value);
      bool maybe = false;
#pragma unroll
      for (int t = 0; t < 4; ++t) maybe |= !(approx_sq<D>(qv, v[u], t) > lim);
      if (!__any_sync(kFull, ok && maybe)) continue;
      float dist[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) dist[t] = sq_distance<D>(qv, v[u], t);
      const float th = ws.thresh_value;
      const bool near = ok && (dist[0] <= th || dist[1] <= th ||
                               dist[2] <= th || dist[3] <= th);
      if (__any_sync(kFull, near)) {
        const int j = ok ? i >> shift : 0;
        const int slab = a.order < 0 ? j : __ldg(kSlabOrder + a.order + j);
        const unsigned c0 =
            ((unsigned)slab << a.log2c) + 4u * (unsigned)(i & in_slab);
#pragma unroll
        for (int t = 0; t < 4; ++t) ws.offer(make_key(dist[t], c0 + t), ok);
        ws.drain();
      }
    }
  }
  ws.flush();
}

template <int Q, int D>
__global__ void __launch_bounds__(kBlockWarps * kWarp)
grid_select_blocked_kernel(const BlockedArgs a) {
  constexpr int kSlots = slots_per_warp(Q);
  extern __shared__ u64 smem[];
  // queues [warps][kSlots] | rows [warps] | cells [chunk][r]
  u64* queues = smem;
  long long* rows = (long long*)(queues + kBlockWarps * kSlots);
  unsigned* cells = (unsigned*)(rows + kBlockWarps);
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int g = warp / a.wpr;  // this warp's row in the chunk
  const int p = warp % a.wpr;  // and its place among the row's warps
  const long long first = (long long)blockIdx.x * a.chunk;

  // the chunk's rows; -1 past the end and where the mask leaves a row
  // out, whose filler the row's first warp writes
  if (tid < a.chunk) {
    const long long rw = first + tid;
    rows[tid] = rw < a.q && (a.mask == nullptr || a.mask[rw]) ? rw : -1;
  }
  const long long own = first + g;
  if (a.mask != nullptr && p == 0 && own < a.q && !a.mask[own]) {
    for (int j = lane; j < a.k; j += kWarp) {
      a.sq[own * a.k + j] = __uint_as_float(0x7f800000u);
      a.idx[own * a.k + j] = 0;
      a.sel[own * a.k + j] = 0;
    }
  }
  __syncthreads();
  // each row's cell ids in the scan order, read once by the whole block
  for (int e = tid; e < a.chunk * a.r; e += blockDim.x) {
    const int c = e / a.r, j = e - c * a.r;
    if (rows[c] >= 0)
      cells[e] = (unsigned)__ldg(
          a.flat + rows[c] * a.r +
          (a.order < 0 ? j : __ldg(kSlabOrder + a.order + j)));
  }
  __syncthreads();  // the last barrier of the whole block
  const long long row = rows[g];
  if (row < 0) return;

  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qv[d] = __ldg(a.queries + row * D + d);
  u64* mine_q = queues + (size_t)warp * kSlots;
  WarpSelect<Q> ws;
  ws.init(mine_q, lane, a.kk);
  select_blocked<Q, D>(ws, cells + g * a.r, a, qv, p, lane);
  // the row's warps merge their queues pairwise (merge_row_queues on the
  // row's own barrier)
  if (a.wpr > 1) {
    const int bar = 1 + g, threads = a.wpr * kWarp;
#pragma unroll
    for (int r = 0; r < Q; ++r) mine_q[r * kWarp + lane] = ws.q[r];
    named_sync(bar, threads);
    for (int l = 1; l < a.wpr; l <<= 1) {
      if (p % (2 * l) == 0) {
        const u64* other = mine_q + (size_t)l * kSlots;
#pragma unroll
        for (int r = 0; r < Q; ++r)
          ws.q[r] = kmin(ws.q[r], other[kWarp * Q - 1 - (r * kWarp + lane)]);
        bitonic_merge<Q>(ws.q, lane);
#pragma unroll
        for (int r = 0; r < Q; ++r) mine_q[r * kWarp + lane] = ws.q[r];
      }
      named_sync(bar, threads);
    }
  }
  if (p != 0) return;

  // the kk selected by (sq, slot), a +inf distance as slot 0; (sq, idx)
  // keys, the slots beside them, the queue's places past kk last
  const long long* nb = a.flat + row * a.r;
  float* out_sq = a.sq + row * a.k;
  long long* out_idx = a.idx + row * a.k;
  int* out_sel = a.sel + row * a.k;
  u64 key[Q];
  unsigned slot[Q];
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    unsigned ord = (unsigned)(ws.q[r] >> 32);
    unsigned s = (unsigned)ws.q[r];
    if (ord >= kInfOrd) {
      ord = kInfOrd;
      s = 0;
    }
    if (r * kWarp + lane < a.kk) {
      const long long cell = __ldg(nb + (s >> a.log2c));
      key[r] = ((u64)ord << 32) |
               (unsigned)__ldg(a.cand + (cell << a.log2c) +
                               (s & ((1u << a.log2c) - 1u)));
      slot[r] = s;
    } else {
      key[r] = kEmpty;
      slot[r] = ~0u;
    }
  }
  sort_pairs<Q>(key, slot, lane);
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    const int j = r * kWarp + lane;
    if (j < a.k) {
      out_sq[j] = key_value(key[r]);
      out_sel[j] = (int)slot[r];
      out_idx[j] = (long long)(unsigned)key[r];
    }
  }
}

// rows a block: the most (8, 4, 2 or 1) that still gives the card
// kMinBlocksPerSm blocks a multiprocessor (1.5 chooses 4 at a ring pass's
// 1,024 rows, the fastest of the four there, and 1 at the first pass's 256)
constexpr double kMinBlocksPerSm = 1.5;
inline int chunk_rows(long long q, int sms) {
  int chunk = kBlockWarps;
  while (chunk > 1 && (q + chunk - 1) / chunk < kMinBlocksPerSm * sms)
    chunk /= 2;
  return chunk;
}

template <int Q, int D>
cudaError_t launch_blocked(BlockedArgs a, cudaStream_t stream) {
  constexpr int kSlots = slots_per_warp(Q);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || g_sm_count[dev] == 0)
    return cudaErrorInitializationError;  // grid_select_setup not run here
  a.chunk = chunk_rows(a.q, g_sm_count[dev]);
  a.wpr = kBlockWarps / a.chunk;
  const size_t smem = kBlockWarps * (kSlots * sizeof(u64) + sizeof(long long)) +
                      (size_t)a.chunk * a.r * sizeof(unsigned);
  if (smem > (size_t)g_smem_optin[dev]) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((a.q + a.chunk - 1) / a.chunk);
  grid_select_blocked_kernel<Q, D>
      <<<blocks, kBlockWarps * kWarp, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_blocked_q(const BlockedArgs& a, cudaStream_t stream) {
  if (a.kk <= 32) return launch_blocked<1, D>(a, stream);
  if (a.kk <= 64) return launch_blocked<2, D>(a, stream);
  if (a.kk <= 128) return launch_blocked<4, D>(a, stream);
  return launch_blocked<8, D>(a, stream);
}

int ipow(int b, int e) {
  int out = 1;
  while (e-- > 0) out *= b;
  return out;
}

// the offset of the (2 radius + 1)^d neighbourhood's order in kSlabOrder,
// or -1 if r slabs are no such neighbourhood of radius 1 to 4
int order_offset(int d, int r) {
  int offset = 0;
  for (int dd = 2; dd <= 3; ++dd)
    for (int radius = 1; radius <= kMaxOrderRadius; ++radius) {
      const int n = ipow(2 * radius + 1, dd);
      if (dd == d && n == r) return offset;
      offset += n;
    }
  return -1;
}

// The scan orders: the slabs of each neighbourhood (in _neighbor_offsets
// order, the last axis fastest) sorted by the squared length of their
// offset from the home cell, stably.  Any order gives the same selection
// (the kk smallest (sq, slot) keys are one set); the nearest first lowers
// the queue's threshold early, so that fewer candidates are offered.
void fill_orders(unsigned short* out) {
  for (int dd = 2; dd <= 3; ++dd)
    for (int radius = 1; radius <= kMaxOrderRadius; ++radius) {
      const int side = 2 * radius + 1, n = ipow(side, dd);
      for (int key = 0; key <= dd * radius * radius; ++key)
        for (int i = 0; i < n; ++i) {
          int len = 0;
          for (int a = 0, rest = i; a < dd; ++a, rest /= side) {
            const int o = rest % side - radius;
            len += o * o;
          }
          if (len == key) *out++ = (unsigned short)i;
        }
    }
}

template <int D>
cudaError_t allow_smem(int bytes) {
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = cudaSuccess;
  const void* kernels[] = {(const void*)grid_select_blocked_kernel<1, D>,
                           (const void*)grid_select_blocked_kernel<2, D>,
                           (const void*)grid_select_blocked_kernel<4, D>,
                           (const void*)grid_select_blocked_kernel<8, D>};
  for (const void* k : kernels)
    if (e == cudaSuccess) e = cudaFuncSetAttribute(k, attr, bytes);
  return e;
}

}  // namespace

// queries [q, d] f32, dil_pts [rows, keep*d] f32, dil_cand [rows, keep]
// int32, flat [q] int64 (row ids); out sq [q, k] f32, idx [q, k] int64,
// sel [q, k] int32; all contiguous on the current device.  canonical = 0:
// the rows are sorted by index, kk must be k; canonical = 1: the kk
// smallest by (sq, slot) re-sorted by (sq, idx, slot).  d in {2, 3},
// keep % 4 == 0, 1 <= k <= kk <= min(keep, 256).  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int grid_select_dilated_f32(const void* queries,
                                       const void* dil_pts,
                                       const void* dil_cand, const void* flat,
                                       void* sq, void* idx, void* sel, int q,
                                       int d, int keep, int k, int kk,
                                       int canonical, void* stream) {
  if (q <= 0 || (d != 2 && d != 3) || keep <= 0 || keep % 4 != 0 || k <= 0 ||
      kk < k || kk > keep || kk > kMaxK || (!canonical && kk != k) ||
      !aligned16(dil_pts))
    return (int)cudaErrorInvalidValue;
  DilatedArgs a{(const float*)queries, (const float*)dil_pts,
                (const int*)dil_cand, (const long long*)flat, (float*)sq,
                (long long*)idx, (int*)sel, q, keep, k, kk, 1,
                canonical != 0};
  return (int)(d == 2 ? launch_dilated_q<2>(a, (cudaStream_t)stream)
                      : launch_dilated_q<3>(a, (cudaStream_t)stream));
}

// queries [q, d] f32, cell_pts [rows, c, d] f32, cell_list [rows, c] int32,
// flat [q, r] int64 (the neighbourhood's cell ids), mask [q] bool or null;
// out sq [q, k] f32, idx [q, k] int64, sel [q, k] int32 (slot s*c + m);
// all contiguous on the current device.  The kk smallest by (sq, slot)
// re-sorted by (sq, idx, slot); rows the mask leaves out get (+inf, 0, 0).
// d in {2, 3}, c a power of two >= 4, 1 <= k <= kk <= min(r*c, 256).
// Launches on `stream` and returns cudaGetLastError(); refused until
// grid_select_setup has run on the current device.
extern "C" int grid_select_blocked_f32(const void* queries,
                                       const void* cell_pts,
                                       const void* cell_list,
                                       const void* flat, const void* mask,
                                       void* sq, void* idx, void* sel, int q,
                                       int d, int r, int c, int k, int kk,
                                       void* stream) {
  int log2c = 0;
  while ((1 << log2c) < c) ++log2c;
  if (q <= 0 || (d != 2 && d != 3) || r <= 0 || c < 4 || (1 << log2c) != c ||
      (long long)r * c > (1 << 30) || k <= 0 || kk < k || kk > r * c ||
      kk > kMaxK || !aligned16(cell_pts))
    return (int)cudaErrorInvalidValue;
  BlockedArgs a{(const float*)queries, (const float*)cell_pts,
                (const int*)cell_list, (const long long*)flat,
                (const unsigned char*)mask, (float*)sq, (long long*)idx,
                (int*)sel, q, r, log2c, k, kk, order_offset(d, r), 1, 1};
  return (int)(d == 2 ? launch_blocked_q<2>(a, (cudaStream_t)stream)
                      : launch_blocked_q<3>(a, (cudaStream_t)stream));
}

// Once a device, before the blocked entry's first launch there and never
// during a graph capture: uploads the slab scan orders, lets the blocked
// kernels take the shared memory a block may opt in to, and records the
// device's multiprocessors.  Returns a CUDA error code, 0 on success.
extern "C" int grid_select_setup() {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= kMaxDevices) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = allow_smem<2>(optin);
  if (e == cudaSuccess) e = allow_smem<3>(optin);
  if (e == cudaSuccess) {
    unsigned short orders[kOrderEntries];
    fill_orders(orders);
    e = cudaMemcpyToSymbol(kSlabOrder, orders, sizeof(orders));
  }
  if (e != cudaSuccess) return (int)e;
  g_sm_count[dev] = sms;
  g_smem_optin[dev] = optin;
  return 0;
}
