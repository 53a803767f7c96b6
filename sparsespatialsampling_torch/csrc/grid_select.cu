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
// ms at 3.35 TB/s; the epoch's dilated [65536, 384] 302 MB, 0.090 ms.
//
// What the design does about it:
//   * Each lane takes groups of four consecutive candidates (4*d floats,
//     16-byte aligned), d 16-byte vector loads a group, four groups in
//     flight, computes their four distances in registers and offers the
//     four keys to the warp queue of warp_select.cuh (csrc/topk_smallest.cu
//     uses the same queue).  A group whose four distances all lie above the
//     queue's threshold costs four compares and one vote.
//   * Dilated rows (<= 2048 candidates) and radius-1 blocked rows take one
//     warp a row, four rows a block.  Wide rows (the radius-4 ring: 23,328
//     candidates in 3D) take one block of up to 8 warps a row, each warp
//     over a strided range of groups; the warps' queues are merged pairwise
//     in shared memory.  A blocked group never straddles two slabs (C is a
//     power of two, at least 4): its slab's cell id is one read of `flat`,
//     which the lanes of a slab share.
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

struct Args {
  const float* queries;        // [q, d]
  const float* pts;            // dilated [rows, W*d]; blocked [rows, C, d]
  const int* cand;             // dilated [rows, W];   blocked [rows, C]
  const long long* flat;       // dilated [q];         blocked [q, R]
  const unsigned char* mask;   // [q] bool, or null: every row
  float* sq;                   // [q, k]
  long long* idx;              // [q, k]
  int* sel;                    // [q, k]
  int q, width, r, log2c, k, kk, wpr;
  bool canonical;              // re-sort the kk by (sq, idx, slot)
};

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

// sq of candidate t of a group, rounded as the port's `_sqsum`
template <int D>
__device__ __forceinline__ float sq_distance(const float (&qv)[D],
                                             const float4 (&v)[D], int t) {
  const float d0 = __fsub_rn(qv[0], coord<D>(v, t * D));
  float out = __fmul_rn(d0, d0);
#pragma unroll
  for (int a = 1; a < D; ++a) {
    const double da = (double)__fsub_rn(qv[a], coord<D>(v, t * D + a));
    out = __double2float_rn(__dadd_rn(__dmul_rn(da, da), (double)out));
  }
  return out;
}

// One query's dilated row: slot j's coordinates at base[j*D, j*D + D).
template <int D>
struct DilatedRow {
  const float* base;
  const int* cand;

  __device__ DilatedRow(const Args& a, long long row) {
    const long long f = __ldg(a.flat + row);
    base = a.pts + f * a.width * D;
    cand = a.cand + f * a.width;
  }
  __device__ __forceinline__ const float* group(int i) const {
    return base + (long long)i * 4 * D;
  }
  __device__ __forceinline__ int candidate(unsigned slot) const {
    return __ldg(cand + slot);
  }
};

// One query's R blocked slabs: slot s*C + m is member m of cell flat[s].
template <int D>
struct BlockedRow {
  const float* pts;
  const int* cand;
  const long long* flat;
  int log2c;

  __device__ BlockedRow(const Args& a, long long row)
      : pts(a.pts), cand(a.cand), flat(a.flat + row * a.r), log2c(a.log2c) {}
  __device__ __forceinline__ const float* group(int i) const {
    const int shift = log2c - 2;  // groups a slab: C / 4
    const long long cell = __ldg(flat + (i >> shift));
    return pts + ((cell << log2c) + 4 * (i & ((1 << shift) - 1))) * D;
  }
  __device__ __forceinline__ int candidate(unsigned slot) const {
    const long long cell = __ldg(flat + (slot >> log2c));
    return __ldg(cand + (cell << log2c) + (slot & ((1u << log2c) - 1u)));
  }
};

// This warp's groups of one row (warp wr of wpr takes groups wr*32 + lane,
// (wr + wpr)*32 + lane, ...): every distance offered to the queue once.
template <int Q, int D, class Row>
__device__ __forceinline__ void select_row(WarpSelect<Q>& ws, const Row& row,
                                           const float (&qv)[D], int groups,
                                           int wr, int wpr, int lane) {
  const int stride = kWarp * wpr;
  for (int s = wr * kWarp; s < groups; s += kUnroll * stride) {
    float4 v[kUnroll][D];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = s + u * stride + lane;
      if (i < groups) {
        const float4* p = reinterpret_cast<const float4*>(row.group(i));
#pragma unroll
        for (int a = 0; a < D; ++a) v[u][a] = __ldg(p + a);
      } else {
#pragma unroll
        for (int a = 0; a < D; ++a) v[u][a] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s + u * stride < groups) {  // the same for the whole warp
        const int i = s + u * stride + lane;
        const bool ok = i < groups;
        float dist[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) dist[t] = sq_distance<D>(qv, v[u], t);
        const float th = ws.thresh_value;
        const bool near = ok && (dist[0] <= th || dist[1] <= th ||
                                 dist[2] <= th || dist[3] <= th);
        if (__any_sync(kFull, near)) {
          const unsigned c0 = 4u * (unsigned)i;
#pragma unroll
          for (int t = 0; t < 4; ++t) ws.offer(make_key(dist[t], c0 + t), ok);
          ws.drain();
        }
      }
    }
  }
  ws.flush();
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

template <int Q, int D, class Row>
__global__ void __launch_bounds__(kMaxWarpsPerRow * kWarp)
grid_select_kernel(const Args a) {
  constexpr int kSlots = slots_per_warp(Q);
  extern __shared__ u64 smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int rows_per_block = blockDim.x / (kWarp * a.wpr);
  const int wr = warp % a.wpr;
  const long long row = (long long)blockIdx.x * rows_per_block + warp / a.wpr;
  // only narrow blocks (wpr == 1) hold rows past the end, and a row the
  // mask leaves out is the whole block where it spans it: neither reaches
  // a block barrier
  if (row >= a.q) return;
  float* out_sq = a.sq + row * a.k;
  long long* out_idx = a.idx + row * a.k;
  int* out_sel = a.sel + row * a.k;
  if (a.mask != nullptr && !a.mask[row]) {
    if (wr == 0) {
      for (int j = lane; j < a.k; j += kWarp) {
        out_sq[j] = __uint_as_float(0x7f800000u);
        out_idx[j] = 0;
        out_sel[j] = 0;
      }
    }
    return;
  }

  float qv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qv[d] = __ldg(a.queries + row * D + d);
  const Row src(a, row);
  u64* mine = smem + (size_t)warp * kSlots;
  WarpSelect<Q> ws;
  ws.init(mine, lane, a.kk);
  select_row<Q, D>(ws, src, qv, a.width / 4, wr, a.wpr, lane);
  if (a.wpr > 1) merge_row_queues<Q>(ws, mine, kSlots, wr, a.wpr);
  if (wr != 0) return;

  // the kk selected by (sq, slot); a +inf distance takes slot 0 (the
  // selection kernel's caveat)
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
        key[r] |= (unsigned)src.candidate(slot[r]);
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
                               : (long long)src.candidate(slot[r]);
    }
  }
}

template <int Q, int D, class Row>
cudaError_t launch(Args a, cudaStream_t stream) {
  constexpr int kSlots = slots_per_warp(Q);
  a.wpr = warps_per_row(a.width);
  const int threads =
      a.wpr == 1 ? kNarrowRowsPerBlock * kWarp : a.wpr * kWarp;
  const int rows_per_block = threads / (kWarp * a.wpr);
  const unsigned blocks =
      (unsigned)((a.q + (long long)rows_per_block - 1) / rows_per_block);
  const size_t smem = (size_t)(threads / kWarp) * kSlots * sizeof(u64);
  grid_select_kernel<Q, D, Row><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, class Row>
cudaError_t launch_q(const Args& a, cudaStream_t stream) {
  if (a.kk <= 32) return launch<1, D, Row>(a, stream);
  if (a.kk <= 64) return launch<2, D, Row>(a, stream);
  if (a.kk <= 128) return launch<4, D, Row>(a, stream);
  return launch<8, D, Row>(a, stream);
}

template <template <int> class Row>
cudaError_t launch_d(const Args& a, int d, cudaStream_t stream) {
  return d == 2 ? launch_q<2, Row<2>>(a, stream)
                : launch_q<3, Row<3>>(a, stream);
}

bool aligned16(const void* p) { return ((size_t)p & 15u) == 0; }

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
  Args a{(const float*)queries, (const float*)dil_pts, (const int*)dil_cand,
         (const long long*)flat, nullptr, (float*)sq, (long long*)idx,
         (int*)sel, q, keep, 1, 0, k, kk, 1, canonical != 0};
  return (int)launch_d<DilatedRow>(a, d, (cudaStream_t)stream);
}

// queries [q, d] f32, cell_pts [rows, c, d] f32, cell_list [rows, c] int32,
// flat [q, r] int64 (the neighbourhood's cell ids), mask [q] bool or null;
// out sq [q, k] f32, idx [q, k] int64, sel [q, k] int32 (slot s*c + m);
// all contiguous on the current device.  The kk smallest by (sq, slot)
// re-sorted by (sq, idx, slot); rows the mask leaves out get (+inf, 0, 0).
// d in {2, 3}, c a power of two >= 4, 1 <= k <= kk <= min(r*c, 256).
// Launches on `stream` and returns cudaGetLastError().
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
  Args a{(const float*)queries, (const float*)cell_pts,
         (const int*)cell_list, (const long long*)flat,
         (const unsigned char*)mask, (float*)sq, (long long*)idx, (int*)sel,
         q, r * c, r, log2c, k, kk, 1, true};
  return (int)launch_d<BlockedRow>(a, d, (cudaStream_t)stream);
}
