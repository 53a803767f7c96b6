// The warp-wide k-smallest selection shared by the port's selection
// kernels (csrc/topk_smallest.cu, csrc/grid_select.cu): WarpSelect of
// Johnson, Douze and Jegou, "Billion-scale similarity search with GPUs",
// 2017.
//
//   * One 64-bit key per candidate: the f32 value mapped to an
//     order-preserving u32 (sign bit flipped for non-negative values, all
//     bits for negative ones; -0 taken as +0, as `==` does) in the high
//     half, the candidate's column in the low half.  One unsigned compare
//     is "smaller value, then lower column", and all keys of a row are
//     distinct.
//   * A warp queue holds the best 32*Q keys merged so far, sorted across
//     the lanes in registers (element r*32 + lane in q[r]); its k-th key is
//     the admission threshold.  Admitted keys are compacted (ballot +
//     popcount) into a per-warp buffer in shared memory, and every 32
//     buffered keys are sorted by a warp-wide bitonic network of shuffles
//     and merged into the queue (reverse, min, bitonic merge).
//   * A wide row is split over up to kMaxWarpsPerRow warps of one block;
//     their sorted queues are merged pairwise in shared memory
//     (merge_row_queues), log2(warps) levels.
//
// Included by each kernel source; every definition is local to the
// including translation unit.
#pragma once
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 256;
constexpr u64 kEmpty = ~0ull;              // above every key of a row
constexpr unsigned kInfOrd = 0xff800000u;  // ordered image of +inf
// leftover (< 32) plus one step's offers (4 per lane): the buffer's size
constexpr int kBufSlots = kWarp + 4 * kWarp;
constexpr int kNarrowRowsPerBlock = 4;
constexpr int kNarrowMaxWidth = 2048;
constexpr int kWarpSliceWidth = 1024;  // least columns a warp of a wide row
constexpr int kMaxWarpsPerRow = 8;

// shared memory of one warp, in keys: its buffer, which the pairwise merge
// of a wide row then reuses for the warp's sorted queue (32*Q keys)
__host__ __device__ constexpr int slots_per_warp(int q) {
  return kBufSlots > kWarp * q ? kBufSlots : kWarp * q;
}

__device__ __forceinline__ u64 make_key(float v, unsigned col) {
  unsigned b = __float_as_uint(v);
  b = (b == 0x80000000u) ? 0u : b;
  const unsigned ord = b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
  return ((u64)ord << 32) | col;
}

__device__ __forceinline__ float key_value(u64 key) {
  const unsigned ord = (unsigned)(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord ^ 0x80000000u) : ~ord);
}

__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 kmax(u64 a, u64 b) { return a < b ? b : a; }

// ascending bitonic sort of one key a lane across the warp
__device__ __forceinline__ u64 warp_sort32(u64 c, int lane) {
#pragma unroll
  for (int size = 2; size <= kWarp; size <<= 1) {
    const bool up = (lane & size) == 0;
#pragma unroll
    for (int s = size >> 1; s > 0; s >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, c, s);
      c = (((lane & s) == 0) == up) ? kmin(c, o) : kmax(c, o);
    }
  }
  return c;
}

// ascending bitonic merge of a bitonic sequence of 32*Q keys held as
// element r*32 + lane in v[r]
template <int Q>
__device__ __forceinline__ void bitonic_merge(u64 (&v)[Q], int lane) {
#pragma unroll
  for (int sr = Q / 2; sr > 0; sr >>= 1) {
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      if ((r & sr) == 0) {
        const u64 a = v[r], b = v[r + sr];
        v[r] = kmin(a, b);
        v[r + sr] = kmax(a, b);
      }
    }
  }
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1) {
    const bool low = (lane & s) == 0;
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      const u64 o = __shfl_xor_sync(kFull, v[r], s);
      v[r] = low ? kmin(v[r], o) : kmax(v[r], o);
    }
  }
}

// Warp-wide selection state: the sorted queue `q` (element r*32 + lane in
// q[r]), its admission threshold (the k-th key) and the shared-memory
// buffer of admitted keys not yet merged.
template <int Q>
struct WarpSelect {
  u64 q[Q];
  u64 thresh;
  float thresh_value;  // the value half of `thresh` (+inf while empty)
  u64* buf;
  int count;
  int lane;
  int k;

  __device__ __forceinline__ void init(u64* buffer, int lane_, int k_) {
#pragma unroll
    for (int r = 0; r < Q; ++r) q[r] = kEmpty;
    thresh = kEmpty;
    thresh_value = __uint_as_float(0x7f800000u);
    buf = buffer;
    count = 0;
    lane = lane_;
    k = k_;
  }

  __device__ __forceinline__ void update_thresh() {
    const int r = (k - 1) / kWarp;
    u64 v = q[0];
#pragma unroll
    for (int i = 1; i < Q; ++i)
      if (i == r) v = q[i];
    thresh = __shfl_sync(kFull, v, (k - 1) % kWarp);
    thresh_value = thresh == kEmpty ? __uint_as_float(0x7f800000u)
                                    : key_value(thresh);
  }

  // merge one key a lane (any order; kEmpty for none) into the queue
  __device__ __forceinline__ void merge(u64 c) {
    c = warp_sort32(c, lane);
    // the queue ascending, the candidates descending after it: their
    // elementwise min holds the 32*Q smallest of both, as a bitonic run
    const u64 rc = __shfl_sync(kFull, c, kWarp - 1 - lane);
    q[Q - 1] = kmin(q[Q - 1], rc);
    bitonic_merge<Q>(q, lane);
    update_thresh();
  }

  __device__ __forceinline__ void offer(u64 key, bool valid) {
    const bool take = valid && key < thresh;
    const unsigned m = __ballot_sync(kFull, take);
    if (take) buf[count + __popc(m & ((1u << lane) - 1u))] = key;
    count += __popc(m);
  }

  // merge buffered keys 32 at a time while at least 32 wait
  __device__ __forceinline__ void drain() {
    while (count >= kWarp) {
      __syncwarp();
      const u64 c = buf[count - kWarp + lane];
      __syncwarp();
      count -= kWarp;
      merge(c);
    }
  }

  __device__ __forceinline__ void flush() {
    if (count > 0) {
      __syncwarp();
      const u64 c = lane < count ? buf[lane] : kEmpty;
      __syncwarp();
      count = 0;
      merge(c);
    }
  }
};

// The (value, column) pairs of a lane's P smallest entries seen so far, in
// key order (P = 1 or 2; column -1 for none).  Columns arrive ascending,
// so a strict `<` keeps the lower column of equal values.
template <int P>
struct LaneBest {
  float v[P];
  int c[P];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      v[p] = __uint_as_float(0x7f800000u);
      c[p] = -1;
    }
  }

  __device__ __forceinline__ void push(float x, int col) {
    if (P == 1) {
      const bool a = x < v[0];
      v[0] = a ? x : v[0];
      c[0] = a ? col : c[0];
    } else {
      const bool a = x < v[0];
      const bool b = x < v[P - 1];
      v[P - 1] = a ? v[0] : (b ? x : v[P - 1]);
      c[P - 1] = a ? c[0] : (b ? col : c[P - 1]);
      v[0] = a ? x : v[0];
      c[0] = a ? col : c[0];
    }
  }

  __device__ __forceinline__ u64 key(int p) const {
    return c[p] < 0 ? kEmpty : make_key(v[p], (unsigned)c[p]);
  }

  __device__ __forceinline__ bool holds(int col) const {
    bool h = false;
#pragma unroll
    for (int p = 0; p < P; ++p) h |= col == c[p];
    return h;
  }
};

// warps that share one row of w columns: one up to kNarrowMaxWidth, else
// the most (a power of two, at most kMaxWarpsPerRow) that leaves each at
// least kWarpSliceWidth columns
inline int warps_per_row(int w) {
  int wpr = 1;
  if (w > kNarrowMaxWidth)
    while (wpr < kMaxWarpsPerRow && 2 * wpr * kWarpSliceWidth <= w) wpr *= 2;
  return wpr;
}

// Pairwise merge of the sorted queues of the wpr warps that share one row
// (the whole block; `mine` is this warp's kSlots keys of shared memory,
// its buffer flushed): the first list ascending against the second read
// backwards gives the 32*Q smallest of both.  Warp 0 ends with the row's.
template <int Q>
__device__ __forceinline__ void merge_row_queues(WarpSelect<Q>& ws, u64* mine,
                                                 int slots, int wr,
                                                 int wpr) {
  const int lane = ws.lane;
#pragma unroll
  for (int r = 0; r < Q; ++r) mine[r * kWarp + lane] = ws.q[r];
  __syncthreads();
  for (int l = 1; l < wpr; l <<= 1) {
    if (wr % (2 * l) == 0) {
      const u64* other = mine + (size_t)l * slots;
#pragma unroll
      for (int r = 0; r < Q; ++r)
        ws.q[r] = kmin(ws.q[r], other[kWarp * Q - 1 - (r * kWarp + lane)]);
      bitonic_merge<Q>(ws.q, lane);
#pragma unroll
      for (int r = 0; r < Q; ++r) mine[r * kWarp + lane] = ws.q[r];
    }
    __syncthreads();
  }
}

}  // namespace
