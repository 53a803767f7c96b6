// k smallest values of each row of a float32 matrix, ascending, with ties
// to the lowest column: the selection step of the dilated-grid kNN and of
// the full scan (per score tile, then over the tiles' merged candidates).
//
// Replaces the TPU kernel `topk_smallest` of the JAX package
// (ops/pallas_topk.py:62, body `_topk_small_kernel` at :29-51) and computes
// the same function bit for bit:
//   * the k smallest of each row, ascending, ties to the lowest column;
//   * values are the input values unchanged, columns are int32;
//   * the TPU kernel's caveat (ops/pallas_topk.py:67-74): it extracts by
//     overwriting each winner with +inf, so once a row's entries below +inf
//     run out the whole row is +inf and every further output is (+inf,
//     column 0).  Here every +inf output is written as (+inf, 0).
//
// What bounds it: each row is read once and k (value, column) pairs are
// written, Q*W*4 + Q*k*8 bytes at 3.35 TB/s (0.040 ms at the 3D epoch
// shape [36864, 864] k=26, 0.020 ms at a full-scan tile [1024, 16384]
// k=34).  Selection needs about one compare per element and no products,
// so the memory rate is the bound and tensor cores do not apply.
//
// What the design does about it (the warp queue, its 64-bit keys and the
// pairwise merge of a wide row's warps are in warp_select.cuh, shared with
// csrc/grid_select.cu):
//   * Each warp reads its slice of the row twice, in 16-byte vector loads
//     (a scalar head up to 16-byte alignment and a scalar tail where W is
//     not a multiple of 4), four loads in flight per lane.  The first pass
//     keeps each lane's smallest entry (two for k > 32) in registers; the
//     second finds the slice in cache (L1 or L2: it was just read), so
//     device memory sees each byte once.  Rows are contiguous, so plain
//     vector loads already move whole 512-byte lines per warp; TMA or
//     cp.async would only stage the row in shared memory, which this
//     design never needs.
//   * The lanes' smallest entries are merged into the warp queue first,
//     which sets the admission threshold near the slice's k-th key.  In the
//     second pass a vector step whose four values all lie above the
//     threshold costs four float compares and one vote; the keys below it
//     are offered to the queue.
//   * Narrow rows (W <= 2048: epoch rows, the merge of the full scan's
//     candidates) take one warp per row, four rows a block.  Wide rows (the
//     16384-wide full-scan tile) take one block of up to 8 warps per row:
//     each warp selects over a strided slice, then the warps' sorted queues
//     are merged pairwise in shared memory (a few KB), log2(warps) levels.
//   * No row is staged: W is bounded only by the int32 column index.
//
// Limits: 1 <= k <= min(W, 256).
#include <cuda_runtime.h>

#include "warp_select.cuh"

namespace {

constexpr int kUnroll = 4;  // vector loads in flight a lane

// This warp's slice of one row: warp `wr` of `wpr` takes the 16-byte
// vectors wr*32 + lane, (wr + wpr)*32 + lane, ...; warp 0 also takes the
// scalar head (columns below 16-byte alignment) and tail.  Two passes over
// the slice: the first keeps each lane's P smallest entries and merges
// them, which sets a threshold close to the slice's k-th key; the second
// (from cache: the slice was just read) offers the entries below it.
template <int Q>
__device__ __forceinline__ void select_slice(WarpSelect<Q>& ws,
                                             const float* row, int w,
                                             int wr, int wpr, int lane) {
  constexpr int P = Q == 1 ? 1 : 2;
  const unsigned misalign = (unsigned)((size_t)row & 15u) / 4u;
  const int head = min(w, (int)((4u - misalign) & 3u));
  const int n4 = (w - head) / 4;
  const int tail = w - head - 4 * n4;
  if (wr == 0 && head + tail > 0) {
    const bool valid = lane < head + tail;
    const int col = lane < head ? lane : head + 4 * n4 + (lane - head);
    const float v = valid ? row[col] : 0.0f;
    ws.offer(make_key(v, (unsigned)col), valid);
  }
  const float4* body = reinterpret_cast<const float4*>(row + head);
  const int stride = kWarp * wpr;
  const int first = wr * kWarp;

  LaneBest<P> best;
  best.init();
  for (int s = first; s < n4; s += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = s + u * stride + lane;
      v[u] = i < n4 ? __ldg(body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = s + u * stride + lane;
      if (i < n4) {
        const int c0 = head + 4 * i;
        best.push(v[u].x, c0);
        best.push(v[u].y, c0 + 1);
        best.push(v[u].z, c0 + 2);
        best.push(v[u].w, c0 + 3);
      }
    }
  }
  if (first >= n4) {
    ws.flush();
    return;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) ws.merge(best.key(p));

  for (int s = first; s < n4; s += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = s + u * stride + lane;
      v[u] = i < n4 ? __ldg(body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s + u * stride < n4) {  // the same for the whole warp
        const int i = s + u * stride + lane;
        const float t = ws.thresh_value;
        const bool near = i < n4 && (v[u].x <= t || v[u].y <= t ||
                                     v[u].z <= t || v[u].w <= t);
        if (__any_sync(kFull, near)) {
          const int c0 = head + 4 * i;
          const bool ok = i < n4;
          ws.offer(make_key(v[u].x, c0), ok && !best.holds(c0));
          ws.offer(make_key(v[u].y, c0 + 1), ok && !best.holds(c0 + 1));
          ws.offer(make_key(v[u].z, c0 + 2), ok && !best.holds(c0 + 2));
          ws.offer(make_key(v[u].w, c0 + 3), ok && !best.holds(c0 + 3));
          ws.drain();
        }
      }
    }
  }
  ws.flush();
}

template <int Q>
__global__ void __launch_bounds__(kMaxWarpsPerRow * kWarp)
topk_smallest_kernel(const float* __restrict__ x, float* __restrict__ vals,
                     int* __restrict__ sel, int q, int w, int k, int wpr) {
  constexpr int kSlots = slots_per_warp(Q);
  extern __shared__ u64 smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int rows_per_block = blockDim.x / (kWarp * wpr);
  const int wr = warp % wpr;
  const long long row = (long long)blockIdx.x * rows_per_block + warp / wpr;
  // only narrow blocks (wpr == 1) hold rows past the end, and they never
  // reach a block barrier
  if (row >= q) return;

  u64* mine = smem + (size_t)warp * kSlots;
  const float* src = x + row * (long long)w;
  WarpSelect<Q> ws;
  ws.init(mine, lane, k);
  select_slice<Q>(ws, src, w, wr, wpr, lane);

  if (wpr > 1) merge_row_queues<Q>(ws, mine, kSlots, wr, wpr);
  if (wr != 0) return;

  float* out_v = vals + row * (long long)k;
  int* out_s = sel + row * (long long)k;
#pragma unroll
  for (int r = 0; r < Q; ++r) {
    const int j = r * kWarp + lane;
    if (j < k) {
      const unsigned ord = (unsigned)(ws.q[r] >> 32);
      const unsigned col = (unsigned)ws.q[r];
      if (ord >= kInfOrd) {  // the TPU kernel's caveat
        out_v[j] = __uint_as_float(0x7f800000u);
        out_s[j] = 0;
      } else {
        out_v[j] = src[col];  // the input's own bits (-0 stays -0)
        out_s[j] = (int)col;
      }
    }
  }
}

template <int Q>
cudaError_t launch(const float* x, float* vals, int* sel, int q, int w,
                   int k, cudaStream_t stream) {
  constexpr int kSlots = slots_per_warp(Q);
  const int wpr = warps_per_row(w);
  const int threads = wpr == 1 ? kNarrowRowsPerBlock * kWarp : wpr * kWarp;
  const int rows_per_block = threads / (kWarp * wpr);
  const unsigned blocks =
      (unsigned)((q + (long long)rows_per_block - 1) / rows_per_block);
  const size_t smem = (size_t)(threads / kWarp) * kSlots * sizeof(u64);
  topk_smallest_kernel<Q><<<blocks, threads, smem, stream>>>(x, vals, sel, q,
                                                             w, k, wpr);
  return cudaGetLastError();
}

}  // namespace

// x [q, w] float32, vals [q, k] float32, sel [q, k] int32, all contiguous on
// the current device; 1 <= k <= min(w, 256).  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int topk_smallest_f32(const void* x, void* vals, void* sel, int q,
                                 int w, int k, void* stream) {
  if (q <= 0 || w <= 0 || k <= 0 || k > w || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  float* vf = (float*)vals;
  int* sf = (int*)sel;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (k <= 32)
    e = launch<1>(xf, vf, sf, q, w, k, st);
  else if (k <= 64)
    e = launch<2>(xf, vf, sf, q, w, k, st);
  else if (k <= 128)
    e = launch<4>(xf, vf, sf, q, w, k, st);
  else
    e = launch<8>(xf, vf, sf, q, w, k, st);
  return (int)e;
}
