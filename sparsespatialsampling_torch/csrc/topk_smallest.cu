// k smallest values of each row of a float32 matrix, ascending, with ties
// to the lowest column: the selection step of the dilated-grid kNN.
//
// Replaces the TPU kernel `topk_smallest` of the JAX package
// (ops/pallas_topk.py:62, body `_topk_small_kernel` at :29-51) and computes
// the same function bit for bit:
//   * k rounds of "take the row minimum, at its lowest slot, then overwrite
//     that slot with +inf";
//   * values are the input values unchanged, slots are int32;
//   * a row with fewer than k finite entries repeats the lowest slot that
//     holds +inf, as the TPU kernel does (ops/pallas_topk.py:67-74).
//
// What bounds it: the input is read once, Q*W*4 bytes (127 MB at the 3D
// epoch shape [36864, 864]), so the floor is the memory rate; the k rounds
// are short dependent chains of shared-memory reads and warp shuffles.
// What the design does about it: one warp per row stages the row in shared
// memory with coalesced loads (lane l takes columns l, l+32, ...), so the
// row leaves device memory exactly once.  Every lane keeps the minimum of
// its own columns in registers; a round is one five-step shuffle reduction
// of (value, slot) pairs, and only the lane that owned the winner rescans
// its W/32 columns.  Enough warps stay resident (4 rows a block, W*16 bytes
// of shared memory a block) to hide the reads of the staging pass.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// (value, slot) of the smallest of this lane's columns l, l+32, ... of
// `row`; the first column is taken unconditionally and later ones only when
// strictly smaller, so equal values (+inf included) keep the lowest slot.
__device__ __forceinline__ void lane_min(const float* row, int w, int lane,
                                         float& best_v, int& best_s) {
  best_v = __int_as_float(0x7f800000);  // +inf
  best_s = INT_MAX;                     // no column: loses every tie
  for (int s = lane; s < w; s += kWarp) {
    const float v = row[s];
    if (best_s == INT_MAX || v < best_v) {
      best_v = v;
      best_s = s;
    }
  }
}

__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
topk_smallest_kernel(const float* __restrict__ x, float* __restrict__ vals,
                     int* __restrict__ sel, int q, int w, int k) {
  extern __shared__ float rows[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= q) return;  // the whole warp leaves together

  float* buf = rows + (size_t)warp * w;
  const float* src = x + row * (long long)w;
  float best_v = __int_as_float(0x7f800000);
  int best_s = INT_MAX;
  for (int s = lane; s < w; s += kWarp) {
    const float v = src[s];
    buf[s] = v;
    if (best_s == INT_MAX || v < best_v) {
      best_v = v;
      best_s = s;
    }
  }
  // each lane reads back only the columns it wrote itself: no barrier

  float* out_v = vals + row * (long long)k;
  int* out_s = sel + row * (long long)k;
  for (int j = 0; j < k; ++j) {
    float m_v = best_v;
    int m_s = best_s;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float o_v = __shfl_xor_sync(kFullMask, m_v, off);
      const int o_s = __shfl_xor_sync(kFullMask, m_s, off);
      if (o_v < m_v || (o_v == m_v && o_s < m_s)) {
        m_v = o_v;
        m_s = o_s;
      }
    }
    // every lane now holds the same (value, slot): a total order
    if (lane == (j & (kWarp - 1))) {
      out_v[j] = m_v;
      out_s[j] = m_s;
    }
    if ((m_s & (kWarp - 1)) == lane) {
      buf[m_s] = __int_as_float(0x7f800000);
      lane_min(buf, w, lane, best_v, best_s);
    }
  }
}

}  // namespace

// x [q, w] float32, vals [q, k] float32, sel [q, k] int32, all contiguous on
// the current device; launches on `stream` and returns cudaGetLastError().
extern "C" int topk_smallest_f32(const void* x, void* vals, void* sel, int q,
                                 int w, int k, void* stream) {
  if (q <= 0 || w <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kRowsPerBlock * w * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_smallest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((q + kRowsPerBlock - 1) / kRowsPerBlock);
  topk_smallest_kernel<<<blocks, kRowsPerBlock * kWarp, smem,
                         (cudaStream_t)stream>>>(
      (const float*)x, (float*)vals, (int*)sel, q, w, k);
  return (int)cudaGetLastError();
}
