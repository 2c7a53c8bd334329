// class_reduce — per-row best class score and the first index attaining it.
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/epilogue.py
// class_reduce (_class_reduce_kernel): (N, L) f32 scores -> (N,) f32 max,
// (N,) int32 first argmax. On the SSD path N is the anchor count (2916 at
// 300x300) and L the class count less background (90), read in place as the
// (2916, 91)[:, 1:] view.
//
// Bound: device memory. The function reads N*L*4 bytes once and writes N*8;
// the comparisons are a few operations per byte. At the slice's shape that is
// about 1.06 MB, 0.32 us at the H100's 3.35 TB/s, which lies below the time
// of launching any kernel at all (an empty kernel of this grid replayed in a
// CUDA graph takes about 1.0-1.2 us). What is left to win is latency, on one
// chain per row: load, compare, merge, store. The first kernel (a warp a row,
// lanes looping over j = lane, lane + 32, ... with a branchy float compare
// between loads, then a five-stage butterfly of two shuffles and the same
// compare) made that chain long.
//
// Design, each step measured on the card against the alternatives:
//   * one round trip: a warp a row, each lane loading its columns lane,
//     lane + 32, lane + 64 into registers, every load issued before the
//     first comparison (rows wider than 96 take further chunks of 96);
//     neighbouring lanes read neighbouring words;
//   * comparisons on order keys: each value maps to a 32-bit unsigned key
//     that orders as the floats do, with every NaN above +inf and +0.0 equal
//     to -0.0, so one integer compare keeps a lane's first maximum (a lane's
//     columns ascend);
//   * the merge: two warp reductions (redux.sync, one instruction each), the
//     maximum key and then the least index holding it;
//   * the lane whose own candidate won writes the score, so it is the
//     winning element itself (its sign of zero, its NaN payload).
// Equal values give the smallest index, a NaN beats every number and the
// first NaN wins among NaNs: jnp.argmax's first-max rule. Blocks are 8 warps
// (8 rows). Rows may be strided (row_stride >= L) with any base, so the
// caller's view is read in place with no copy and no byte outside its rows.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;  // a warp a row
constexpr int kPerLane = 3;           // values a lane loads before comparing
constexpr unsigned kFullMask = 0xffffffffu;

// A key that orders as the floats do: every NaN on top, +0.0 and -0.0
// equal, 0 below every value's key (-inf's is 0x007fffff).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return v != v ? 0xffffffffu : (v == 0.0f ? 0x80000000u : k);
}

__global__ void __launch_bounds__(kThreads)
    class_reduce_kernel(const float* __restrict__ x, float* __restrict__ best,
                        int* __restrict__ index, int n, int l, long long row_stride) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + (threadIdx.x >> 5);
  const bool live = row < n;
  const int len = live ? l : 0;
  const float* xr = x + (live ? row : 0) * row_stride;
  unsigned bk = 0;
  int bj = INT_MAX;
  float bv = 0.0f;
  for (int j0 = lane; j0 < len; j0 += kPerLane * 32) {
    float v[kPerLane];
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int j = j0 + m * 32;
      v[m] = j < len ? xr[j] : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int j = j0 + m * 32;
      const unsigned k = j < len ? order_key(v[m]) : 0u;
      if (k > bk) {
        bk = k;
        bj = j;
        bv = v[m];
      }
    }
  }
  const unsigned k = __reduce_max_sync(kFullMask, bk);
  const int j = static_cast<int>(
      __reduce_min_sync(kFullMask, bk == k ? static_cast<unsigned>(bj) : 0xffffffffu));
  if (live && bj == j) {  // this lane holds the winner
    best[row] = bv;
    index[row] = j;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int nns_class_reduce(const float* x, float* best, int* index, int n, int l,
                                long long row_stride, void* stream) {
  if (n <= 0 || l <= 0) return static_cast<int>(cudaErrorInvalidValue);
  class_reduce_kernel<<<(n + kRows - 1) / kRows, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, best, index, n, l, row_stride);
  return static_cast<int>(cudaGetLastError());
}
