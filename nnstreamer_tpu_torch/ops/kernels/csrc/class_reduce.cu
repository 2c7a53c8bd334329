// class_reduce — per-row best class score and the first index attaining it.
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/epilogue.py
// class_reduce (_class_reduce_kernel): (N, L) f32 scores -> (N,) f32 max,
// (N,) int32 first argmax. On the SSD path N is the anchor count (2916 at
// 300x300) and L the class count less background (90).
//
// Bound: device memory. The function reads N*L*4 bytes once and writes N*8;
// the comparisons are a few operations per byte. At the slice's shape that is
// about 1.06 MB, a fraction of a microsecond at the H100's 3.35 TB/s, so the
// launch itself dominates the time.
//
// Design: one warp per row, eight rows per 256-thread block. The lanes stride
// over the L columns (neighbouring lanes on neighbouring addresses, so each
// row is read in coalesced 128-byte pieces) and keep a (value, index) pair;
// a butterfly of warp shuffles merges the pairs. On equal values the smaller
// index wins and a NaN beats every number (the first NaN wins among NaNs), so
// the result is jnp.argmax's first-max tie-break. The ragged edge is masked by
// the loop bound: there is no padding of rows to 128 lanes as the TPU needed.
// Rows may be strided (row_stride >= L) so the caller's (N, 91)[:, 1:] view is
// read in place with no copy.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// true when (v, j) should replace (b, bj): larger value, NaN over numbers,
// smaller index on a tie
__device__ __forceinline__ bool better(float v, int j, float b, int bj) {
  const bool vn = isnan(v);
  const bool bn = isnan(b);
  if (vn || bn) return vn && (!bn || j < bj);
  return v > b || (v == b && j < bj);
}

__global__ void class_reduce_kernel(const float* __restrict__ x,
                                    float* __restrict__ best,
                                    int* __restrict__ index, int n, int l,
                                    long long row_stride) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= n) return;  // uniform per warp: the shuffles below stay full-mask
  const float* xr = x + row * row_stride;
  float b = -INFINITY;
  int bj = INT_MAX;
  for (int j = lane; j < l; j += 32) {
    const float v = xr[j];
    if (better(v, j, b, bj)) {
      b = v;
      bj = j;
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float ob = __shfl_xor_sync(kFullMask, b, offset);
    const int oj = __shfl_xor_sync(kFullMask, bj, offset);
    if (better(ob, oj, b, bj)) {
      b = ob;
      bj = oj;
    }
  }
  if (lane == 0) {
    best[row] = b;
    index[row] = bj;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int nns_class_reduce(const float* x, float* best, int* index,
                                int n, int l, long long row_stride,
                                void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  class_reduce_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, best, index, n, l, row_stride);
  return static_cast<int>(cudaGetLastError());
}
