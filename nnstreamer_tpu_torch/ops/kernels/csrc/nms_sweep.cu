// nms_sweep — greedy NMS over K score-descending candidates.
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/epilogue.py
// nms_sweep (_nms_kernel): five (K,) f32 columns x0, y0, x1, y1, score ->
// (K,) f32 scores where a row is kept iff its score >= threshold and no
// earlier kept row overlaps it with IoU strictly above iou_threshold; every
// other row becomes -1. On the SSD path K is PRE_NMS_TOPK = 256.
//
// Bound: latency. The work is K*K IoUs (about 0.8 MFLOP at K = 256) on 24*K
// bytes, far below both roofs; what takes the time is the sweep, K steps that
// each depend on the one before.
//
// Design: one block, one thread per candidate (the wrapper checks K <= 512,
// so the block fits and the relation fits shared memory without opting into
// more than 48 KB).
//  1. The K boxes and their areas are staged in shared memory; a ballot per
//     warp packs the initial alive mask (score >= threshold) into K/32 words.
//  2. Thread i builds row i of the `suppresses` relation as a bitmask over the
//     later rows j > i (K*K bits: 8 KB at K = 256), all rows in parallel.
//  3. One warp runs the sweep with the alive mask in registers, one 32-bit
//     word per lane: step i broadcasts bit i with a shuffle and, if row i is
//     alive, every lane clears the bits row i suppresses. No block barrier
//     sits inside the K sequential steps, only a warp shuffle.
//  4. All threads write score or -1.
//
// The result is bit for bit nms_sweep_reference's: the IoU is built from
// round-to-nearest intrinsics in the reference's order (no FMA contraction of
// area or union) with an IEEE division, `union > 0 ? inter / union : 0`, and a
// strict `>` against the threshold. This file is compiled without fast math.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__global__ void nms_sweep_kernel(const float* __restrict__ x0,
                                 const float* __restrict__ y0,
                                 const float* __restrict__ x1,
                                 const float* __restrict__ y1,
                                 const float* __restrict__ score,
                                 float* __restrict__ out, int k,
                                 float iou_threshold, float threshold) {
  extern __shared__ unsigned char smem[];
  const int words = (k + 31) >> 5;
  float* sx0 = reinterpret_cast<float*>(smem);
  float* sy0 = sx0 + k;
  float* sx1 = sy0 + k;
  float* sy1 = sx1 + k;
  float* sarea = sy1 + k;
  uint32_t* suppresses = reinterpret_cast<uint32_t*>(sarea + k);  // k * words
  uint32_t* alive = suppresses + k * words;                       // words

  const int t = threadIdx.x;
  bool live = false;
  if (t < k) {
    const float a0 = x0[t], b0 = y0[t], a1 = x1[t], b1 = y1[t];
    sx0[t] = a0;
    sy0[t] = b0;
    sx1[t] = a1;
    sy1[t] = b1;
    sarea[t] = __fmul_rn(__fsub_rn(a1, a0), __fsub_rn(b1, b0));
    live = score[t] >= threshold;
  }
  // blockDim.x is a multiple of 32, so every warp is whole
  const uint32_t ballot = __ballot_sync(kFullMask, live);
  if ((t & 31) == 0 && (t >> 5) < words) alive[t >> 5] = ballot;
  __syncthreads();

  if (t < k) {
    const float ax0 = sx0[t], ay0 = sy0[t], ax1 = sx1[t], ay1 = sy1[t];
    const float area_t = sarea[t];
    for (int w = 0; w < words; ++w) {
      uint32_t bits = 0;
      for (int b = 0; b < 32; ++b) {
        const int j = (w << 5) + b;
        if (j <= t || j >= k) continue;
        const float ix = __fsub_rn(fminf(ax1, sx1[j]), fmaxf(ax0, sx0[j]));
        const float iy = __fsub_rn(fminf(ay1, sy1[j]), fmaxf(ay0, sy0[j]));
        const float inter = __fmul_rn(fmaxf(ix, 0.0f), fmaxf(iy, 0.0f));
        const float uni = __fsub_rn(__fadd_rn(area_t, sarea[j]), inter);
        const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
        if (iou > iou_threshold) bits |= 1u << b;
      }
      suppresses[t * words + w] = bits;
    }
  }
  __syncthreads();

  if (t < 32) {
    uint32_t mine = t < words ? alive[t] : 0u;
    for (int i = 0; i < k; ++i) {
      const uint32_t word = __shfl_sync(kFullMask, mine, i >> 5);
      if ((word >> (i & 31)) & 1u) {
        if (t < words) mine &= ~suppresses[i * words + t];
      }
    }
    if (t < words) alive[t] = mine;
  }
  __syncthreads();

  if (t < k) out[t] = ((alive[t >> 5] >> (t & 31)) & 1u) ? score[t] : -1.0f;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int nns_nms_sweep(const float* x0, const float* y0, const float* x1,
                             const float* y1, const float* score, float* out,
                             int k, float iou_threshold, float threshold,
                             void* stream) {
  const int words = (k + 31) / 32;
  const int threads = words * 32;
  const size_t shmem = sizeof(float) * 5 * k + sizeof(uint32_t) * (k * words + words);
  nms_sweep_kernel<<<1, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      x0, y0, x1, y1, score, out, k, iou_threshold, threshold);
  return static_cast<int>(cudaGetLastError());
}
