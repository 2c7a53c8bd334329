// segment_colorize — per-pixel class argmax, then an RGBA palette lookup.
//
// Replaces the Pallas TPU kernels of nnstreamer_tpu/ops/pallas/epilogue.py
// segment_colorize: _argmax_colorize_kernel (logits form) and
// _colorize_kernel (pre-argmaxed class ids). Two entry points:
//
//   nns_argmax_colorize: (P, C) f32 logits with a row stride -> (P, 4) u8
//   nns_colorize_ids:    (P,) int32 class ids                -> (P, 4) u8
//
// Both take an (n, 4) uint8 palette (1 <= n <= 256) in device memory. On
// the segmentation path P = 257 * 257 pixels and C = 21 classes.
//
// Contract: the JAX package's segment_colorize_reference, i.e.
// jnp.take(palette, jnp.argmax(x, -1)) or jnp.take(palette, ids):
//   * first max wins ties; a pixel with any NaN takes its first NaN's class
//     (jnp.argmax treats NaN as the largest value); an all -inf pixel is 0;
//   * a class in [-n, -1] indexes from the end (-1 -> palette[n - 1]);
//   * any other class outside [0, n) yields (255, 255, 255, 255), the uint8
//     fill of jnp.take's default "fill" mode; so does an argmax class >= n.
// (The TPU kernel yields class C for a NaN pixel and (0, 0, 0, 0) for an
// out-of-range id; the reference, not the TPU kernel, is the contract.)
//
// Bound: device memory. The logits form reads P*C*4 bytes once and writes
// P*4 (plus the 1 KB palette): 5.8 MB at 257x257x21, 1.7 us at 3.35 TB/s.
// The comparisons are a few operations per byte read.
//
// Design (simple first): one thread per pixel, 256 threads a block. The
// palette is staged in shared memory as one 32-bit word per entry, so the
// lookup is a shared-memory read and the output one aligned 4-byte store per
// pixel (neighbouring threads on neighbouring words: coalesced). Each thread
// walks its own row of C logits; neighbouring threads' rows are contiguous
// in memory, so the block's loads share cache lines through L1. No padding
// of rows or of the palette is needed, where the TPU padded both to 128
// lanes and looked the palette up as a one-hot matrix product.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFill = 0xffffffffu;  // (255, 255, 255, 255)

// Palette rows as little-endian words: storing the word writes r, g, b, a.
__device__ __forceinline__ void stage_palette(const unsigned char* __restrict__ palette,
                                              int n, unsigned* spal) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const unsigned char* row = palette + 4 * k;
    spal[k] = static_cast<unsigned>(row[0]) | (static_cast<unsigned>(row[1]) << 8) |
              (static_cast<unsigned>(row[2]) << 16) | (static_cast<unsigned>(row[3]) << 24);
  }
  __syncthreads();
}

// jnp.take(palette, cls) with the default fill mode
__device__ __forceinline__ unsigned lookup(const unsigned* spal, int n, long long cls) {
  if (cls < 0) cls += n;
  return (cls >= 0 && cls < n) ? spal[cls] : kFill;
}

__global__ void argmax_colorize_kernel(const float* __restrict__ x,
                                       const unsigned char* __restrict__ palette,
                                       int n_palette, unsigned* __restrict__ out,
                                       long long p, int c, long long row_stride) {
  __shared__ unsigned spal[256];
  stage_palette(palette, n_palette, spal);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p) return;
  const float* row = x + i * row_stride;
  float best = row[0];
  int cls = 0;
  // a NaN is final: nothing later can replace the first NaN
  for (int j = 1; j < c && !isnan(best); ++j) {
    const float v = row[j];
    if (isnan(v) || v > best) {
      best = v;
      cls = j;
    }
  }
  out[i] = lookup(spal, n_palette, cls);
}

__global__ void colorize_ids_kernel(const int* __restrict__ ids,
                                    const unsigned char* __restrict__ palette,
                                    int n_palette, unsigned* __restrict__ out,
                                    long long p) {
  __shared__ unsigned spal[256];
  stage_palette(palette, n_palette, spal);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p) return;
  out[i] = lookup(spal, n_palette, ids[i]);
}

unsigned blocks_for(long long p) {
  return static_cast<unsigned>((p + kThreads - 1) / kThreads);
}

}  // namespace

// Each launches on `stream` and returns the cudaError_t of the launch
// (0 = success). `out` is (P, 4) uint8, 4-byte aligned (a fresh allocation).
extern "C" int nns_argmax_colorize(const float* x, const unsigned char* palette,
                                   int n_palette, unsigned char* out, long long p,
                                   int c, long long row_stride, void* stream) {
  argmax_colorize_kernel<<<blocks_for(p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, palette, n_palette, reinterpret_cast<unsigned*>(out), p, c, row_stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nns_colorize_ids(const int* ids, const unsigned char* palette,
                                int n_palette, unsigned char* out, long long p,
                                void* stream) {
  colorize_ids_kernel<<<blocks_for(p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, palette, n_palette, reinterpret_cast<unsigned*>(out), p);
  return static_cast<int>(cudaGetLastError());
}
