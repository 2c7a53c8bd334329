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
// The comparisons are a few operations per byte read. What kept the first
// kernel (one thread a pixel, reading its own row) at 0.36 of that bound
// was latency: each thread made C dependent loads with an early exit, and
// neighbouring threads sat C words apart, so a warp load touched C lines.
//
// Design: every warp owns 32 / lanes whole pixels and asks for all of their
// logits at once, before any comparison, so the card has the whole input in
// flight; each warp then waits for its own pixels only, so the warps whose
// bytes land first scan while the rest are still arriving (with one copy and
// one wait a block, every scan came after the block's last byte: slower).
//   * "bulk" route (rows contiguous, row stride C): a warp's pixels are one
//     span of memory. Its 16-byte aligned body arrives by one cp.async.bulk
//     (TMA, 1D) into the warp's part of shared memory, completing on the
//     warp's own mbarrier; the at most three floats before and after that
//     body (a base off 16-byte alignment, as the batched path's per-frame
//     slices are, or the ragged end of the input) are read by plain loads
//     while the copy flies. The span sits in shared memory at the same
//     offset modulo 16 as in device memory.
//   * "row" route (strided rows, or a pixel wider than the staging budget,
//     C > 11772): no staging; the scan reads each row in place in device
//     memory (at C 21, one thread a pixel).
// The entry point alone chooses the route, the lanes a pixel and the warps
// a block, from C and the row stride (make_plan), and tells the caller the
// route it took. The scan reads shared memory (or, on the row route, device
// memory): `lanes` threads a pixel (1 at C 21, up to 32 for wide C), each
// over columns lane, lane + lanes, ... with no early exit (a
// NaN stays sticky: a float compare chain measured faster here than integer
// order keys, which cost more instructions a value), merged by a butterfly
// of shuffles. A row stride of C words is conflict-free for odd C. The
// palette is staged as one 32-bit word per entry while the logits are in
// flight, and each pixel's colour goes out as one 4-byte store
// (neighbouring threads on neighbouring words at lanes 1).
//
// The ids form is one id a thread, its load issued before the palette's so
// the two round trips overlap (4 ids a thread with 16-byte accesses is
// slower on the card; scripts/epilogue_ab.py times both).

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

enum Route : int { kBulk = 0, kRow = 1 };  // the codes nns_argmax_colorize reports

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
// floats the warps of a block stage together; with the palette and the
// barriers it stays under the 48 KB a block gets without asking
constexpr int kStageFloats = 11776;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kFill = 0xffffffffu;  // (255, 255, 255, 255)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory into
// 16-byte aligned shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Palette rows as little-endian words (the palette is 4-byte aligned):
// storing the word writes r, g, b, a. The caller synchronises the block.
__device__ __forceinline__ void stage_palette(const unsigned char* __restrict__ palette, int n,
                                              unsigned* spal) {
  const unsigned* words = reinterpret_cast<const unsigned*>(palette);
  for (int k = threadIdx.x; k < n; k += blockDim.x) spal[k] = __ldg(words + k);
}

// jnp.take(palette, cls) with the default fill mode
__device__ __forceinline__ unsigned lookup(const unsigned* spal, int n, long long cls) {
  if (cls < 0) cls += n;
  return (cls >= 0 && cls < n) ? spal[cls] : kFill;
}

// true when (v, j) should replace (b, bj): larger value, NaN over numbers,
// smaller index on a tie
__device__ __forceinline__ bool better(float v, int j, float b, int bj) {
  const bool vn = isnan(v);
  const bool bn = isnan(b);
  if (vn || bn) return vn && (!bn || j < bj);
  return v > b || (v == b && j < bj);
}

// floats one warp stages: its pixels' logits rounded up to 16 bytes, and 16
// bytes of room to keep their offset modulo 16
__host__ __device__ __forceinline__ long long warp_region(int c, int lanes) {
  return ((static_cast<long long>(32 / lanes) * c + 3) & ~3LL) + 4;
}

struct Plan {
  int route, lanes, warps;
};

// The fewest lanes a pixel (at most a warp) that keep a block of 8 warps
// within the staging budget (1 at C 21: 256 pixels, 21 KB), and as many
// warps as then fit (2 at C 4096). Contiguous rows go by the bulk route;
// strided rows, and pixels too wide to stage, by the row route, 8 warps a
// block.
Plan make_plan(int c, long long row_stride) {
  int lanes = 1;
  while (lanes < 32 && kMaxWarps * warp_region(c, lanes) > kStageFloats) lanes *= 2;
  const int warps = static_cast<int>(
      std::min<long long>(kMaxWarps, kStageFloats / warp_region(c, lanes)));
  if (row_stride == c && warps > 0) return {kBulk, lanes, warps};
  return {kRow, lanes, kMaxWarps};
}

template <int kRoute, int kLanes>
__global__ void __launch_bounds__(kMaxThreads)
    argmax_colorize_kernel(const float* __restrict__ x, const unsigned char* __restrict__ palette,
                           int n_palette, unsigned* __restrict__ out, long long p, int c,
                           long long row_stride) {
  constexpr int kPixels = 32 / kLanes;  // a warp's
  extern __shared__ float4 stage[];
  __shared__ unsigned spal[256];
  __shared__ __align__(8) unsigned long long bars[kMaxWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * kPixels;
  const int rows = static_cast<int>(max(0LL, min(static_cast<long long>(kPixels), p - first)));
  float* s = nullptr;
  bool wait = false;
  const uint32_t bar = smem_u32(&bars[warp]);

  if constexpr (kRoute == kBulk) {
    const float* src = x + first * c;
    const int count = rows * c;
    const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
    // s + k is 16-byte aligned exactly where src + k is
    s = reinterpret_cast<float*>(stage) + warp * warp_region(c, kLanes) + shift;
    const int head = min(count, (4 - shift) & 3);
    const int body = (count - head) & ~3;
    const int tail = count - head - body;
    wait = body > 0;
    if (lane == 0 && wait) {
      mbar_init(bar, 1);
      mbar_expect_tx(bar, body * 4);
      bulk_load(smem_u32(s + head), src + head, body * 4, bar);
    }
    if (lane < head + tail) {
      const int k = lane < head ? lane : body + lane;
      s[k] = src[k];
    }
  }
  stage_palette(palette, n_palette, spal);
  __syncwarp();
  if (wait) mbar_wait(bar, 0);

  const int g = lane % kLanes;
  const int px = lane / kLanes;
  const bool live = px < rows;
  const float* row = kRoute == kRow ? x + (first + px) * row_stride : s + px * c;
  float b = -INFINITY;
  int bj = INT_MAX;
  if (live && g < c) {
    b = row[g];
    bj = g;
#pragma unroll 4
    for (int j = g + kLanes; j < c; j += kLanes) {
      const float v = row[j];
      // no early exit: a NaN is final because nothing replaces it
      const bool take = !isnan(b) && (isnan(v) || v > b);
      b = take ? v : b;
      bj = take ? j : bj;
    }
  }
#pragma unroll
  for (int off = kLanes >> 1; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFullMask, b, off);
    const int oj = __shfl_xor_sync(kFullMask, bj, off);
    if (better(ob, oj, b, bj)) {
      b = ob;
      bj = oj;
    }
  }
  __syncthreads();  // the palette
  const unsigned word = lookup(spal, n_palette, bj);  // unconditionally, as in the ids form
  if (live && g == 0) out[first + px] = word;
}

template <int kRoute, int kLanes>
void launch_colorize(const float* x, const unsigned char* palette, int n_palette, unsigned* out,
                     long long p, int c, long long row_stride, int warps, cudaStream_t stream) {
  const long long per_block = static_cast<long long>(warps) * (32 / kLanes);
  const size_t smem =
      kRoute == kRow ? 0 : static_cast<size_t>(warps) * warp_region(c, kLanes) * sizeof(float);
  argmax_colorize_kernel<kRoute, kLanes>
      <<<static_cast<unsigned>((p + per_block - 1) / per_block), warps * 32, smem, stream>>>(
          x, palette, n_palette, out, p, c, row_stride);
}

template <int kRoute>
int launch_route(const float* x, const unsigned char* palette, int n_palette, unsigned* out,
                 long long p, int c, long long row_stride, int lanes, int warps,
                 cudaStream_t stream) {
  using Launch = void (*)(const float*, const unsigned char*, int, unsigned*, long long, int,
                          long long, int, cudaStream_t);
  Launch fn = nullptr;
  switch (lanes) {
    case 1: fn = launch_colorize<kRoute, 1>; break;
    case 2: fn = launch_colorize<kRoute, 2>; break;
    case 4: fn = launch_colorize<kRoute, 4>; break;
    case 8: fn = launch_colorize<kRoute, 8>; break;
    case 16: fn = launch_colorize<kRoute, 16>; break;
    case 32: fn = launch_colorize<kRoute, 32>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  fn(x, palette, n_palette, out, p, c, row_stride, warps, stream);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(kMaxThreads)
    colorize_ids_kernel(const int* __restrict__ ids, const unsigned char* __restrict__ palette,
                        int n_palette, unsigned* __restrict__ out, long long p) {
  __shared__ unsigned spal[256];
  const long long i = static_cast<long long>(blockIdx.x) * kMaxThreads + threadIdx.x;
  // the id first: its round trip overlaps the palette's
  const int cls = i < p ? ids[i] : 0;
  stage_palette(palette, n_palette, spal);
  __syncthreads();
  // looked up whether stored or not: under the branch the compiler reloads
  // the shared window's base after the barrier, on the critical path
  const unsigned word = lookup(spal, n_palette, cls);
  if (i < p) out[i] = word;
}

}  // namespace

// Each launches on `stream` and returns the cudaError_t of the launch
// (0 = success). `out` is (P, 4) uint8 and the palette (n, 4) uint8, both
// 4-byte aligned. nns_argmax_colorize writes the route it took to `*route`
// (0 bulk, 1 row).
extern "C" int nns_argmax_colorize(const float* x, const unsigned char* palette, int n_palette,
                                   unsigned char* out, long long p, int c, long long row_stride,
                                   int* route, void* stream) {
  if (p <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = make_plan(c, row_stride);
  *route = plan.route;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* o = reinterpret_cast<unsigned*>(out);
  if (plan.route == kBulk) {
    return launch_route<kBulk>(x, palette, n_palette, o, p, c, row_stride, plan.lanes,
                               plan.warps, st);
  }
  return launch_route<kRow>(x, palette, n_palette, o, p, c, row_stride, plan.lanes, plan.warps,
                            st);
}

extern "C" int nns_colorize_ids(const int* ids, const unsigned char* palette, int n_palette,
                                unsigned char* out, long long p, void* stream) {
  colorize_ids_kernel<<<static_cast<unsigned>((p + kMaxThreads - 1) / kMaxThreads), kMaxThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
      ids, palette, n_palette, reinterpret_cast<unsigned*>(out), p);
  return static_cast<int>(cudaGetLastError());
}
