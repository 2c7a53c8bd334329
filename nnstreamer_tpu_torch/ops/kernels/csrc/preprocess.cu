// normalize_u8 and quantize_affine — the stream prologue's elementwise kernels.
//
// Replace the Pallas TPU kernels of nnstreamer_tpu/ops/pallas/preprocess.py:
//
//   normalize_u8 (_normalize_kernel):  y = out_dtype(float(x) * scale + bias)
//   quantize_affine (_quantize_kernel): q = uint8(clip(rint(float(x) / scale)
//                                              + zero_point, 0, 255)), NaN -> 0
//
// Contract: bit-exact with normalize_u8_plain / quantize_affine_plain, which
// follow the JAX package's normalize_u8_reference / quantize_affine_reference
// (what the JAX pipeline computes off the TPU). So the multiply and the add
// are two rounded operations (__fmul_rn, __fadd_rn: the TPU body's contracted
// FMA gives other bits on 158 of the 256 uint8 values at scale 1/127.5), the
// quantizer divides (__fdiv_rn, IEEE division; the TPU body multiplies by the
// reciprocal, which moves some codes by one), rounding is half to even
// (rintf, as jnp.round and torch.round) and bf16 outputs round to nearest
// even (__float2bfloat16_rn, as torch's .to(bfloat16)). Built with
// -fmad=false besides.
//
// Bound: device memory. Each element is read once and written once:
// normalize_u8 moves 5 bytes an element to float32 and 3 to bf16 (a
// 1920x1080x3 frame: 9.28 and 5.57 us at 3.35 TB/s), quantize_affine 5 from
// float32.
//
// Design for the H100: one template serves both operations and every type
// pair.
//   * Contiguous bytes on both sides. A lane moves V elements an access,
//     V = 16 / (the wider element's size): 16 bytes on the wide side and
//     the matching 4 or 8 on the narrow one, so every warp-wide load and
//     store covers contiguous bytes (512 on the wide side).
//   * The card filled at every size. A tile is kThreads vectors, one a
//     thread. At large n the grid is persistent: the SM count times the
//     blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
//     queried once per instantiation and cached), and block b takes tiles
//     b, b + grid, b + 2 grid, ..., so the blocks' shares differ by at
//     most one tile and the tiles in flight at any moment lie side by side
//     in memory. A thread loads its vector of the block's next tile before
//     it converts and stores the current one, so a load is in flight while
//     it works. Below a tile per SM the tile is cut to whole warps so that
//     at least one block per SM runs (a 224x224x3 frame to float32: 147
//     blocks of 256 vectors, not 37).
//   * A misaligned view stays correct. When input and output sit at the
//     same element offset from their V-element alignment, the fewer than V
//     elements before the aligned body go by plain loads (block 0), as do
//     the fewer than V after it (the last block). Otherwise the same
//     kernel runs at V = 1: an element an access, still contiguous across
//     the warp.
// Sizes and offsets are 64-bit.
//
// Timed in turns against this design (scripts/epilogue_ab.py --only
// prologue; NVIDIA H100 80GB HBM3, 700 W; PERF.md) at 1920x1080x3,
// inputs from device memory, uint8 -> bf16 / uint8 -> float32 / float32 ->
// uint8: this design 6.40-6.55 / 9.79-9.88 / 11.06-11.09 us. The route
// through Hopper's bulk copies (a ring of 3 stages of 8 KB a persistent
// block: one thread brings each tile in by cp.async.bulk on its stage's
// mbarrier and stores the converted tile by cp.async.bulk from shared
// memory) took 6.51-6.54 / 9.67-9.75 / 13.67-13.72 us, and 1.88-2.36 us
// against 1.47-1.69 at 224x224x3: it lost. Slower too were each block
// taking one contiguous span, two or four vectors a thread a tile, the
// same tiles without the next tile's load in flight, and one tile a block
// with no persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // a tile's vectors
constexpr int kWarpVecs = 32;  // a cut tile is a multiple of one warp's vectors
constexpr int kMaxDevices = 64;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<uint8_t>(uint8_t v) { return static_cast<float>(v); }
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ uint8_t from_float<uint8_t>(float v) {
  return static_cast<uint8_t>(static_cast<int>(v));
}

struct Normalize {
  float scale, bias;
  __device__ __forceinline__ float operator()(float x) const {
    return __fadd_rn(__fmul_rn(x, scale), bias);
  }
};

struct Quantize {
  float scale, zero_point;
  __device__ __forceinline__ float operator()(float x) const {
    const float q = __fadd_rn(rintf(__fdiv_rn(x, scale)), zero_point);
    // NaN -> 0, then clip to the uint8 range; the store truncates an
    // integral value
    return isnan(q) ? 0.0f : fminf(fmaxf(q, 0.0f), 255.0f);
  }
};

// V elements moved by one access of V * sizeof(T) bytes
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// elements a lane moves an access on the vector path
template <typename In, typename Out>
constexpr int vector_width() {
  return 16 / (sizeof(In) > sizeof(Out) ? sizeof(In) : sizeof(Out));
}

template <typename In, typename Out, typename Op>
__device__ __forceinline__ void one(const In* x, Out* y, long long i, Op op) {
  y[i] = from_float<Out>(op(to_float<In>(x[i])));
}

// x[head, head + vecs * V) as `vecs` V-element vectors, aligned to V
// elements on both sides, in tiles of `tile` vectors (at most kThreads):
// block b takes tiles b, b + gridDim.x, ...; block 0 also takes x[0, head)
// and the last block x[head + vecs * V, n), each fewer than V elements
template <typename In, typename Out, int V, typename Op>
__global__ void __launch_bounds__(kThreads)
span_kernel(const In* __restrict__ x, Out* __restrict__ y, long long head, long long vecs,
            long long n, int tile, Op op) {
  using InPack = Pack<In, V>;
  using OutPack = Pack<Out, V>;
  const InPack* __restrict__ xv = reinterpret_cast<const InPack*>(x + head);
  OutPack* __restrict__ yv = reinterpret_cast<OutPack*>(y + head);
  // the loop runs over tiles, uniform across the block; lanes past a cut
  // tile or past the end are masked inside it
  const int j = threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * tile;
  long long base = static_cast<long long>(blockIdx.x) * tile;
  InPack cur, next;
  if (j < tile && base + j < vecs) cur = xv[base + j];
  for (; base < vecs; base += step) {
    if (j < tile && base + step + j < vecs) next = xv[base + step + j];  // in flight meanwhile
    if (j < tile && base + j < vecs) {
      OutPack out;
#pragma unroll
      for (int k = 0; k < V; ++k) out.v[k] = from_float<Out>(op(to_float<In>(cur.v[k])));
      yv[base + j] = out;
    }
    cur = next;
  }
  if (blockIdx.x == 0 && threadIdx.x < head) one(x, y, threadIdx.x, op);
  const long long body_end = head + vecs * V;
  if (blockIdx.x == gridDim.x - 1 && body_end + threadIdx.x < n)
    one(x, y, body_end + threadIdx.x, op);
}

// The persistent grid of span_kernel<In, Out, V, Op> on the current device
// (its SM count times the blocks an SM holds, both queried once and cached)
// and the SM count.
struct Grid {
  long long cap;
  int sms;
};

template <typename In, typename Out, int V, typename Op>
cudaError_t persistent_grid(Grid* grid) {
  static int per_sm = 0;
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm == 0) {
    int b = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, span_kernel<In, Out, V, Op>,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    per_sm = b < 1 ? 1 : b;
  }
  if (sm_count[dev] == 0) {
    int s = 0;
    err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev] = s < 1 ? 1 : s;
  }
  *grid = Grid{static_cast<long long>(per_sm) * sm_count[dev], sm_count[dev]};
  return cudaSuccess;
}

// One block a tile, at most the persistent grid; below a tile per SM the
// tile is cut to whole warps so that each SM gets a block.
template <typename In, typename Out, int V, typename Op>
int launch_span(const In* x, Out* y, long long head, long long n, Op op, cudaStream_t st) {
  Grid grid{};
  const cudaError_t err = persistent_grid<In, Out, V, Op>(&grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vecs = (n - head) / V;
  const long long cut = vecs / grid.sms / kWarpVecs * kWarpVecs;
  const long long tile = cut < kWarpVecs ? kWarpVecs : (cut < kThreads ? cut : kThreads);
  long long blocks = (vecs + tile - 1) / tile;
  blocks = blocks > grid.cap ? grid.cap : blocks;
  blocks = blocks < 1 ? 1 : blocks;
  span_kernel<In, Out, V, Op><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      x, y, head, vecs, n, static_cast<int>(tile), op);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, typename Out, typename Op>
int launch(const void* xp, void* yp, long long n, Op op, void* stream) {
  constexpr int V = vector_width<In, Out>();
  const In* x = static_cast<const In*>(xp);
  Out* y = static_cast<Out*>(yp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(xp);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(yp);
  // each pointer's offset in elements from its V-element alignment
  const bool whole = xa % sizeof(In) == 0 && ya % sizeof(Out) == 0;
  const long long xoff = static_cast<long long>(xa / sizeof(In) % V);
  const long long yoff = static_cast<long long>(ya / sizeof(Out) % V);
  if (!whole || xoff != yoff) return launch_span<In, Out, 1>(x, y, 0, n, op, st);
  long long head = (V - xoff) % V;
  head = head > n ? n : head;
  return launch_span<In, Out, V>(x, y, head, n, op, st);
}

template <typename In, typename Out, typename Op>
int tiling(long long* out) {
  constexpr int V = vector_width<In, Out>();
  Grid grid{};
  const cudaError_t err = persistent_grid<In, Out, V, Op>(&grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = V;
  out[1] = static_cast<long long>(kThreads) * V;
  out[2] = grid.cap;
  return 0;
}

// f(In()) for input type code in_type (0 uint8, 1 float32, 2 bfloat16, as
// the wrapper passes); uint8 only where kU8
template <bool kU8, typename F>
int by_input(int in_type, F f) {
  switch (in_type) {
    case 0:
      if constexpr (kU8) return f(uint8_t{});
      break;
    case 1: return f(float{});
    case 2: return f(__nv_bfloat16{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: n contiguous elements of in_type (0 uint8, 1 float32, 2 bfloat16);
// y: n contiguous float32 (out_bf16 = 0) or bfloat16 (out_bf16 = 1).
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int nns_normalize_u8(const void* x, void* y, long long n, int in_type,
                                int out_bf16, float scale, float bias, void* stream) {
  const Normalize op{scale, bias};
  return by_input<true>(in_type, [&](auto in) {
    using In = decltype(in);
    return out_bf16 ? launch<In, __nv_bfloat16>(x, y, n, op, stream)
                    : launch<In, float>(x, y, n, op, stream);
  });
}

// x: n contiguous float32 (in_type 1) or bfloat16 (in_type 2); q: n uint8.
extern "C" int nns_quantize_affine(const void* x, void* q, long long n, int in_type,
                                   float scale, float zero_point, void* stream) {
  const Quantize op{scale, zero_point};
  return by_input<false>(in_type, [&](auto in) {
    return launch<decltype(in), uint8_t>(x, q, n, op, stream);
  });
}

// The vector path's tiling for in_type to out_type (0 uint8: quantize;
// 1 float32 or 2 bfloat16: normalize) on the current device: out[0] the
// elements a lane moves an access, out[1] a whole tile's elements, out[2]
// the blocks of the persistent grid. Returns a cudaError_t.
extern "C" int nns_preprocess_tiling(int in_type, int out_type, long long* out) {
  switch (out_type) {
    case 0:
      return by_input<false>(in_type, [&](auto in) {
        return tiling<decltype(in), uint8_t, Quantize>(out);
      });
    case 1:
      return by_input<true>(in_type, [&](auto in) {
        return tiling<decltype(in), float, Normalize>(out);
      });
    case 2:
      return by_input<true>(in_type, [&](auto in) {
        return tiling<decltype(in), __nv_bfloat16, Normalize>(out);
      });
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
