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
// Design (simple first): a flat grid-stride loop. Each thread takes 16
// consecutive elements per step: one 16-byte load of uint8 (four of float32,
// two of bf16) and 16 outputs in 16-byte stores, so a warp moves whole
// 128-byte lines. Where a pointer is not 16-byte aligned (a view with an
// offset) the same loop loads and stores element by element. The last
// n % 16 elements go one to each of the first threads. Sizes are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;        // elements a thread handles per step
constexpr long long kMaxBlocks = 132 * 16;

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

// 16 consecutive inputs as float; vectorised when the pointer is aligned
template <typename T, bool kVec>
__device__ __forceinline__ void load16(const T* p, float (&v)[kPer]) {
  if constexpr (kVec) {
    constexpr int kWords = kPer * sizeof(T) / 16;  // 16-byte words
    alignas(16) T buf[kPer];
    const uint4* src = reinterpret_cast<const uint4*>(p);
    uint4* dst = reinterpret_cast<uint4*>(buf);
#pragma unroll
    for (int w = 0; w < kWords; ++w) dst[w] = src[w];
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = to_float<T>(buf[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = to_float<T>(p[i]);
  }
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

template <typename T, bool kVec>
__device__ __forceinline__ void store16(T* p, const float (&v)[kPer]) {
  if constexpr (kVec) {
    constexpr int kWords = kPer * sizeof(T) / 16;
    alignas(16) T buf[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) buf[i] = from_float<T>(v[i]);
    const uint4* src = reinterpret_cast<const uint4*>(buf);
    uint4* dst = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int w = 0; w < kWords; ++w) dst[w] = src[w];
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) p[i] = from_float<T>(v[i]);
  }
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

template <typename In, typename Out, bool kVec, typename Op>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(const In* __restrict__ x, Out* __restrict__ y, long long n, Op op) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long chunks = n / kPer;
  for (long long c = tid; c < chunks; c += stride) {
    float v[kPer];
    load16<In, kVec>(x + c * kPer, v);
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = op(v[i]);
    store16<Out, kVec>(y + c * kPer, v);
  }
  const long long t = chunks * kPer + tid;  // the tail: fewer than 16
  if (t < n) y[t] = from_float<Out>(op(to_float<In>(x[t])));
}

template <typename In, typename Out, typename Op>
int launch(const void* x, void* y, long long n, Op op, void* stream) {
  const long long chunks = (n + kPer - 1) / kPer;
  long long blocks = (chunks + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const In* xi = static_cast<const In*>(x);
  Out* yo = static_cast<Out*>(y);
  if (vec) {
    elementwise_kernel<In, Out, true, Op>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(xi, yo, n, op);
  } else {
    elementwise_kernel<In, Out, false, Op>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(xi, yo, n, op);
  }
  return static_cast<int>(cudaGetLastError());
}

// input type codes shared with the wrapper: 0 uint8, 1 float32, 2 bfloat16
template <typename Out, typename Op>
int dispatch_in(int in_type, const void* x, void* y, long long n, Op op, void* stream) {
  switch (in_type) {
    case 0: return launch<uint8_t, Out>(x, y, n, op, stream);
    case 1: return launch<float, Out>(x, y, n, op, stream);
    case 2: return launch<__nv_bfloat16, Out>(x, y, n, op, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: n contiguous elements of in_type (0 uint8, 1 float32, 2 bfloat16);
// y: n contiguous float32 (out_bf16 = 0) or bfloat16 (out_bf16 = 1).
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int nns_normalize_u8(const void* x, void* y, long long n, int in_type,
                                int out_bf16, float scale, float bias, void* stream) {
  const Normalize op{scale, bias};
  return out_bf16 ? dispatch_in<__nv_bfloat16>(in_type, x, y, n, op, stream)
                  : dispatch_in<float>(in_type, x, y, n, op, stream);
}

// x: n contiguous float32 (in_type 1) or bfloat16 (in_type 2); q: n uint8.
extern "C" int nns_quantize_affine(const void* x, void* q, long long n, int in_type,
                                   float scale, float zero_point, void* stream) {
  if (in_type != 1 && in_type != 2) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_in<uint8_t>(in_type, x, q, n, Quantize{scale, zero_point}, stream);
}
