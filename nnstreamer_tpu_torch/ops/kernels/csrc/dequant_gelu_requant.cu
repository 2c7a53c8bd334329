// dequant_gelu_requant — the w8a8 MLP's inner epilogue, int8 to int8.
//
// Replaces the Pallas TPU kernel of nnstreamer_tpu/ops/pallas/epilogue.py
// dequant_gelu_requant (_dgr_kernel). Per row r of the first GEMM's int32
// accumulator y (R, F):
//
//   h[c]  = out_dtype((float(y[r, c]) * xs[r]) * ws[c])
//   g[c]  = gelu_tanh(h[c]), every op in out_dtype (JAX's jax.nn.gelu):
//           x * (0.5 * (1 + tanh(c0 * (x + c1 * (x * (x * x))))))
//   s[r]  = absmax_c |float(g[c])| == 0 ? 1 : absmax / 127
//   q[r, c] = int8(clip(rint(float(g[c]) / s[r]), -127, 127))
//
// out_dtype is float32 or bfloat16; for bfloat16 every op rounds to bf16
// (round to nearest even) as a bf16 tensor op does. c0 = sqrt(2/pi) and
// c1 = 0.044715 come from the caller already rounded to out_dtype.
//
// Contract: bit-exact with dequant_gelu_requant_plain (the same formula in
// torch ops) on the card. Every multiply, add and divide is spelled with a
// _rn intrinsic, which the compiler never contracts into an FMA, and
// rounding is half to even (rintf), as torch.round and jnp.round. tanhf is
// the CUDA math library's, the one torch.tanh calls.
//
// Bound: device memory. At the serving shape F = 4096 the kernel reads
// R*F*4 + R*4 + F*4 bytes and writes R*F + R*4: 180,288 bytes at R = 8
// (0.054 us at 3.35 TB/s, so a launch costs more) and 10.5 MB at R = 512.
//
// Design (simple first): one block of 256 threads per row. Threads stride
// the F columns (neighbouring threads on neighbouring words), compute g and
// its absolute value, and a warp-shuffle then shared-memory reduction gives
// the row's absmax. The second pass recomputes g rather than keeping the
// row in shared memory: it costs one more tanh per element and no
// shared-memory limit on F.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  return kBf16 ? round_bf16(x) : x;
}

// jax.nn.gelu(approximate=True) in JAX's op order, each op rounded to the
// working type
template <bool kBf16>
__device__ __forceinline__ float gelu_tanh(float x, float c0, float c1) {
  const float x2 = rnd<kBf16>(__fmul_rn(x, x));
  const float x3 = rnd<kBf16>(__fmul_rn(x, x2));
  const float t = rnd<kBf16>(__fmul_rn(c1, x3));
  const float u = rnd<kBf16>(__fadd_rn(x, t));
  const float v = rnd<kBf16>(__fmul_rn(c0, u));
  const float th = rnd<kBf16>(tanhf(v));
  const float w = rnd<kBf16>(__fadd_rn(1.0f, th));
  const float cdf = rnd<kBf16>(__fmul_rn(0.5f, w));
  return rnd<kBf16>(__fmul_rn(x, cdf));
}

template <bool kBf16>
__device__ __forceinline__ float dequant_gelu(const int* __restrict__ yrow, float xs,
                                              const float* __restrict__ ws, int c,
                                              float c0, float c1) {
  const float h = rnd<kBf16>(__fmul_rn(__fmul_rn(static_cast<float>(yrow[c]), xs), ws[c]));
  return gelu_tanh<kBf16>(h, c0, c1);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
dgr_kernel(const int* __restrict__ y, const float* __restrict__ xs,
           const float* __restrict__ ws, signed char* __restrict__ q,
           float* __restrict__ s, int f, float c0, float c1) {
  __shared__ float warp_max[kThreads / 32];
  const long long r = blockIdx.x;
  const int* yrow = y + r * f;
  const float xr = xs[r];

  float amax = 0.0f;
  for (int c = threadIdx.x; c < f; c += kThreads) {
    amax = fmaxf(amax, fabsf(dequant_gelu<kBf16>(yrow, xr, ws, c, c0, c1)));
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float scale = amax == 0.0f ? 1.0f : __fdiv_rn(amax, 127.0f);
  signed char* qrow = q + r * f;
  for (int c = threadIdx.x; c < f; c += kThreads) {
    const float g = dequant_gelu<kBf16>(yrow, xr, ws, c, c0, c1);
    const float code = fminf(fmaxf(rintf(__fdiv_rn(g, scale)), -127.0f), 127.0f);
    qrow[c] = static_cast<signed char>(static_cast<int>(code));
  }
  if (threadIdx.x == 0) s[r] = scale;
}

}  // namespace

// y (R, F) int32, xs (R,) f32, ws (F,) f32, all contiguous; writes q (R, F)
// int8 and s (R,) f32. out_bf16 selects bfloat16 as out_dtype. Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int nns_dequant_gelu_requant(const int* y, const float* xs, const float* ws,
                                        signed char* q, float* s, long long rows, int f,
                                        int out_bf16, float c0, float c1, void* stream) {
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    dgr_kernel<true><<<grid, kThreads, 0, st>>>(y, xs, ws, q, s, f, c0, c1);
  } else {
    dgr_kernel<false><<<grid, kThreads, 0, st>>>(y, xs, ws, q, s, f, c0, c1);
  }
  return static_cast<int>(cudaGetLastError());
}
