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
// Design: a thread-block cluster of C blocks per row (C from 1 to 8, the
// wrapper's choice: 8 at a decode step's R = 8, one block per row from
// R = 132; on the H100 a cluster of 8 ran R = 1 and R = 8 faster than one
// of 16, the non-portable size). Block j of a row's cluster owns a chunk of
// ceil(F / C) columns (rounded up to a multiple of 4) and computes g for it
// once, into registers: 256 threads, 16-byte loads of y and ws where F % 4
// == 0 (a scalar path otherwise), all issued before the first use, up to
// 16 columns a thread; columns past that (F / C above 4096) are
// recomputed in the second pass, as a block with no room must. A warp
// shuffle and a shared-memory step give the block's absmax; after
// cluster.sync() every warp reads all C partial maxima through
// distributed shared memory (lane j from block j) and computes the same scale
// (max is exact in any order, so the result stays bit-exact), requantizes
// from its registers, and waits at a second cluster barrier (arrived at
// right after its reads) so that no block exits while another still reads
// its shared memory. y is read once and
// every element's tanh computed once.

#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRegs = 16;  // columns a thread keeps in registers

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
__device__ __forceinline__ float dequant_gelu(int y, float xs, float ws, float c0, float c1) {
  const float h = rnd<kBf16>(__fmul_rn(__fmul_rn(static_cast<float>(y), xs), ws));
  return gelu_tanh<kBf16>(h, c0, c1);
}

__device__ __forceinline__ signed char requant(float g, float scale) {
  const float code = fminf(fmaxf(rintf(__fdiv_rn(g, scale)), -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(code));
}

// kVec columns a step: 4 (16-byte loads of y and ws, 4-byte stores of q) or 1
template <int kVec>
struct Cols;
template <>
struct Cols<4> {
  __device__ static void load(const int* y, const float* ws, int c, int (&yv)[4], float (&wv)[4]) {
    const int4 a = *reinterpret_cast<const int4*>(y + c);
    const float4 b = *reinterpret_cast<const float4*>(ws + c);
    yv[0] = a.x, yv[1] = a.y, yv[2] = a.z, yv[3] = a.w;
    wv[0] = b.x, wv[1] = b.y, wv[2] = b.z, wv[3] = b.w;
  }
  __device__ static void store(signed char* q, int c, const signed char (&qv)[4]) {
    *reinterpret_cast<char4*>(q + c) = make_char4(qv[0], qv[1], qv[2], qv[3]);
  }
};
template <>
struct Cols<1> {
  __device__ static void load(const int* y, const float* ws, int c, int (&yv)[1], float (&wv)[1]) {
    yv[0] = y[c];
    wv[0] = ws[c];
  }
  __device__ static void store(signed char* q, int c, const signed char (&qv)[1]) { q[c] = qv[0]; }
};

template <bool kBf16, int kVec>
__global__ void __launch_bounds__(kThreads)
dgr_kernel(const int* __restrict__ y, const float* __restrict__ xs,
           const float* __restrict__ ws, signed char* __restrict__ q,
           float* __restrict__ s, int f, int chunk, float c0, float c1) {
  namespace cg = cooperative_groups;
  constexpr int kSteps = kRegs / kVec;  // steps a thread keeps in registers
  __shared__ float warp_max[kThreads / 32];
  __shared__ float block_max;
  cg::cluster_group cluster = cg::this_cluster();
  const int nblocks = static_cast<int>(cluster.num_blocks());
  const long long r = blockIdx.x / nblocks;
  const int c_begin = static_cast<int>(cluster.block_rank()) * chunk;
  const int c_end = min(f, c_begin + chunk);
  const int steps = c_end > c_begin ? (c_end - c_begin) / kVec : 0;  // chunk, F % kVec == 0
  const int* yrow = y + r * f;
  signed char* qrow = q + r * f;
  const float xr = xs[r];

  // every load first, so that they are all in flight together
  int yv[kSteps][kVec];
  float wv[kSteps][kVec];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int step = threadIdx.x + i * kThreads;
    if (step < steps) Cols<kVec>::load(yrow, ws, c_begin + step * kVec, yv[i], wv[i]);
  }
  float g[kSteps][kVec];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    if (threadIdx.x + i * kThreads < steps) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        g[i][e] = dequant_gelu<kBf16>(yv[i][e], xr, wv[i][e], c0, c1);
        amax = fmaxf(amax, fabsf(g[i][e]));
      }
    }
  }
  for (int step = threadIdx.x + kSteps * kThreads; step < steps; step += kThreads) {
    int yv[kVec];
    float wv[kVec];
    Cols<kVec>::load(yrow, ws, c_begin + step * kVec, yv, wv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      amax = fmaxf(amax, fabsf(dequant_gelu<kBf16>(yv[e], xr, wv[e], c0, c1)));
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    block_max = m;
  }
  cluster.sync();  // every block's block_max is written
  // lane j of every warp reads block j's maximum (all C reads in flight at
  // once), then a warp shuffle gives each lane the row's
  const int lane = threadIdx.x & 31;
  amax = lane < nblocks ? *cluster.map_shared_rank(&block_max, lane) : 0.0f;
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  // this block is done reading the others' shared memory; it waits for
  // them to be done with its own only before it exits
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  const float scale = amax == 0.0f ? 1.0f : __fdiv_rn(amax, 127.0f);
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int step = threadIdx.x + i * kThreads;
    if (step < steps) {
      signed char qv[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) qv[e] = requant(g[i][e], scale);
      Cols<kVec>::store(qrow, c_begin + step * kVec, qv);
    }
  }
  for (int step = threadIdx.x + kSteps * kThreads; step < steps; step += kThreads) {
    int yv[kVec];
    float wv[kVec];
    Cols<kVec>::load(yrow, ws, c_begin + step * kVec, yv, wv);
    signed char qv[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      qv[e] = requant(dequant_gelu<kBf16>(yv[e], xr, wv[e], c0, c1), scale);
    }
    Cols<kVec>::store(qrow, c_begin + step * kVec, qv);
  }
  if (threadIdx.x == 0 && cluster.block_rank() == 0) s[r] = scale;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <bool kBf16, int kVec>
int launch(const int* y, const float* xs, const float* ws, signed char* q, float* s,
           long long rows, int f, int cluster, float c0, float c1, cudaStream_t stream) {
  auto kernel = dgr_kernel<kBf16, kVec>;
  // columns a block owns: a multiple of 4, so 16-byte loads stay aligned
  const int chunk = ((f + cluster - 1) / cluster + 3) / 4 * 4;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, y, xs, ws, q, s, f, chunk, c0, c1);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int dispatch(const int* y, const float* xs, const float* ws, signed char* q, float* s,
             long long rows, int f, int cluster, float c0, float c1, cudaStream_t stream) {
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ws) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0;
  return vec ? launch<kBf16, 4>(y, xs, ws, q, s, rows, f, cluster, c0, c1, stream)
             : launch<kBf16, 1>(y, xs, ws, q, s, rows, f, cluster, c0, c1, stream);
}

}  // namespace

// y (R, F) int32, xs (R,) f32, ws (F,) f32, all contiguous; writes q (R, F)
// int8 and s (R,) f32. out_bf16 selects bfloat16 as out_dtype; `cluster`
// (1 to 8) is the number of blocks that share a row. Launches on `stream`;
// returns the cudaError_t of the launch (0 = success).
extern "C" int nns_dequant_gelu_requant(const int* y, const float* xs, const float* ws,
                                        signed char* q, float* s, long long rows, int f,
                                        int cluster, int out_bf16, float c0, float c1,
                                        void* stream) {
  if (cluster < 1 || cluster > 8 || rows < 1 || f < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch<true>(y, xs, ws, q, s, rows, f, cluster, c0, c1, st)
                  : dispatch<false>(y, xs, ws, q, s, rows, f, cluster, c0, c1, st);
}
