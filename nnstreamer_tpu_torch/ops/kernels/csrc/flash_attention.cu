// flash_attention — blockwise online-softmax attention, causal or full.
//
// Replaces the Pallas TPU kernels of nnstreamer_tpu/ops/pallas/
// flash_attention.py flash_attention: _flash_kernel (normalised output) and
// _flash_kernel_residual (unnormalised accumulator plus the per-row softmax
// max m and normaliser l). Two entry points:
//
//   nns_flash_attention:          q, k, v (B, H, L, D) -> o (B, H, L, D)
//   nns_flash_attention_residual: q, k, v (B, H, L, D) -> acc (B, H, L, D) f32,
//                                                         m, l (B, H, L) f32
//
// q, k and v are float32 or bfloat16 (all three the same), D <= 128, any L;
// the head axis D is contiguous and the B, H and L strides are free (the
// causal LM passes its split-heads views without a copy). o is q's dtype,
// contiguous.
//
// Contract (the TPU kernel's precision model): scores q.k and the output
// accumulate in float32; the scale 1/sqrt(D) multiplies the scores after
// the product; a masked score (a key >= L, or above the diagonal when
// causal) is -1e30, finite, and the running max starts at -1e30; the
// softmax weights p are rounded to v's dtype before the PV product, while
// l sums them before that rounding; the output is acc / max(l, 1e-30).
//
// Bound, at the flash prefill's (8, 16, 1024, 64) bf16 causal: 67.1 MB of
// q, k, v and o (20.0 us at 3.35 TB/s) against 17.2 GFLOP (17.4 us at
// 989 TFLOP/s on bf16 tensor cores). This kernel runs on the CUDA cores in
// float32 (67 TFLOP/s: 256 us for the same FLOPs): a simple kernel first;
// wgmma and TMA are a later step.
//
// Design: grid (B*H, ceil(L/64)). A block of 256 threads (8 warps) owns 64
// query rows, 8 per warp, and loops over 64-key tiles up to its causal
// bound (the TPU walked a sequential grid axis; here the loop is inside
// the block and stops at the diagonal). Q, K, V and the block's softmax
// weights P sit in shared memory as float32, with D padded to DP (16, 32,
// 64 or 128) by zeros. For the scores each lane owns keys lane and
// lane + 32 of the tile for its warp's 8 rows and reads Q and K as float4
// (K rows are DP + 4 floats apart, so the lanes' rows fall in distinct
// banks); for PV each lane owns head columns lane + 32 i and reads P as
// float4 broadcasts. Row max and sum are warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;     // query rows per block
constexpr int kBK = 64;     // keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;  // query rows per warp
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "stage() moves kBK rows for Q as for K and V");

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;       // normalised output (q's dtype), or the f32 accumulator
  float* m_out;  // residual mode only
  float* l_out;
  int h, len, d;
  long long sqb, sqh, sql, skb, skh, skl, svb, svh, svl;
  int causal;
  float scale;
};

// Stage rows [row0, row0 + rows) of one head's (L, D) slice into `dst`
// (row stride `ld` floats), zero past L and past D.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, long long sl,
                                      int row0, int len, int d) {
  for (int i = threadIdx.x; i < kBK * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int row = row0 + r;
    dst[r * ld + c] = (row < len && c < d) ? load_f(src + row * sl + c) : 0.0f;
  }
}

template <typename T, int DP, bool kResidual>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  constexpr int kLdK = DP + 4;
  constexpr int kDL = (DP + 31) / 32;  // head columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][DP]
  float* ks = qs + kBQ * DP;                    // [kBK][DP + 4]
  float* vs = ks + kBK * kLdK;                  // [kBK][DP]
  float* ps = vs + kBK * DP;                    // [kBQ][kBK]

  const int bh = blockIdx.x;
  const int b = bh / a.h, hh = bh % a.h;
  const int q0 = blockIdx.y * kBQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* qp = static_cast<const T*>(a.q) + b * a.sqb + hh * a.sqh;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hh * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hh * a.svh;

  stage<T, DP>(qs, DP, qp, a.sql, q0, a.len, a.d);

  float m[kRows], l[kRows], acc[kRows][kDL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kDL; ++i) acc[r][i] = 0.0f;
  }

  const int kend = a.causal ? min(a.len, q0 + kBQ) : a.len;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<T, DP>(ks, kLdK, kp, a.skl, k0, a.len, a.d);
    stage<T, DP>(vs, DP, vp, a.svl, k0, a.len, a.d);
    __syncthreads();

    // scores for this warp's rows against keys lane and lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll 4
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 ka = *reinterpret_cast<const float4*>(ks + lane * kLdK + 4 * d4);
      const float4 kb = *reinterpret_cast<const float4*>(ks + (lane + 32) * kLdK + 4 * d4);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (warp * kRows + r) * DP + 4 * d4);
        s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qv.x, kb.x, s[r][1]);
        s[r][1] = fmaf(qv.y, kb.y, s[r][1]);
        s[r][1] = fmaf(qv.z, kb.z, s[r][1]);
        s[r][1] = fmaf(qv.w, kb.w, s[r][1]);
      }
    }

    // online softmax update, one row at a time across the warp
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + warp * kRows + r;
      float sc[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = k0 + lane + 32 * c;
        const bool valid = col < a.len && (!a.causal || row >= col);
        sc[c] = valid ? s[r][c] * a.scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sc[0], sc[1])));
      const float p0 = expf(sc[0] - m_new);
      const float p1 = expf(sc[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      ps[(warp * kRows + r) * kBK + lane] = round_to<T>(p0);
      ps[(warp * kRows + r) * kBK + lane + 32] = round_to<T>(p1);
#pragma unroll
      for (int i = 0; i < kDL; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();

    // acc += P V over the tile's keys
#pragma unroll 2
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      float vv[4][kDL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < kDL; ++i) {
          const int col = lane + 32 * i;
          vv[jj][i] = col < DP ? vs[(4 * j4 + jj) * DP + col] : 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(ps + (warp * kRows + r) * kBK + 4 * j4);
#pragma unroll
        for (int i = 0; i < kDL; ++i) {
          acc[r][i] = fmaf(p.x, vv[0][i], acc[r][i]);
          acc[r][i] = fmaf(p.y, vv[1][i], acc[r][i]);
          acc[r][i] = fmaf(p.z, vv[2][i], acc[r][i]);
          acc[r][i] = fmaf(p.w, vv[3][i], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= a.len) continue;
    const long long base = (static_cast<long long>(bh) * a.len + row) * a.d;
#pragma unroll
    for (int i = 0; i < kDL; ++i) {
      const int col = lane + 32 * i;
      if (col >= a.d) continue;
      if (kResidual) {
        static_cast<float*>(a.o)[base + col] = acc[r][i];
      } else {
        store_f(static_cast<T*>(a.o) + base + col, acc[r][i] / fmaxf(l[r], 1e-30f));
      }
    }
    if (kResidual && lane == 0) {
      a.m_out[static_cast<long long>(bh) * a.len + row] = m[r];
      a.l_out[static_cast<long long>(bh) * a.len + row] = l[r];
    }
  }
}

template <typename T, int DP, bool kResidual>
int launch(const Args& a, int batch_heads, cudaStream_t stream) {
  constexpr int kSmem = (kBQ * DP + kBK * (DP + 4) + kBK * DP + kBQ * kBK) * 4;
  auto kernel = flash_kernel<T, DP, kResidual>;
  static bool smem_set = false;  // once per instantiation (above 48 KB needs it)
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid(static_cast<unsigned>(batch_heads), static_cast<unsigned>((a.len + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kResidual>
int dispatch(const Args& a, int batch_heads, cudaStream_t stream) {
  if (a.d <= 16) return launch<T, 16, kResidual>(a, batch_heads, stream);
  if (a.d <= 32) return launch<T, 32, kResidual>(a, batch_heads, stream);
  if (a.d <= 64) return launch<T, 64, kResidual>(a, batch_heads, stream);
  return launch<T, 128, kResidual>(a, batch_heads, stream);
}

int run(const void* q, const void* k, const void* v, void* o, float* m_out, float* l_out,
        int batch, int heads, int len, int d, const long long* strides, int causal, float scale,
        int is_bf16, void* stream) {
  if (d < 1 || d > 128 || len < 1 || batch < 1 || heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, o, m_out, l_out, heads, len, d,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  const bool residual = m_out != nullptr;
  if (is_bf16) {
    return residual ? dispatch<__nv_bfloat16, true>(a, bh, st)
                    : dispatch<__nv_bfloat16, false>(a, bh, st);
  }
  return residual ? dispatch<float, true>(a, bh, st) : dispatch<float, false>(a, bh, st);
}

}  // namespace

// strides: 9 element strides, (B, H, L) of q, then of k, then of v. Each
// launches on `stream` and returns the cudaError_t of the launch (0 =
// success; cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int nns_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int batch, int heads, int len, int d,
                                   const long long* strides, int causal, float scale,
                                   int is_bf16, void* stream) {
  return run(q, k, v, o, nullptr, nullptr, batch, heads, len, d, strides, causal, scale,
             is_bf16, stream);
}

extern "C" int nns_flash_attention_residual(const void* q, const void* k, const void* v,
                                            float* acc, float* m_out, float* l_out, int batch,
                                            int heads, int len, int d,
                                            const long long* strides, int causal, float scale,
                                            int is_bf16, void* stream) {
  return run(q, k, v, acc, m_out, l_out, batch, heads, len, d, strides, causal, scale, is_bf16,
             stream);
}
