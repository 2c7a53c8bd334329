// flash_attention — blockwise online-softmax attention, causal or full.
//
// Replaces the Pallas TPU kernels of nnstreamer_tpu/ops/pallas/
// flash_attention.py flash_attention: _flash_kernel (normalised output) and
// _flash_kernel_residual (unnormalised accumulator plus the per-row softmax
// max m and normaliser l). Two routes, each with a normalised and a residual
// entry:
//
//   nns_flash_attention / nns_flash_attention_residual (the SIMT route):
//     q, k, v (B, H, L, D) float32 or bfloat16, D <= 128, any L;
//   nns_flash_attention_wgmma (the wgmma route; residual when m_out is given):
//     q, k, v (B, H, L, D) bfloat16, D 64 or 128, any L, each a 16-byte
//     aligned base with B, H and L strides multiples of 8 elements (TMA's
//     rules; the wrapper copies a tensor that breaks them).
//
//   outputs: o (B, H, L, D) in q's dtype, or acc (B, H, L, D) f32 and
//   m, l (B, H, L) f32; all contiguous.
//
// The head axis D is contiguous and the B, H and L strides are free (the
// causal LM passes its split-heads views without a copy).
//
// Contract (the TPU kernel's precision model): scores q.k and the output
// accumulate in float32; the scale 1/sqrt(D) multiplies the scores after
// the product; a masked score (a key >= L, or above the diagonal when
// causal) is -1e30, finite, and the running max starts at -1e30; the
// softmax weights p are rounded to v's dtype before the PV product, while
// l sums them before that rounding; the output is acc / max(l, 1e-30).
// The tensor cores keep it: a bf16 x bf16 product is exact in float32 and
// wgmma accumulates in float32; only the order of the sums differs.
//
// Bound, at the flash prefill's (8, 16, 1024, 64) bf16 causal: 67.1 MB of
// q, k, v and o (20.0 us at 3.35 TB/s) against 17.2 GFLOP (17.4 us at
// 989 TFLOP/s on bf16 tensor cores).
//
// SIMT route (float32, and bf16 at other D): grid (B*H, ceil(L/64)). A
// block of 256 threads (8 warps) owns 64 query rows, 8 per warp, and loops
// over 64-key tiles up to its causal bound (the TPU walked a sequential
// grid axis; here the loop is inside the block and stops at the diagonal).
// Q, K, V and the block's softmax weights P sit in shared memory as
// float32, with D padded to DP (16, 32, 64 or 128) by zeros. For the scores
// each lane owns keys lane and lane + 32 of the tile for its warp's 8 rows
// and reads Q and K as float4 (K rows are DP + 4 floats apart, so the
// lanes' rows fall in distinct banks); for PV each lane owns head columns
// lane + 32 i and reads P as float4 broadcasts. Row max and sum are warp
// shuffles. Both products run as float32 FMAs on the CUDA cores (67
// TFLOP/s: 256 us for the prefill's FLOPs at best).
//
// wgmma route (bf16, D 64 or 128): the products run on the tensor cores.
// Grid (B*H, ceil(L/128)), the heaviest causal query blocks issued first.
// A block of 288 threads: two consumer warpgroups of 64 query rows each
// (wgmma's M) and one producer warp. The producer's lane 0 loads the
// block's Q tile once and then K and V tiles of BK keys (128 at D 64, 64
// at D 128) by TMA into a ring of 3 stages; each stage has a full and an
// empty mbarrier, and expect_tx counts the whole box, the zeros TMA fills
// past L included. Every tile is 128-byte swizzled and 1024-byte aligned,
// in 64-column chunks (one 128-byte swizzle row each; D 128 is two). Per
// tile a consumer warpgroup runs S = Q.K^T as wgmma with both operands in
// shared memory, K-major; the online softmax in registers on the
// accumulator fragment (each row's max and sum over the 4 lanes that hold
// it); then O += P.V as wgmma with P as bf16 pairs in registers (the
// accumulator fragment is the A fragment) and V MN-major from shared
// memory through the transpose bit. The loop is software-pipelined: tile
// i's S is issued before tile i - 1's P.V, so tile i's softmax runs while
// the tensor cores finish P.V. Masking runs only on tiles that touch the
// diagonal or the ragged tail, and each warpgroup skips the tiles past its
// own diagonal (it still releases their stage).
//
// Debugging note: a wgmma descriptor that does not match the TMA swizzle
// gives wrong numbers, not a fault; the card tests hold every shape
// against the plain version.

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// The wgmma route: bf16, D 64 or 128
// ---------------------------------------------------------------------------

namespace {

constexpr int kWgRows = 128;                 // query rows per block
constexpr int kWgConsumers = 256;            // two consumer warpgroups
constexpr int kWgThreads = kWgConsumers + 32;  // and one producer warp
constexpr int kWgStages = 3;                 // K/V ring depth
constexpr int kSwizzleRow = 128;             // bytes in a 128-byte-swizzled row (64 bf16)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMinusInf = -__builtin_huge_valf();

// keys per K/V tile: 128 at D 64, 64 at D 128 (the S and O fragments then
// fit the registers: 64 + 32 or 32 + 64 floats a thread)
template <int D>
struct WgTile {
  static constexpr int kBK = D == 64 ? 128 : 64;
  static constexpr int kChunks = D / 64;                       // 64-column chunks
  static constexpr int kQBytes = kWgRows * D * 2;              // Q tile
  static constexpr int kKVBytes = kBK * D * 2;                 // one K (or V) tile
  static constexpr int kBarOffset = kQBytes + kWgStages * 2 * kKVBytes;
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kWgStages) + 1024;  // + alignment
};

struct WgArgs {
  void* o;       // normalised output (bf16), or the f32 accumulator
  float* m_out;  // residual mode only
  float* l_out;
  int h, len, causal;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// one box of a rank-4 (D, L, H, B) tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B. K-major (Q, K): the stride offset steps 8 rows (1024 bytes),
// the leading offset is unused. MN-major (V): the stride offset steps 8 keys
// (1024 bytes), the leading offset steps one 64-column chunk.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x (ex2.approx: 2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 64) (+)= A (64 x 16, shared, K-major) . B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, "
      "0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) (+)= A (64 x 16, shared, K-major) . B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, "
      "0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p,"
      " 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// d (64 x 128) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p,"
      " 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else {
    wgmma_ss_n128(d, da, db, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// the rows a consumer thread holds, and what masks their scores
struct SoftmaxRows {
  int len, causal;
  int r, cq;   // first fragment row (the second is r + 8), column offset in an 8-column group
  int row0;    // the warpgroup's first row
  float scale;
};

// S = Q K^T for one tile, issued (not waited): D / 16 steps of 16 columns,
// 32 bytes apart inside a 128-byte swizzle row, a new 64-column chunk every 4
template <int D, int BK>
__device__ __forceinline__ void issue_s(float* sc, uint32_t sq_wg, uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = sw128_desc(sq_wg + (kk / 4) * kWgRows * kSwizzleRow + off, 16, 1024);
    const uint64_t db = sw128_desc(sk + (kk / 4) * BK * kSwizzleRow + off, 16, 1024);
    wgmma_ss<BK>(sc, da, db, kk > 0);
  }
}

// O += P V for one tile, issued: BK / 16 steps of 16 keys (16 rows of V,
// 2048 bytes); V is MN-major, its 64-column chunks BK * 128 bytes apart
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* pa, uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs<D>(o, pa + 4 * kk, sw128_desc(sv + kk * 16 * kSwizzleRow, BK * kSwizzleRow, 1024));
  }
}

// The online softmax on one tile's scores (keys k0 .. k0 + BK - 1), in
// place: sc becomes p, m and l move on, alpha is the factor the running
// output takes. Masking runs only on tiles at the diagonal or the ragged
// tail; a masked score is -inf here, so it weighs 0, and the scale is
// positive, so max(s) * scale is max(s * scale). p = exp(s * scale - m) =
// 2^(s * scale * log2 e - m * log2 e): one FMA and one ex2 a score. Row max
// and sum reduce over the 4 lanes that hold a row; l stays this thread's
// share until the epilogue.
template <int BK>
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l, float* alpha, int k0,
                                             const SoftmaxRows& w) {
  const bool edge = k0 + BK > w.len || (w.causal && k0 + BK - 1 > w.row0);
  float mx[2] = {kMinusInf, kMinusInf};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int hr = (e >> 1) & 1;
    if (edge) {
      const int col = k0 + 8 * (e >> 2) + w.cq + (e & 1);
      if (col >= w.len || (w.causal && col > w.r + 8 * hr)) sc[e] = kMinusInf;
    }
    mx[hr] = fmaxf(mx[hr], sc[e]);
  }
  const float c = w.scale * kLog2e;
  float mb[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float m_new = fmaxf(m[hr], mx[hr] * w.scale);  // the -1e30 floor stays
    alpha[hr] = ex2((m[hr] - m_new) * kLog2e);
    m[hr] = m_new;
    mb[hr] = m_new * kLog2e;
    l[hr] *= alpha[hr];
  }
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int hr = (e >> 1) & 1;
    const float p = ex2(fmaf(sc[e], c, -mb[hr]));
    l[hr] += p;
    sc[e] = p;
  }
}

// p as bf16 pairs: the S fragment of 16 keys is the A fragment of the P V step
template <int BK>
__device__ __forceinline__ void pack_p(const float* sc, uint32_t* pa) {
#pragma unroll
  for (int e = 0; e < BK / 4; ++e) pa[e] = pack_bf16(sc[2 * e], sc[2 * e + 1]);
}

template <int D, bool kResidual>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, WgArgs a) {
  using T = WgTile<D>;
  constexpr int BK = T::kBK;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzled tiles: 1024-aligned
  const uint32_t q_full = sq + T::kBarOffset;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kWgStages;
  auto k_tile = [&](int s) { return sq + T::kQBytes + s * 2 * T::kKVBytes; };

  const int bh = blockIdx.x;
  const int b = bh / a.h, hh = bh % a.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWgRows;  // heaviest causal blocks first
  const int kend = a.causal ? min(a.len, q0 + kWgRows) : a.len;
  const int ntiles = (kend + BK - 1) / BK;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWgConsumers / 32) {
    // producer: Q once, then the K/V ring
    if ((threadIdx.x & 31) == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(sq + c * kWgRows * kSwizzleRow, &tq, q_full, 64 * c, q0, hh, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kWgStages;
        mbar_wait(empty0 + 8 * s, ((i / kWgStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * T::kKVBytes);
        const uint32_t sk = k_tile(s), sv = sk + T::kKVBytes;
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(sk + c * BK * kSwizzleRow, &tk, full0 + 8 * s, 64 * c, i * BK, hh, b);
          tma_load(sv + c * BK * kSwizzleRow, &tv, full0 + 8 * s, 64 * c, i * BK, hh, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows row0 .. row0 + 63; this thread holds
  // the fragment rows r and r + 8, columns 8 j + cq and 8 j + cq + 1
  const int wg = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int row0 = q0 + wg * 64;
  const int r = row0 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int wend = a.causal ? min(a.len, row0 + 64) : a.len;  // keys this warpgroup needs
  const int nw = (wend + BK - 1) / BK;  // tiles it computes; it only releases the rest
  const uint32_t sq_wg = sq + wg * 64 * kSwizzleRow;

  float o[D / 2], sc[BK / 2], alpha[2];
  uint32_t pa[BK / 4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
  const SoftmaxRows rows{a.len, a.causal, r, cq, row0, a.scale};

  // Software pipeline: while the tensor cores run tile i - 1's P V, the
  // warpgroup runs tile i's softmax (S_i is issued first, so waiting for
  // all but the newest group leaves exactly P V in flight).
  mbar_wait(q_full, 0);
  mbar_wait(full0, 0);
  fence_regs<BK / 2>(sc);
  wgmma_fence();
  issue_s<D, BK>(sc, sq_wg, k_tile(0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<BK / 2>(sc);
  softmax_tile<BK>(sc, m, l, alpha, 0, rows);
  pack_p<BK>(sc, pa);
  for (int i = 1; i < nw; ++i) {
    const int s = i % kWgStages, sp = (i - 1) % kWgStages;
    mbar_wait(full0 + 8 * s, (i / kWgStages) & 1);
    fence_regs<BK / 2>(sc);
    fence_regs<D / 2>(o);
    wgmma_fence();
    issue_s<D, BK>(sc, sq_wg, k_tile(s));
    wgmma_commit();
    issue_pv<D, BK>(o, pa, k_tile(sp) + T::kKVBytes);
    wgmma_commit();
    wgmma_wait<1>();  // S_i is in
    fence_regs<BK / 2>(sc);
    softmax_tile<BK>(sc, m, l, alpha, i * BK, rows);
    wgmma_wait<0>();  // P_{i-1} V_{i-1} is in
    fence_regs<D / 2>(o);
    mbar_arrive(empty0 + 8 * sp);  // stage i - 1's K and V are consumed
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
    pack_p<BK>(sc, pa);
  }
  fence_regs<D / 2>(o);
  wgmma_fence();
  issue_pv<D, BK>(o, pa, k_tile((nw - 1) % kWgStages) + T::kKVBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(o);
  mbar_arrive(empty0 + 8 * ((nw - 1) % kWgStages));
  for (int i = nw; i < ntiles; ++i) {  // past this warpgroup's diagonal
    const int s = i % kWgStages;
    mbar_wait(full0 + 8 * s, (i / kWgStages) & 1);
    mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r + 8 * hr;
    if (row >= a.len) continue;
    const long long base = (static_cast<long long>(bh) * a.len + row) * D;
    if (kResidual) {
      float* acc = static_cast<float*>(a.o) + base;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(acc + 8 * j + cq) =
            make_float2(o[4 * j + 2 * hr], o[4 * j + 2 * hr + 1]);
      }
      if ((lane & 3) == 0) {
        a.m_out[static_cast<long long>(bh) * a.len + row] = m[hr];
        a.l_out[static_cast<long long>(bh) * a.len + row] = l[hr];
      }
    } else {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + base;
      const float den = fmaxf(l[hr], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + cq) =
            __floats2bfloat162_rn(o[4 * j + 2 * hr] / den, o[4 * j + 2 * hr + 1] / den);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// rank-4 (D, L, H, B) map of one bf16 tensor with element strides st (B, H,
// L), boxes of 64 columns by `rows` rows, 128-byte swizzle, zeros past L
bool make_map(CUtensorMap* map, const void* ptr, int batch, int heads, int len, int d,
              const long long* st, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kResidual>
int launch_wgmma(const void* q, const void* k, const void* v, const WgArgs& a, int batch,
                 const long long* strides, cudaStream_t stream) {
  using T = WgTile<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, batch, a.h, a.len, D, strides, kWgRows) ||
      !make_map(&tk, k, batch, a.h, a.len, D, strides + 3, T::kBK) ||
      !make_map(&tv, v, batch, a.h, a.len, D, strides + 6, T::kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_wgmma_kernel<D, kResidual>;
  static bool smem_set = false;  // once per instantiation, before any graph capture
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid(static_cast<unsigned>(batch * a.h),
                  static_cast<unsigned>((a.len + kWgRows - 1) / kWgRows));
  kernel<<<grid, kWgThreads, T::kSmem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wgmma route: q, k, v bf16 (B, H, L, D), D 64 or 128; strides as for
// nns_flash_attention (9 element strides, each a multiple of 8, and 16-byte
// aligned bases). Writes o (B, H, L, D) bf16 when m_out is null, else the
// f32 accumulator to o and m, l (B, H, L). Launches on `stream`; returns
// the cudaError_t of the launch (cudaErrorInvalidValue for a shape or
// layout the route does not take).
extern "C" int nns_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                         float* m_out, float* l_out, int batch, int heads,
                                         int len, int d, const long long* strides, int causal,
                                         float scale, void* stream) {
  if ((d != 64 && d != 128) || len < 1 || batch < 1 || heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* bases[3] = {q, k, v};
  for (const void* p : bases) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < 9; ++i) {
    if (strides[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const WgArgs a{o, m_out, l_out, heads, len, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool residual = m_out != nullptr;
  if (d == 64) {
    return residual ? launch_wgmma<64, true>(q, k, v, a, batch, strides, st)
                    : launch_wgmma<64, false>(q, k, v, a, batch, strides, st);
  }
  return residual ? launch_wgmma<128, true>(q, k, v, a, batch, strides, st)
                  : launch_wgmma<128, false>(q, k, v, a, batch, strides, st);
}
