// flash_attention — blockwise online-softmax attention, causal or full.
//
// Replaces the Pallas TPU kernels of nnstreamer_tpu/ops/pallas/
// flash_attention.py flash_attention: _flash_kernel (normalised output) and
// _flash_kernel_residual (unnormalised accumulator plus the per-row softmax
// max m and normaliser l). Two routes, each normalised or residual (residual
// when m_out is given):
//
//   nns_flash_attention_tf32x3 (the tf32x3 route): q, k, v (B, H, L, D)
//     float32 or bfloat16, any D >= 1, any L;
//   nns_flash_attention_wgmma (the wgmma route): q, k, v (B, H, L, D)
//     bfloat16, D 64 or 128, any L, each a 16-byte aligned base with B, H
//     and L strides multiples of 8 elements (TMA's rules; the wrapper copies
//     a tensor that breaks them).
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
// Both routes keep it on the tensor cores: a bf16 x bf16 product is exact
// in float32 (wgmma, and a bf16 value is a tf32 value), and a float32
// product is taken as three tf32 products (below); every sum is float32,
// only the order of the sums differs.
//
// Bounds, at the flash prefill's (8, 16, 1024, 64) causal: 4 D flops a
// (query, key) pair, 17.2 GFLOP; bf16: 67.1 MB of q, k, v and o (20.0 us at
// 3.35 TB/s) against 17.4 us at 989 TFLOP/s; float32: 3 x 17.2 GFLOP at
// 495 TFLOP/s of tf32 = 104 us (the route's three products; one float32
// product on the CUDA cores' 67 TFLOP/s would be 257 us), against 40 us of
// bytes.
//
// tf32x3 route (every float32 call, and bf16 at D other than 64 and 128):
// warp-level mma.sync m16n8k8 on tf32 operands. A float32 operand x is
// split in registers into hi = x rounded to tf32 (cvt.rna's rounding, done
// as an integer add and mask at the ALU's full rate) and lo = x - hi, exact
// in float32, of which the tensor core reads tf32's 19 top bits; a.b is
// taken as hi_a.lo_b + lo_a.hi_b + hi_a.hi_b, the two small terms first,
// all accumulated in float32: float32's accuracy (the lo.lo term, and lo's
// truncation, are below float32's rounding). The tensor core's own
// accumulation is not IEEE round-to-nearest: it truncates toward zero, so
// no long running sum is carried through it. P.V's 8-key steps, and a
// score's 8-column steps when D > 128 (past one chunk's 16 steps), are
// each summed into a zeroed fragment and added to O or S with an IEEE add
// (C7: carried through the tensor core, O drifted toward zero with L,
// 1.2e-5 from plain at L 4096, D 16, and a D 512 score's 64 steps put m
// 2.0e-5 off).
// A bf16 operand, and p rounded to bf16, is a tf32 value already, so bf16
// takes the one product hi.hi.
// Grid (B*H, ceil(L/BQ), ceil(D/DC)), the heaviest causal query blocks
// issued first. A block of 4 warps owns BQ query rows: each warp two
// m-tiles of 16 rows (mma's M) while the accumulators fit the registers (DC
// <= 64, BQ 128), one at DC 128 (BQ 64), so a K or V fragment, loaded and
// split once, feeds two products. The block loops over 64-key tiles up to
// its causal bound. Q, K and V tiles sit in shared memory as float32, DC
// columns wide (D padded by zeros to DC = 16, 32, 64 or 128), rows DC + 4
// floats apart: with a row stride of 4 mod 8 words every fragment load
// below is free of bank conflicts. The three points where a float32 port
// of the wgmma design would break:
//  * Transposes: wgmma reads a 32-bit B operand from shared memory only
//    K-major, and V is MN-major for P.V. mma.sync takes its fragments from
//    registers, loaded by hand, so V is read in place, a column of 8 keys
//    at a time (two scalar loads a thread) and never transposed.
//  * Where the split happens: in registers, on each fragment as it is
//    loaded (Q's A fragment once per 8 columns and reused over the tile's 8
//    key groups, K's and V's B fragments per product), so shared memory
//    holds one float32 copy of each tile, not a hi and a lo copy.
//  * Fragment layout: the m16n8 accumulator holds S columns (2t, 2t + 1) of
//    each 8-key group, the tf32 A fragment wants (t, t + 4). The key
//    order inside a group is free in a sum, so P.V's A fragment takes k = t
//    as key 2t and k = t + 4 as key 2t + 1: the S fragment is P's A
//    fragment as it stands (registers 0, 2, 1, 3), and the V fragment loads
//    read rows 2t and 2t + 1 to match. P never leaves registers.
// K and V tiles stream through two stages by cp.async (16-byte copies when
// every base and stride allows them, else 4-byte ones; bf16 is converted
// to float32 as it is staged, synchronously), so tile i + 1 loads while
// tile i computes. The softmax is the wgmma route's form: one FMA and one
// ex2 a score (the scale folded into log2 e; masked scores -inf before
// scaling, so m keeps the -1e30 floor). P.V leaves out the 8-key groups
// past a warp's diagonal and past L. D > 128 is taken in 128-column
// chunks: each block owns one chunk of the output (grid z) and sums the
// scores over all chunks, staging Q's and K's chunks in turn without
// overlap; the scores
// are computed once per output chunk (ceil(D / 128) times in all), the
// price of keeping the accumulator in registers.
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
// Launch configurations (the autotuner's grid, tune/): each route takes an
// int `config` at its entry point, 0 for the default, else one of the
// values below; the kernel bodies are the same templates either way.
//   tf32x3: m-tiles per warp MT in {1, 2}, 64 or 128 query rows a block.
//     The default is 2 at DC <= 64, 1 at DC 128. MT 2 at DC 128 is left
//     out: its accumulators (O 2 x 64 and S 2 x 32 floats a thread) would
//     not fit the 255 registers of a thread without spilling.
//   wgmma: keys per K/V tile BK in {64, 128}. The default is 128 at D 64,
//     64 at D 128. BK 128 at D 128 is left out: Q (32 KB) and three stages
//     of K and V (192 KB) take 224 KB of the 227 KB of shared memory a
//     block may have, and the S, O and P fragments (64 + 64 + 32 registers
//     a thread) would spill at 288 threads a block.
// A config outside its route's grid at that D returns cudaErrorInvalidValue.
//
// Debugging note: a wgmma descriptor that does not match the TMA swizzle,
// or a fragment index off by one, gives wrong numbers, not a fault; the
// card tests hold every shape against the plain version.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the contract's mask value and m's start
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMinusInf = -__builtin_huge_valf();

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x (ex2.approx: 2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// The tf32x3 route: float32 (three tf32 products), bf16 at other D (one)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcBK = 64;             // keys per tile
constexpr int kTcNT = kTcBK / 8;      // 8-key groups of a tile

struct TcArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;       // normalised output (q's dtype), or the f32 accumulator
  float* m_out;  // residual mode only
  float* l_out;
  int h, len, d;
  long long sqb, sqh, sql, skb, skh, skl, svb, svh, svl;
  int causal;
  int vec;  // float32 only: every base 16-byte aligned, strides and D multiples of 4
  float scale;
};

// cvt.rna.tf32.f32 (round to nearest, ties away) of a finite x, in two
// integer operations: half a tf32 ulp added to the magnitude bits, the 13
// bits below tf32's mantissa cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the operand as tf32: hi, and for a float32 operand the remainder lo = x -
// hi (exact), of which the tensor core reads the top 19 bits
template <bool kSplit>
__device__ __forceinline__ void to_tf32(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kSplit) {
    hi = tf32_rna(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);  // a bf16 value: exact in tf32
    lo = 0u;
  }
}

// c (16 x 8, f32) += a (16 x 8, tf32, row-major) . b (8 x 8, tf32, col-major)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b, both given as hi/lo fragments
template <bool kSplit>
__device__ __forceinline__ void mma3(float* c, const uint32_t* ahi, const uint32_t* alo,
                                     const uint32_t* bhi, const uint32_t* blo) {
  if constexpr (kSplit) {
    mma_tf32(c, ahi, blo[0], blo[1]);  // the two small terms first
    mma_tf32(c, alo, bhi[0], bhi[1]);
  }
  mma_tf32(c, ahi, bhi[0], bhi[1]);
}

template <bool kSplit>
__device__ __forceinline__ void frag_a(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) to_tf32<kSplit>(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) and columns [c0, c0 + DC) of one head's (L, D) slice
// into dst (rows DC + 4 floats apart), zeros past L and past D. float32 by
// cp.async (its zero fill: 0 source bytes), bf16 converted synchronously.
template <typename T, int DC, int ROWS>
__device__ __forceinline__ void tc_stage(float* dst, const T* src, long long sl, int r0, int c0,
                                         int len, int d, int vec) {
  constexpr int LD = DC + 4;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      for (int i = threadIdx.x; i < ROWS * DC / 4; i += kTcThreads) {
        const int r = i / (DC / 4), c = 4 * (i % (DC / 4));
        const int row = r0 + r, col = c0 + c;
        const bool ok = row < len && col < d;
        cp_async16(smem_u32(dst + r * LD + c), ok ? src + row * sl + col : src, ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < ROWS * DC; i += kTcThreads) {
        const int r = i / DC, c = i % DC;
        const int row = r0 + r, col = c0 + c;
        const bool ok = row < len && col < d;
        cp_async4(smem_u32(dst + r * LD + c), ok ? src + row * sl + col : src, ok ? 4 : 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DC; i += kTcThreads) {
      const int r = i / DC, c = i % DC;
      const int row = r0 + r, col = c0 + c;
      dst[r * LD + c] = (row < len && col < d) ? __bfloat162float(src[row * sl + col]) : 0.0f;
    }
  }
}

// s (this warp's MT m-tiles of 16 rows x 64 keys) += Q[:, chunk] .
// K[:, chunk]^T over the chunk's first `ksteps` 8-column steps. A K
// fragment, loaded and split once, serves all MT m-tiles. All 8 key groups
// are computed, those past the diagonal or past L too (the softmax masks
// them): a branch per group would split the 16 independent products of a
// step into blocks the compiler cannot interleave, and cost more than the
// few groups it saves.
template <int DC, int MT, bool kSplit, bool kIeee>
__device__ __forceinline__ void tc_scores(float (&s)[MT][kTcNT][4], const float* qs,
                                          const float* ks, int row_w, int g, int t, int ksteps) {
  constexpr int LD = DC + 4;
#pragma unroll
  for (int kk = 0; kk < DC / 8; ++kk) {
    if (kk < ksteps) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* qa = qs + (row_w + 16 * mt + g) * LD + 8 * kk + t;
        const float a[4] = {qa[0], qa[8 * LD], qa[4], qa[8 * LD + 4]};
        frag_a<kSplit>(a, ahi[mt], alo[mt]);
      }
#pragma unroll
      for (int nt = 0; nt < kTcNT; ++nt) {
        const float* kb = ks + (8 * nt + g) * LD + 8 * kk + t;
        uint32_t bhi[2], blo[2];
        to_tf32<kSplit>(kb[0], bhi[0], blo[0]);
        to_tf32<kSplit>(kb[4], bhi[1], blo[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (kIeee) {
            // D > DC: as P.V's, each step summed from zero and added in
            // IEEE float32 (C7; a score at D 512 sums 64 steps)
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            mma3<kSplit>(c, ahi[mt], alo[mt], bhi, blo);
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][nt][e] += c[e];
          } else {
            mma3<kSplit>(s[mt][nt], ahi[mt], alo[mt], bhi, blo);  // <= 16 steps
          }
        }
      }
    }
  }
}

// The online softmax on one m-tile's scores (keys k0 .. k0 + 63), in place:
// s becomes p rounded to T (l sums p before the rounding), m and l move
// on, and o takes alpha. This thread holds rows r (registers 0, 1) and
// r + 8 (2, 3) at keys 8 nt + 2t + (0, 1); a row's max and sum reduce over
// the 4 lanes that hold it, l stays this thread's share until the end.
template <typename T, int DC>
__device__ __forceinline__ void tc_softmax(float (&s)[kTcNT][4], float (&o)[DC / 8][4], float* m,
                                           float* l, int k0, int r, int t, bool edge,
                                           const TcArgs& a) {
  float mx[2] = {kMinusInf, kMinusInf};
#pragma unroll
  for (int nt = 0; nt < kTcNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (edge) {
        const int col = k0 + 8 * nt + 2 * t + (e & 1);
        if (col >= a.len || (a.causal && col > r + 8 * (e >> 1))) s[nt][e] = kMinusInf;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  }
  const float c = a.scale * kLog2e;
  float mb[2], alpha[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float m_new = fmaxf(m[hr], mx[hr] * a.scale);  // the -1e30 floor stays
    alpha[hr] = ex2((m[hr] - m_new) * kLog2e);
    m[hr] = m_new;
    mb[hr] = m_new * kLog2e;
    l[hr] *= alpha[hr];
  }
#pragma unroll
  for (int nt = 0; nt < kTcNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[nt][e], c, -mb[e >> 1]));
      l[e >> 1] += p;
      s[nt][e] = round_to<T>(p);
    }
  }
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
  }
}

// o (MT m-tiles of 16 rows x DC columns) += P . V[:, chunk] for one tile.
// P's 8-key step kk is the S fragment of key group kk with its keys
// permuted (A's k = t is key 2t, k = t + 4 key 2t + 1), so the V fragment
// reads rows 2t and 2t + 1 of the group; loaded and split once, it serves
// all MT m-tiles.
template <int DC, int MT, bool kSplit>
__device__ __forceinline__ void tc_pv(float (&o)[MT][DC / 8][4], const float (&p)[MT][kTcNT][4],
                                      const float* vs, int g, int t, int nt_end) {
  constexpr int LD = DC + 4;
#pragma unroll
  for (int kk = 0; kk < kTcNT; ++kk) {
    if (kk < nt_end) {
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float a[4] = {p[mt][kk][0], p[mt][kk][2], p[mt][kk][1], p[mt][kk][3]};
        frag_a<kSplit>(a, ahi[mt], alo[mt]);
      }
      const float* vb = vs + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        uint32_t bhi[2], blo[2];
        to_tf32<kSplit>(vb[8 * j], bhi[0], blo[0]);
        to_tf32<kSplit>(vb[LD + 8 * j], bhi[1], blo[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // the step's products summed by the tensor core from zero, then
          // added to o in IEEE float32: the tensor core's own sum truncates,
          // and o carried through it drifts toward zero with L (C7)
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma3<kSplit>(c, ahi[mt], alo[mt], bhi, blo);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[mt][j][e] += c[e];
        }
      }
    }
  }
}

// m-tiles of 16 query rows per warp by default: two while the accumulators
// fit the registers (DC <= 64), one at DC 128
template <int DC>
struct TcRows {
  static constexpr int kMT = DC <= 64 ? 2 : 1;
};

// query rows per block at MT m-tiles a warp
template <int MT>
struct TcBlock {
  static constexpr int kBQ = 16 * MT * kTcWarps;
};

template <typename T, int DC, int MT, bool kResidual>
__global__ void __launch_bounds__(kTcThreads) flash_tc_kernel(TcArgs a) {
  constexpr int BQ = TcBlock<MT>::kBQ;
  constexpr int kTile = kTcBK * (DC + 4);  // floats in one staged K or V tile
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ float4 tc_smem4[];
  float* qs = reinterpret_cast<float*>(tc_smem4);  // BQ rows, then stage s: K, V
  auto k_tile = [&](int s) { return qs + BQ * (DC + 4) + 2 * kTile * s; };

  const int bh = blockIdx.x;
  const int b = bh / a.h, hh = bh % a.h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal blocks first
  const int c_out = blockIdx.z * DC;                 // this block's output columns
  const int nd = (a.d + DC - 1) / DC;                // column chunks of the scores
  const int kend = a.causal ? min(a.len, q0 + BQ) : a.len;
  const int ntiles = (kend + kTcBK - 1) / kTcBK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_w = 16 * MT * warp;  // the warp's first row in the block
  const T* qp = static_cast<const T*>(a.q) + b * a.sqb + hh * a.sqh;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + hh * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + hh * a.svh;

  float o[MT][DC / 8][4], s[MT][kTcNT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.0f;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.0f;
    }
  }

  for (int i = 0; i < ntiles; ++i) {
    const int k0 = i * kTcBK;
    // key groups this warp needs: none past L, none past its last row
    int nt_end = min(kTcNT, (a.len - k0 + 7) / 8);
    if (a.causal) nt_end = min(nt_end, (q0 + row_w + 16 * MT - 1 - k0) / 8 + 1);
    const bool edge = k0 + kTcBK > a.len || (a.causal && k0 + kTcBK - 1 > q0 + row_w);
    const float* vt;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kTcNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.0f;
      }
    }
    if (nd == 1) {
      // Q once; K and V double-buffered, tile i + 1 loading under tile i
      if (i == 0) {
        tc_stage<T, DC, BQ>(qs, qp, a.sql, q0, 0, a.len, a.d, a.vec);
        tc_stage<T, DC, kTcBK>(k_tile(0), kp, a.skl, 0, 0, a.len, a.d, a.vec);
        tc_stage<T, DC, kTcBK>(k_tile(0) + kTile, vp, a.svl, 0, 0, a.len, a.d, a.vec);
        cp_async_commit();
      }
      if (i + 1 < ntiles) {
        float* kn = k_tile((i + 1) & 1);
        tc_stage<T, DC, kTcBK>(kn, kp, a.skl, k0 + kTcBK, 0, a.len, a.d, a.vec);
        tc_stage<T, DC, kTcBK>(kn + kTile, vp, a.svl, k0 + kTcBK, 0, a.len, a.d, a.vec);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* kt = k_tile(i & 1);
      vt = kt + kTile;
      tc_scores<DC, MT, kSplit, false>(s, qs, kt, row_w, g, t, (a.d + 7) / 8);
    } else {
      // D > DC: the scores sum over the column chunks, staged in turn
      for (int j = 0; j < nd; ++j) {
        tc_stage<T, DC, BQ>(qs, qp, a.sql, q0, j * DC, a.len, a.d, a.vec);
        tc_stage<T, DC, kTcBK>(k_tile(0), kp, a.skl, k0, j * DC, a.len, a.d, a.vec);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        tc_scores<DC, MT, kSplit, true>(s, qs, k_tile(0), row_w, g, t,
                                        (min(DC, a.d - j * DC) + 7) / 8);
        __syncthreads();
      }
      tc_stage<T, DC, kTcBK>(k_tile(0) + kTile, vp, a.svl, k0, c_out, a.len, a.d, a.vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      vt = k_tile(0) + kTile;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      tc_softmax<T, DC>(s[mt], o[mt], m[mt], l[mt], k0, q0 + row_w + 16 * mt + g, t, edge, a);
    }
    tc_pv<DC, MT, kSplit>(o, s, vt, g, t, nt_end);
    __syncthreads();  // this tile's stage is consumed before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float lt = l[mt][hr];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = q0 + row_w + 16 * mt + g + 8 * hr;
      if (row >= a.len) continue;
      const long long base = (static_cast<long long>(bh) * a.len + row) * a.d;
      const float den = fmaxf(lt, 1e-30f);
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c_out + 8 * j + 2 * t + e;
          if (col >= a.d) continue;
          if (kResidual) {
            static_cast<float*>(a.o)[base + col] = o[mt][j][2 * hr + e];
          } else {
            store_f(static_cast<T*>(a.o) + base + col, o[mt][j][2 * hr + e] / den);
          }
        }
      }
      if (kResidual && t == 0 && blockIdx.z == 0) {
        a.m_out[static_cast<long long>(bh) * a.len + row] = m[mt][hr];
        a.l_out[static_cast<long long>(bh) * a.len + row] = lt;
      }
    }
  }
}

template <typename T, int DC, int MT, bool kResidual>
int launch_tc(const TcArgs& a, int batch_heads, cudaStream_t stream) {
  constexpr int BQ = TcBlock<MT>::kBQ;
  constexpr int kSmem = (BQ + 4 * kTcBK) * (DC + 4) * 4;  // Q and two stages of K and V
  auto kernel = flash_tc_kernel<T, DC, MT, kResidual>;
  static bool smem_set = false;  // once per instantiation (above 48 KB needs it)
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid(static_cast<unsigned>(batch_heads), static_cast<unsigned>((a.len + BQ - 1) / BQ),
                  static_cast<unsigned>((a.d + DC - 1) / DC));
  kernel<<<grid, kTcThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// one column chunk width DC at `mt` m-tiles a warp (0: the default)
template <typename T, int DC, bool kResidual>
int launch_tc_mt(const TcArgs& a, int batch_heads, int mt, cudaStream_t stream) {
  if (mt == 0) mt = TcRows<DC>::kMT;
  if (mt == 1) return launch_tc<T, DC, 1, kResidual>(a, batch_heads, stream);
  if constexpr (DC <= 64) {
    if (mt == 2) return launch_tc<T, DC, 2, kResidual>(a, batch_heads, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool kResidual>
int dispatch_tc(const TcArgs& a, int batch_heads, int mt, cudaStream_t stream) {
  if (a.d <= 16) return launch_tc_mt<T, 16, kResidual>(a, batch_heads, mt, stream);
  if (a.d <= 32) return launch_tc_mt<T, 32, kResidual>(a, batch_heads, mt, stream);
  if (a.d <= 64) return launch_tc_mt<T, 64, kResidual>(a, batch_heads, mt, stream);
  return launch_tc_mt<T, 128, kResidual>(a, batch_heads, mt, stream);
}

}  // namespace

// The tf32x3 route: q, k, v (B, H, L, D) float32 (is_bf16 = 0) or bfloat16,
// any D >= 1; strides: 9 element strides, (B, H, L) of q, then of k, then
// of v. Writes o (B, H, L, D) in q's dtype when m_out is null, else the f32
// accumulator to o and m, l (B, H, L). `config`: m-tiles per warp, 0 for
// the default (launch configurations above). Launches on `stream`; returns
// the cudaError_t of the launch (cudaErrorInvalidValue for an empty shape
// or a config outside the grid).
extern "C" int nns_flash_attention_tf32x3(const void* q, const void* k, const void* v, void* o,
                                          float* m_out, float* l_out, int batch, int heads,
                                          int len, int d, const long long* strides, int causal,
                                          float scale, int is_bf16, int config, void* stream) {
  if (d < 1 || len < 1 || batch < 1 || heads < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int vec = !is_bf16 && d % 4 == 0;
  const void* bases[3] = {q, k, v};
  for (const void* p : bases) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 4 == 0;
  TcArgs a{q, k, v, o, m_out, l_out, heads, len, d,
           strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
           strides[6], strides[7], strides[8], causal, vec, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  const bool residual = m_out != nullptr;
  if (is_bf16) {
    return residual ? dispatch_tc<__nv_bfloat16, true>(a, bh, config, st)
                    : dispatch_tc<__nv_bfloat16, false>(a, bh, config, st);
  }
  return residual ? dispatch_tc<float, true>(a, bh, config, st)
                  : dispatch_tc<float, false>(a, bh, config, st);
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

// keys per K/V tile by default: 128 at D 64, 64 at D 128 (the S and O
// fragments then fit the registers: 64 + 32 or 32 + 64 floats a thread)
template <int D>
struct WgDefault {
  static constexpr int kBK = D == 64 ? 128 : 64;
};

template <int D, int BK>
struct WgTile {
  static constexpr int kBK = BK;
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

template <int D, int BK, bool kResidual>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, WgArgs a) {
  using T = WgTile<D, BK>;
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

template <int D, int BK, bool kResidual>
int launch_wgmma(const void* q, const void* k, const void* v, const WgArgs& a, int batch,
                 const long long* strides, cudaStream_t stream) {
  using T = WgTile<D, BK>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, batch, a.h, a.len, D, strides, kWgRows) ||
      !make_map(&tk, k, batch, a.h, a.len, D, strides + 3, T::kBK) ||
      !make_map(&tv, v, batch, a.h, a.len, D, strides + 6, T::kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_wgmma_kernel<D, BK, kResidual>;
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
// f32 accumulator to o and m, l (B, H, L). `config`: keys per K/V tile, 0
// for the default (launch configurations above). Launches on `stream`;
// returns the cudaError_t of the launch (cudaErrorInvalidValue for a shape,
// layout or config the route does not take).
extern "C" int nns_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                         float* m_out, float* l_out, int batch, int heads,
                                         int len, int d, const long long* strides, int causal,
                                         float scale, int config, void* stream) {
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
    const int bk = config == 0 ? WgDefault<64>::kBK : config;
    if (bk == 128) {
      return residual ? launch_wgmma<64, 128, true>(q, k, v, a, batch, strides, st)
                      : launch_wgmma<64, 128, false>(q, k, v, a, batch, strides, st);
    }
    if (bk == 64) {
      return residual ? launch_wgmma<64, 64, true>(q, k, v, a, batch, strides, st)
                      : launch_wgmma<64, 64, false>(q, k, v, a, batch, strides, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (config != 0 && config != WgDefault<128>::kBK) return static_cast<int>(cudaErrorInvalidValue);
  return residual ? launch_wgmma<128, 64, true>(q, k, v, a, batch, strides, st)
                  : launch_wgmma<128, 64, false>(q, k, v, a, batch, strides, st);
}
