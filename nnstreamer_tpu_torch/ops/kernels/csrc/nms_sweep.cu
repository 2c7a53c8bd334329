// nms_sweep — greedy NMS over K score-descending candidates.
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/epilogue.py
// nms_sweep (_nms_kernel): five (K,) f32 columns x0, y0, x1, y1, score ->
// (K,) f32 scores where a row is kept iff its score >= threshold and no
// earlier kept row overlaps it with IoU strictly above iou_threshold; every
// other row becomes -1. On the SSD path K is PRE_NMS_TOPK = 256; any K >= 1
// is taken.
//
// Bound: latency. The work is K(K-1)/2 IoU tests (about 0.4 MFLOP at K =
// 256) on 24*K bytes, far below both roofs; what takes the time is the
// launch, the tests' dependent arithmetic and the sweep, K steps that each
// depend on the one before. The earlier one-block kernel (one thread a
// candidate, each building its whole row) spent 84 % of its 75 us at K 256
// building the relation and 15 % sweeping (scripts/nms_phase_split.py on
// an H100 80GB HBM3, 700 W).
//
// Design: one thread-block cluster of 8 blocks (8 SMs) of 256 threads.
//  1. The build, by the whole cluster. The boxes (as float4, zero-padded to
//     whole 32-row words) and their areas are staged in each block's shared
//     memory. The `suppresses` relation (bit b of word w of row i: row i
//     suppresses row j = 32 w + b > i) is built a 32-bit word a thread,
//     words dealt round the 8 blocks: 32 independent, branch-free IoU
//     tests each, then a mask of the rows i < j < K. A test decides
//     `inter / union > thr` by two FMAs whose signs are exact and takes the
//     IEEE division only for a quotient within one float above thr, where
//     the rounding decides (overlaps()). Words wholly below the diagonal
//     (w < i/32) are never read and not computed. Up to K = 1024 every
//     block writes its words straight into block 0's shared memory
//     (distributed shared memory; 131 KB at K 1024, with the opt-in
//     carve-out), word-major with an odd row pitch P = K | 1 so that
//     consecutive rows and a lane's column of words both spread over the
//     banks; one cluster barrier publishes them. Beyond K = 1024 the
//     relation goes to a global scratch buffer the wrapper allocates and
//     the boxes are read from global memory (areas recomputed, bit for bit
//     the same), so any K is taken.
//  2. The sweep, by one warp of block 0 (the others have exited), in
//     chunks of 32 rows. Up to K = 1024 lane l holds alive word l (score >=
//     threshold, packed by ballots) in a register. For chunk c every load
//     is issued first: the chunk's 32 diagonal words (broadcast) and this
//     lane's word of each of the chunk's 32 rows; the chunk's alive word
//     comes by one shuffle. Then the chunk's 32 steps resolve in registers,
//     ALU operations alone, no shuffle or load in the dependent chain:
//     `if (keep >> b & 1) keep &= ~diag[b]`. Each later lane then clears
//     from its alive word the bits of the kept rows (masked ORs, no
//     branch). Beyond K = 1024 the alive words sit in shared memory, lane l
//     updating words c + 1 + l, + 32, ...
//  3. Block 0 writes score or -1.

// The result is bit for bit nms_sweep_reference's: intersection, areas and
// union are built from round-to-nearest intrinsics in the reference's order
// (no FMA contraction), and `(union > 0 ? inter / union : 0) > thr` is
// decided exactly, with the IEEE division where rounding matters. This
// file is compiled without fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kCluster = 8;   // blocks that build the relation together
constexpr int kThreads = 256;  // threads a block
// the largest K whose relation is kept in shared memory
constexpr int kSmemMaxK = 1024;

// the relation's row pitch in words: odd, so a column of words spreads
// over all banks
__host__ __device__ __forceinline__ int pitch(int k) { return k | 1; }

// The reference's test `(union > 0 ? inter / union : 0) > thr`, bit for bit,
// without a division where the rounding of inter / union cannot matter. For
// union > 0, fmaf(thr, union, -inter) has the sign of thr * union - inter
// exactly (one rounding of the exact value keeps its sign): d >= 0 means
// inter / union <= thr, and so its rounding; d2 < 0, the same against
// thr_up = the next float above thr, means inter / union > thr_up, and its
// rounding > thr. A quotient in (thr, thr_up], where the rounding decides,
// is flagged `exact` for the IEEE division. A NaN fails every comparison,
// as in the reference. Branch-free, so 32 tests unroll into one block.
__device__ __forceinline__ bool overlaps(float inter, float uni, float thr, float thr_up,
                                         bool& exact) {
  const bool pos = uni > 0.0f;
  const bool above = fmaf(thr, uni, -inter) < 0.0f;
  const bool clear = fmaf(thr_up, uni, -inter) < 0.0f;
  exact = pos && above && !clear;
  return pos ? above && clear : 0.0f > thr;
}

// intersection and union of boxes a and b, the reference's op order
__device__ __forceinline__ void inter_union(float4 a, float area_a, float4 b, float area_b,
                                            float& inter, float& uni) {
  const float ix = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float iy = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  inter = __fmul_rn(fmaxf(ix, 0.0f), fmaxf(iy, 0.0f));
  uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// Word w of row i of the relation: bit b set iff row i suppresses row
// j = 32 w + b, i < j < K. box(j) gives box j (any j < 32 * words; past K it
// may be anything: those bits are masked off) and area(j) its area.
template <typename Box, typename Area>
__device__ __forceinline__ uint32_t relation_word(int i, int w, int k, Box box, Area area,
                                                  float thr, float thr_up) {
  const float4 bi = box(i);
  const float ai = area(i);
  uint32_t bits = 0, exact = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    float inter, uni;
    inter_union(bi, ai, box(32 * w + b), area(32 * w + b), inter, uni);
    bool ex;
    bits |= static_cast<uint32_t>(overlaps(inter, uni, thr, thr_up, ex)) << b;
    exact |= static_cast<uint32_t>(ex) << b;
  }
  const int lo = i + 1 - 32 * w, hi = k - 32 * w;
  const uint32_t later = (lo <= 0 ? ~0u : lo >= 32 ? 0u : ~0u << lo) &
                         (hi >= 32 ? ~0u : hi <= 0 ? 0u : ~0u >> (32 - hi));
  for (exact &= later; exact != 0u; exact &= exact - 1u) {  // rare: the rounding decides
    const int b = __ffs(static_cast<int>(exact)) - 1;
    float inter, uni;
    inter_union(bi, ai, box(32 * w + b), area(32 * w + b), inter, uni);
    bits = (bits & ~(1u << b)) | (static_cast<uint32_t>(__fdiv_rn(inter, uni) > thr) << b);
  }
  return bits & later;
}

// the chunk's 32 steps of the sweep, in registers: keep starts as the
// chunk's alive word and ends as its kept rows
__device__ __forceinline__ uint32_t resolve_chunk(uint32_t keep, const uint32_t (&diag)[32]) {
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    if ((keep >> b) & 1u) keep &= ~diag[b];
  }
  return keep;
}

template <bool kSmemRel>
__global__ void __launch_bounds__(kThreads)
    nms_sweep_kernel(const float* __restrict__ x0, const float* __restrict__ y0,
                     const float* __restrict__ x1, const float* __restrict__ y1,
                     const float* __restrict__ score, float* __restrict__ out,
                     uint32_t* __restrict__ rel_global, int k, float iou_threshold, float iou_up,
                     float threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int words = (k + 31) >> 5;
  const int t = threadIdx.x;
  uint32_t* alive = reinterpret_cast<uint32_t*>(smem);  // words (block 0's are read)
  // kThreads and 32 * words are multiples of 32: whole warps iterate together
  for (int i = t; i < 32 * words; i += kThreads) {
    const uint32_t ballot = __ballot_sync(kFullMask, i < k && score[i] >= threshold);
    if ((i & 31) == 0) alive[i >> 5] = ballot;
  }
  // item n (word n / K of row n % K) goes to block n % kCluster
  const long long items = static_cast<long long>(words) * k;

  if constexpr (kSmemRel) {
    // K <= 1024: boxes (padded with zeros to 32 * words) and areas in each
    // block's shared memory, the relation in block 0's
    const int p = pitch(k);
    float4* sbox = reinterpret_cast<float4*>(smem + 16 * ((words + 3) / 4));
    float* sarea = reinterpret_cast<float*>(sbox + 32 * words);
    uint32_t* rel = reinterpret_cast<uint32_t*>(sarea + 32 * words);
    for (int i = t; i < 32 * words; i += kThreads) {
      const float4 bi = i < k ? make_float4(x0[i], y0[i], x1[i], y1[i]) : make_float4(0, 0, 0, 0);
      sbox[i] = bi;
      sarea[i] = area_of(bi);
    }
    __syncthreads();

    // 1. the build, every block of the cluster, into block 0's relation
    uint32_t* rel0 = cluster.map_shared_rank(rel, 0);
    for (int n = rank + kCluster * t; n < items; n += kCluster * kThreads) {
      const int w = n / k, i = n - w * k;
      if (w < (i >> 5)) continue;  // wholly below the diagonal: never read
      rel0[w * p + i] = relation_word(
          i, w, k, [=](int j) { return sbox[j]; }, [=](int j) { return sarea[j]; },
          iou_threshold, iou_up);
    }
    cluster.sync();
    if (rank != 0) return;  // nothing reads this block's memory any more

    // 2. the sweep; lane l holds alive word l in a register. Every load of
    // a chunk is issued before its chain: the diagonal words (rows past K
    // are not alive) and this lane's word of each of the chunk's rows (the
    // rows of chunks before the last are all < K)
    if (t < 32) {
      uint32_t mine = t < words ? alive[t] : 0u;
      for (int c = 0; c < words; ++c) {
        uint32_t diag[32], later[32];
        const bool owner = t > c && t < words;
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          diag[b] = rel[c * p + 32 * c + b];
          later[b] = owner ? rel[t * p + 32 * c + b] : 0u;
        }
        const uint32_t keep = resolve_chunk(__shfl_sync(kFullMask, mine, c), diag);
        uint32_t gone[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 32; ++b) gone[b & 3] |= later[b] & (0u - ((keep >> b) & 1u));
        mine = t == c ? keep : mine & ~(gone[0] | gone[1] | gone[2] | gone[3]);
      }
      if (t < words) alive[t] = mine;
    }
  } else {
    // K > 1024: the relation in global scratch, the boxes read from global
    // memory, the alive words in block 0's shared memory
    const long long p = pitch(k);
    uint32_t* rel = rel_global;
    auto box = [=](int j) {
      j = min(j, k - 1);
      return make_float4(x0[j], y0[j], x1[j], y1[j]);
    };
    auto area = [=](int j) { return area_of(box(j)); };
    for (long long n = rank + kCluster * t; n < items; n += kCluster * kThreads) {
      const int w = static_cast<int>(n / k);
      const int i = static_cast<int>(n - static_cast<long long>(w) * k);
      if (w < (i >> 5)) continue;
      rel[w * p + i] = relation_word(i, w, k, box, area, iou_threshold, iou_up);
    }
    cluster.sync();  // release and acquire at cluster scope: the relation is written
    if (rank != 0) return;
    if (t < 32) {
      for (int c = 0; c < words; ++c) {
        uint32_t diag[32];
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const int i = 32 * c + b;
          diag[b] = i < k ? rel[c * p + i] : 0u;
        }
        const uint32_t keep = resolve_chunk(alive[c], diag);
        for (int w = c + 1 + t; w < words; w += 32) {  // lane l: words c + 1 + l, + 32, ...
          uint32_t gone = 0;
#pragma unroll
          for (int b = 0; b < 32; ++b) {
            if ((keep >> b) & 1u) gone |= rel[w * p + 32 * c + b];
          }
          alive[w] &= ~gone;
        }
        if (t == 0) alive[c] = keep;
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // 3. the scores, block 0
  for (int i = t; i < k; i += kThreads) {
    out[i] = ((alive[i >> 5] >> (i & 31)) & 1u) ? score[i] : -1.0f;
  }
}

size_t smem_bytes(int k, bool smem_rel) {
  const size_t words = (k + 31) / 32;
  // the relation and 32 words past it: the last chunk's diagonal reads rows
  // up to 32 * words, which are not alive
  return 16 * ((words + 3) / 4) +
         (smem_rel ? 32 * words * (16 + 4) + sizeof(uint32_t) * (words * pitch(k) + 32) : 0);
}

template <bool kSmemRel>
int launch(const float* x0, const float* y0, const float* x1, const float* y1, const float* score,
           float* out, uint32_t* scratch, int k, float iou_threshold, float threshold,
           cudaStream_t stream) {
  auto kernel = nms_sweep_kernel<kSmemRel>;
  const size_t shmem = smem_bytes(k, kSmemRel);
  if (shmem > 48 * 1024) {
    // above 48 KB only after opting in, once per instantiation (before any
    // graph capture): the smem route's largest K, or the most the card gives
    static bool smem_set = false;
    if (!smem_set) {
      const int most = kSmemRel ? static_cast<int>(smem_bytes(kSmemMaxK, true)) : 227 * 1024;
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x0, y0, x1, y1, score, out, scratch, k,
                                             iou_threshold, nextafterf(iou_threshold, INFINITY),
                                             threshold);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Launches on `stream`. For K > 1024, `scratch` holds ceil(K / 32) * (K | 1)
// words of global memory for the relation (null otherwise). Returns the
// cudaError_t of the launch (0 = success; cudaErrorInvalidValue for K < 1 or
// a missing scratch buffer).
extern "C" int nns_nms_sweep(const float* x0, const float* y0, const float* x1,
                             const float* y1, const float* score, float* out,
                             uint32_t* scratch, int k, float iou_threshold, float threshold,
                             void* stream) {
  if (k < 1 || (k > kSmemMaxK && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= kSmemMaxK) {
    return launch<true>(x0, y0, x1, y1, score, out, nullptr, k, iou_threshold, threshold, st);
  }
  return launch<false>(x0, y0, x1, y1, score, out, scratch, k, iou_threshold, threshold, st);
}
