// nms_sweep — greedy NMS over K score-descending candidates.
//
// Replaces the Pallas TPU kernel nnstreamer_tpu/ops/pallas/epilogue.py
// nms_sweep (_nms_kernel): five (K,) f32 columns x0, y0, x1, y1, score ->
// (K,) f32 scores where a row is kept iff its score >= threshold and no
// earlier kept row overlaps it with IoU strictly above iou_threshold; every
// other row becomes -1. On the SSD path K is PRE_NMS_TOPK = 256; the TFLite
// SSD post-process sweeps its 1917 anchors; any K >= 1 is taken.
//
// Bound: latency. The work is K(K-1)/2 IoU tests (about 0.4 MFLOP at K =
// 256, 24 MFLOP at K 1917) on 24*K bytes, far below both roofs; what takes
// the time is the launch, the tests' dependent arithmetic and the sweep, K
// steps that each depend on the one before. The earlier one-block kernel
// (one thread a candidate, each building its whole row) spent 84 % of its
// 75 us at K 256 building the relation and 15 % sweeping
// (scripts/nms_phase_split.py on an H100 80GB HBM3, 700 W).
//
// The relation: bit b of word w of row i is set iff row i suppresses row
// j = 32 w + b > i. A word is built by relation_word: 32 independent,
// branch-free IoU tests, then a mask of the rows i < j < K. A test decides
// `inter / union > thr` by two FMAs whose signs are exact and takes the IEEE
// division only for a quotient within one float above thr, where the
// rounding decides (overlaps()). Words wholly below the diagonal
// (w < i/32) are never read and not computed. The sweep goes in chunks of
// 32 rows: for chunk c every load is issued first (the chunk's 32 diagonal
// words and the lane's word of each of its rows), then its 32 steps
// resolve in registers, ALU operations alone: `if (keep >> b & 1) keep &=
// ~diag[b]`; then each later alive word loses the bits of the kept rows,
// no branch. Two routes, by K:
//
// Up to K = 1024 (the SSD path): one thread-block cluster of 8 blocks (8
// SMs) of 256 threads. The boxes (as float4, zero-padded to whole 32-row
// words) and their areas are staged in each block's shared memory; the
// words are dealt round the 8 blocks, a thread a word, and written straight
// into block 0's shared memory (distributed shared memory; 131 KB at K
// 1024, with the opt-in carve-out), word-major with an odd row pitch P = K |
// 1 so that consecutive rows and a lane's column of words both spread over
// the banks; one cluster barrier publishes them. One warp of block 0 sweeps
// (the others have exited); lane l holds alive word l (score >= threshold,
// packed by ballots) in a register and the chunk's alive word comes by one
// shuffle; resolve_chunk resolves it, masked ORs clear the later words.
// Block 0 writes score or -1.
//
// Beyond K = 1024 (the TFLite SSD post-process's K 1917): the relation goes
// to global scratch the wrapper allocates, built on the whole card and swept
// by one block fed by bulk copies. Two kernels, launched from the one entry
// point on the caller's stream.
//  1. relation_build_kernel: a warp for each 32-row word column, rows
//     32 c .. 32 c + 31 by word w, for the W (W + 1) / 2 pairs c <= w < W
//     (W = ceil(K / 32) words a row; 1830 warps at K 1917), 8 a block. A
//     warp stages its 32 row boxes and 32 column boxes (float4) with their
//     areas in its own shared memory, and each lane computes its row's word
//     by relation_word through shared-memory lambdas, called in the staged
//     index space: the shift keeps i - 32 w and K - 32 w, all the masks
//     read. The column boxes are broadcasts, the row boxes consecutive.
//     The relation is chunk-major: chunk c's slab is the tiles c / 32 ..
//     T - 1 of its rows (T = ceil(W / 32)), back to back (slab_tile(); in
//     Python epilogue.nms_slab_tile, which sizes the scratch); a tile is 32
//     rows x 32 words stored word by word, each word's 32 rows padded to
//     kPitch = 36 (4.5 KB), so a warp's word is one 128-byte store and a
//     lane reads a column as 8 16-byte loads, each quarter-warp on its own
//     banks. Words below the diagonal or past K are not written; no lane
//     uses them.
//  2. relation_sweep_kernel, one block of 256 threads. While the build
//     runs, it initialises its barriers and packs the alive words by
//     ballots into shared memory. Then three warps. Thread 0 waits for the
//     build grid and keeps the chunks' first tiles in flight, a
//     cp.async.bulk (TMA) of 4.5 KB each into a ring of 4 stages, each
//     completing on its stage's mbarrier with its bytes and handed back on
//     an empty barrier. Warp 1 is the chain: for chunk c it takes the
//     chunk's alive word from the lane that holds it by one shuffle, issues
//     the next chunk's 16 loads, and resolves the chunk in registers
//     (resolve_clear): row b is kept iff its bit is still set, and then a
//     predicated AND clears the rows it suppresses and a predicated OR
//     gathers its word of the lane's column -- two dependent instructions a
//     step, no load and no branch in the chain. A lane keeps its word of
//     the current 32-chunk group in a register; the chunk's kept rows go to
//     warp 2 as one 8-byte store that is its own flag. Warp 2 clears them
//     from the alive words of the later tiles c / 32 + 1 .. T - 1 (lane l's
//     words l, 32 + l, ... in shared memory only it touches), fed by its own
//     ring of 5 stages that it refills itself; at the end of each group it
//     hands the next tile's words to warp 1 on an mbarrier. Two rings,
//     because the chain waits for its next tile before it hands its kept
//     rows on: in one ring behind the later tiles that wait would deadlock
//     once a slab has as many tiles as the ring has stages. The block
//     writes score or -1.
//  The hand-off: two kernels, not one whose sweep block waits on per-chunk
//  counters, which would need a cooperative launch to be sure that every
//  block is resident and counters reset inside each call. The sweep kernel
//  is launched with programmatic stream serialization: every build block
//  lets it start at once (griddepcontrol.launch_dependents), so its launch
//  and prologue overlap the build, and its producers wait for the whole
//  build grid and its memory (griddepcontrol.wait) before their first
//  copy. Stream capture keeps the pair as a programmatic graph edge.
//  What holds it (scripts/nms_phase_split.py, H100 80GB HBM3, 700 W): at K
//  1917 the sweep, 60 chunks of about 0.36 us, of which the 32 steps are
//  about half; the build about 4.3 us; the sweep block's launch after the
//  build's start, 2.4 to 4.7 us. Past a few thousand candidates warp 2,
//  with T - 1 - c / 32 tiles a chunk, sets the pace.
//
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
// past it: a tile of the relation is 32 rows x 32 words, word by word,
// kPitch words a word (its 32 rows and a pad)
constexpr int kPitch = 36;
constexpr int kTileWords = 32 * kPitch;
constexpr int kTileBytes = 4 * kTileWords;
// tiles in flight into the sweep block: the chunks' first tiles, the rest
constexpr int kStagesA = 4;
constexpr int kStagesB = 5;

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

__global__ void __launch_bounds__(kThreads)
    nms_sweep_kernel(const float* __restrict__ x0, const float* __restrict__ y0,
                     const float* __restrict__ x1, const float* __restrict__ y1,
                     const float* __restrict__ score, float* __restrict__ out, int k,
                     float iou_threshold, float iou_up, float threshold) {
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

  // boxes (padded with zeros to 32 * words) and areas in each block's
  // shared memory, the relation in block 0's
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
  __syncthreads();

  // 3. the scores, block 0
  for (int i = t; i < k; i += kThreads) {
    out[i] = ((alive[i >> 5] >> (i & 31)) & 1u) ? score[i] : -1.0f;
  }
}

// ---- K > 1024: the relation in global scratch ----

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

// `bytes` (a multiple of 16) from 16-byte aligned global memory into
// 16-byte aligned shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// programmatic dependent launch: let the stream's next kernel start; wait
// until the stream's previous grid has finished and its writes are visible
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the first tile of chunk c's slab, for rows of `tiles` tiles: the chunks
// 32 q .. 32 q + 31 hold tiles - q tiles each
__host__ __device__ __forceinline__ long long slab_tile(int c, int tiles) {
  const long long q = c >> 5, r = c & 31;
  return 32 * (q * tiles - q * (q - 1) / 2) + r * (tiles - q);
}

// `gone |= word` if `keep & bit`: a predicate and a predicated OR
__device__ __forceinline__ void or_if(uint32_t& gone, uint32_t keep, uint32_t bit,
                                      uint32_t word) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %1, %2;\n\tsetp.ne.b32 p, t, 0;\n\t@p or.b32 %0, %0, %3;\n\t}"
      : "+r"(gone)
      : "r"(keep), "r"(bit), "r"(word));
}

// the chunk's 32 steps, as resolve_chunk, with what its kept rows clear from
// this lane's word: row b (bit 1 << b) is kept iff its bit of keep is still
// set; then it clears the rows it suppresses from keep (ndiag[b] = ~its
// diagonal word) and ORs its word of the lane's column (later[b]) into gone.
// Two dependent instructions a step, a predicate and a predicated AND; the
// OR hangs off the chain, in its idle issue slots.
__device__ __forceinline__ uint32_t resolve_clear(uint32_t keep, const uint32_t (&diag)[32],
                                                  const uint32_t (&later)[32], uint32_t& gone) {
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
        "and.b32 t, %0, %2;\n\tsetp.ne.b32 p, t, 0;\n\t"
        "@p and.b32 %0, %0, %3;\n\t@p or.b32 %1, %1, %4;\n\t}"
        : "+r"(keep), "+r"(gone)
        : "r"(1u << b), "r"(~diag[b]), "r"(later[b]));
  }
  return keep;
}

// a tile's word column l (rows 0..31) into registers: 8 16-byte loads; for
// 32 lanes at 9 l + q in 16-byte units, each quarter-warp covers the banks
__device__ __forceinline__ void load_column(const uint32_t* tile, int l, uint32_t (&v)[32]) {
  const uint4* p = reinterpret_cast<const uint4*>(tile + kPitch * l);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 x = p[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// 1. a warp a word column: rows 32 c .. 32 c + 31 by word w, for the n-th
// of the W (W + 1) / 2 pairs c <= w < W, in chunk order
__global__ void __launch_bounds__(kThreads)
    relation_build_kernel(const float* __restrict__ x0, const float* __restrict__ y0,
                          const float* __restrict__ x1, const float* __restrict__ y1,
                          uint32_t* __restrict__ rel, int k, float iou_threshold,
                          float iou_up) {
  launch_dependents();  // the sweep block may start its prologue
  __shared__ float4 sbox[kThreads / 32][64];
  __shared__ float sarea[kThreads / 32][64];
  const int words = (k + 31) >> 5, tiles = (words + 31) >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = static_cast<long long>(blockIdx.x) * (kThreads / 32) + warp;
  // chunk c holds the pairs from before(c) = c W - c (c - 1) / 2 on
  auto before = [=](long long c) { return c * words - c * (c - 1) / 2; };
  if (n >= before(words)) return;
  const double b2 = 2.0 * words + 1.0;
  int c = static_cast<int>((b2 - sqrt(b2 * b2 - 8.0 * static_cast<double>(n))) / 2.0);
  c = max(0, min(c, words - 1));
  while (before(c) > n) --c;
  while (before(c + 1) <= n) ++c;
  const int w = c + static_cast<int>(n - before(c));
  // [0, 32): the chunk's rows; [32, 64): word w's columns; zeros past K
  float4* bx = sbox[warp];
  float* ar = sarea[warp];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = 32 * (h ? w : c) + lane;
    const float4 b = j < k ? make_float4(x0[j], y0[j], x1[j], y1[j]) : make_float4(0, 0, 0, 0);
    bx[32 * h + lane] = b;
    ar[32 * h + lane] = area_of(b);
  }
  __syncwarp();
  // in the staged index space column j is at j - 32 (w - 1), word w at 1
  // and K at K - 32 (w - 1); row i at i - 32 c, before every column, or on
  // the diagonal (w == c) at its copy among the columns. The later-row
  // masks read only i - 32 w and K - 32 w, which the shift keeps.
  const uint32_t bits = relation_word(
      w == c ? 32 + lane : lane, 1, k - 32 * (w - 1), [=](int j) { return bx[j]; },
      [=](int j) { return ar[j]; }, iou_threshold, iou_up);
  rel[(slab_tile(c, tiles) + (w >> 5) - (c >> 5)) * kTileWords + kPitch * (w & 31) + lane] = bits;
}

// an 8-byte shared-memory word, read and written whole and uncached
__device__ __forceinline__ uint64_t load_volatile(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.volatile.shared.u64 %0, [%1];\n" : "=l"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}

__device__ __forceinline__ void store_volatile(uint64_t* p, uint64_t v) {
  asm volatile("st.volatile.shared.u64 [%0], %1;\n" ::"r"(smem_u32(p)), "l"(v) : "memory");
}

// 2. and 3. the sweep over the slabs in order, then the scores
__global__ void __launch_bounds__(kThreads)
    relation_sweep_kernel(const float* __restrict__ score, float* __restrict__ out,
                          const uint32_t* __restrict__ rel, int k, float threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) >> 5, tiles = (words + 31) >> 5;
  uint32_t* ring_a = reinterpret_cast<uint32_t*>(smem);  // the chunks' first tiles
  uint32_t* ring_b = ring_a + kStagesA * kTileWords;     // their later tiles
  uint64_t* full_a = reinterpret_cast<uint64_t*>(ring_b + kStagesB * kTileWords);
  uint64_t* empty_a = full_a + kStagesA;
  uint64_t* full_b = empty_a + kStagesA;
  uint64_t* handover = full_b + kStagesB;  // warp 2 has swept a 32-chunk group
  // each chunk's kept rows, with bit 32 set once they are: one 8-byte store
  // is the flag and the value, so no fence orders them
  uint64_t* kept = handover + 1;
  uint32_t* alive = reinterpret_cast<uint32_t*>(kept + words);  // 32 * tiles alive words
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    for (int s = 0; s < kStagesA; ++s) {
      mbar_init(smem_u32(full_a + s), 1);
      mbar_init(smem_u32(empty_a + s), 1);
    }
    for (int s = 0; s < kStagesB; ++s) mbar_init(smem_u32(full_b + s), 1);
    mbar_init(smem_u32(handover), 32);
  }
  for (int c = t; c < words; c += kThreads) kept[c] = 0ull;
  // the alive words, zero past K (whole warps iterate together); the
  // scores are not the build's output, so they are read before it ends
#pragma unroll 4
  for (int i = t; i < 1024 * tiles; i += kThreads) {
    const uint32_t ballot = __ballot_sync(kFullMask, i < k && score[i] >= threshold);
    if (lane == 0) alive[i >> 5] = ballot;
  }
  __syncthreads();

  if (t == 0) {  // the chain's tiles, chunk by chunk
    grid_dependency_wait();
    for (int c = 0; c < words; ++c) {
      const int s = c % kStagesA;
      mbar_wait(smem_u32(empty_a + s), (static_cast<uint32_t>(c / kStagesA) & 1u) ^ 1u);
      mbar_expect_tx(smem_u32(full_a + s), kTileBytes);
      bulk_load(smem_u32(ring_a + s * kTileWords), rel + slab_tile(c, tiles) * kTileWords,
                kTileBytes, smem_u32(full_a + s));
    }
  } else if (warp == 1) {
    // the chain: each chunk's first tile, resolved; the lane's word of that
    // tile in a register for the 32 chunks of its group
    auto take = [&](int c, uint32_t(&diag)[32], uint32_t(&later)[32]) {
      const int s = c % kStagesA;
      mbar_wait(smem_u32(full_a + s), static_cast<uint32_t>(c / kStagesA) & 1u);
      load_column(ring_a + s * kTileWords, c & 31, diag);
      load_column(ring_a + s * kTileWords, lane, later);
    };
    uint32_t word = alive[lane];
    // resolve chunk c from (diag, later) while the next chunk's tile is
    // read into (ndiag, nlater)
    auto chunk = [&](int c, const uint32_t(&diag)[32], const uint32_t(&later)[32],
                     uint32_t(&ndiag)[32], uint32_t(&nlater)[32]) {
      const int lc = c & 31;
      const uint32_t cur = __shfl_sync(kFullMask, word, lc);  // before the loads' queue
      take(c + 1 < words ? c + 1 : c, ndiag, nlater);
      uint32_t gone = 0u;
      const uint32_t keep = resolve_clear(cur, diag, later, gone);
      word = lane == lc ? keep : lane > lc ? word & ~gone : word;
      if (lane == 0) store_volatile(kept + c, (1ull << 32) | keep);
      __syncwarp();  // chunk c's stage is read
      if (lane == 0) mbar_arrive(smem_u32(empty_a + c % kStagesA));
      if (lc == 31 && c + 1 < words) {  // the next chunk opens the next tile
        alive[32 * (c >> 5) + lane] = word;
        mbar_wait(smem_u32(handover), static_cast<uint32_t>(c >> 5) & 1u);
        word = alive[32 * ((c >> 5) + 1) + lane];
      }
    };
    uint32_t da[32], la[32], db[32], lb[32];
    take(0, da, la);
    for (int c = 0; c < words; c += 2) {  // by twos, so the two sets of registers alternate
      chunk(c, da, la, db, lb);
      if (c + 1 < words) chunk(c + 1, db, lb, da, la);
    }
    alive[32 * ((words - 1) >> 5) + lane] = word;
  } else if (warp == 2) {
    // the later tiles: after the chain has resolved chunk c, clear its kept
    // rows from this lane's alive words in tiles c / 32 + 1 .. T - 1
    const int chunks = min(words, 32 * (tiles - 1));  // the chunks with later tiles
    int fc = 0, ft = 1;                               // the next tile to fetch
    auto fetch = [&](long long m) {                   // tile (fc, ft), the m-th
      const int s = static_cast<int>(m % kStagesB);
      mbar_expect_tx(smem_u32(full_b + s), kTileBytes);
      bulk_load(smem_u32(ring_b + s * kTileWords),
                rel + (slab_tile(fc, tiles) + ft - (fc >> 5)) * kTileWords, kTileBytes,
                smem_u32(full_b + s));
      if (++ft == tiles) ft = (++fc >> 5) + 1;
    };
    long long fetched = 0, m = 0;
    if (lane == 0) {
      grid_dependency_wait();
      for (; fetched < kStagesB && fc < chunks; ++fetched) fetch(fetched);
    }
    for (int c = 0; c < chunks; ++c) {
      uint64_t slot;
      do {
        slot = load_volatile(kept + c);
      } while (!(slot >> 32));
      const uint32_t keep = static_cast<uint32_t>(slot);
      for (int tt = (c >> 5) + 1; tt < tiles; ++tt, ++m) {
        const int s = static_cast<int>(m % kStagesB);
        mbar_wait(smem_u32(full_b + s), static_cast<uint32_t>(m / kStagesB) & 1u);
        uint32_t later[32];
        load_column(ring_b + s * kTileWords, lane, later);
        uint32_t gone[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 32; ++b) or_if(gone[b & 3], keep, 1u << b, later[b]);
        alive[32 * tt + lane] &= ~(gone[0] | gone[1] | gone[2] | gone[3]);
        __syncwarp();  // the stage is read: it takes the tile kStagesB on
        if (lane == 0 && fc < chunks) fetch(fetched++);
      }
      if ((c & 31) == 31) mbar_arrive(smem_u32(handover));  // a group done: to warp 1
    }
  }
  __syncthreads();

  for (int i = t; i < k; i += kThreads) {
    out[i] = ((alive[i >> 5] >> (i & 31)) & 1u) ? score[i] : -1.0f;
  }
}

size_t smem_bytes(int k) {
  const size_t words = (k + 31) / 32;
  // the relation and 32 words past it: the last chunk's diagonal reads rows
  // up to 32 * words, which are not alive
  return 16 * ((words + 3) / 4) + 32 * words * (16 + 4) +
         sizeof(uint32_t) * (words * pitch(k) + 32);
}

size_t sweep_smem_bytes(int k) {
  const size_t words = (k + 31) / 32, tiles = (words + 31) / 32;
  return (kStagesA + kStagesB) * (kTileBytes + sizeof(uint64_t)) +
         (kStagesA + 1 + words) * sizeof(uint64_t) + sizeof(uint32_t) * 32 * tiles;
}

// above 48 KB of dynamic shared memory only after opting in, once per
// kernel (before any graph capture): up to `most` bytes
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t shmem, size_t most, bool& set) {
  if (shmem <= 48 * 1024 || set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
  set = err == cudaSuccess;
  return err;
}

int launch_smem(const float* x0, const float* y0, const float* x1, const float* y1,
                const float* score, float* out, int k, float iou_threshold, float threshold,
                cudaStream_t stream) {
  const size_t shmem = smem_bytes(k);
  static bool smem_set = false;  // the route's largest K
  cudaError_t err = allow_smem(nms_sweep_kernel, shmem, smem_bytes(kSmemMaxK), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  err = cudaLaunchKernelEx(&cfg, nms_sweep_kernel, x0, y0, x1, y1, score, out, k, iou_threshold,
                           nextafterf(iou_threshold, INFINITY), threshold);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

int launch_global(const float* x0, const float* y0, const float* x1, const float* y1,
                  const float* score, float* out, uint32_t* rel, int k, float iou_threshold,
                  float threshold, cudaStream_t stream) {
  const int words = (k + 31) / 32;
  cudaLaunchConfig_t build = {};  // a warp for each of the W (W + 1) / 2 word columns
  build.gridDim = dim3(static_cast<unsigned>((words * (words + 1LL) / 2 + kThreads / 32 - 1) /
                                             (kThreads / 32)));
  build.blockDim = dim3(kThreads);
  build.stream = stream;
  cudaError_t err = cudaLaunchKernelEx(&build, relation_build_kernel, x0, y0, x1, y1, rel, k,
                                       iou_threshold, nextafterf(iou_threshold, INFINITY));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t shmem = sweep_smem_bytes(k);
  static bool smem_set = false;  // the most the card gives
  err = allow_smem(relation_sweep_kernel, shmem, 227 * 1024, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t sweep = {};
  sweep.gridDim = dim3(1);
  sweep.blockDim = dim3(kThreads);
  sweep.dynamicSmemBytes = shmem;
  sweep.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  sweep.attrs = attr;
  sweep.numAttrs = 1;
  err = cudaLaunchKernelEx(&sweep, relation_sweep_kernel, score, out, rel, k, threshold);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Launches on `stream`. For K > 1024, `scratch` holds the relation's
// slab_tile(W, T) tiles of 1024 words in global memory, 16-byte aligned
// (epilogue.nms_scratch_words; null otherwise). Returns the cudaError_t of
// the launches (0 = success; cudaErrorInvalidValue for K < 1 or a missing
// scratch buffer).
extern "C" int nns_nms_sweep(const float* x0, const float* y0, const float* x1,
                             const float* y1, const float* score, float* out,
                             uint32_t* scratch, int k, float iou_threshold, float threshold,
                             void* stream) {
  if (k < 1 || (k > kSmemMaxK && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= kSmemMaxK) {
    return launch_smem(x0, y0, x1, y1, score, out, k, iou_threshold, threshold, st);
  }
  return launch_global(x0, y0, x1, y1, score, out, scratch, k, iou_threshold, threshold, st);
}
