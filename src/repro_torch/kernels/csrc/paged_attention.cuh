// Paged GQA decode attention for Hopper (sm_90a): the kernels, shared by
// paged_attention.cu (the standalone op) and decode_megastep.cu (its
// attention stage).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention_pallas / _paged_attn_kernel) and computes what
// repro.kernels.ref.paged_attention_ref computes: one query token per row
// attends over a paged K/V pool through its block table; G = H / Hkv query
// heads share each KV head; the valid window is [start_lens[b], seq_lens[b]);
// scores are scaled by 1/sqrt(Dh); a row with no valid position outputs 0.
//
// Bound: the bytes of the valid K and V rows (plus q and out) at the card's
// 3.35 TB/s — a decode query does ~2 flops per byte read, far below the
// ridge point.  What keeps a kernel from it is latency: a row's positions
// are a few hundred 256-byte K and V rows behind a block-table lookup.
//
// Design: flash-decoding.  The TPU kernel walks a sequential page axis of
// its grid and carries the online-softmax state in VMEM scratch across grid
// steps.  Here each row's positions are cut into splits of a fixed
// kSplitLen, and one CTA takes one (split, row, KV head, head group), so
// a decode batch fills the card with CTAs whose loads are all in flight at
// once; a row's result depends only on its own data, never on the batch or
// the table width.  A CTA whose split holds no valid position writes an
// empty partial (m = -inf, l = 0) and returns before any load.
//   In a split, lane group j of LPP lanes takes one position at a time and
// each lane 8 elements of Dh (one 16-byte load of bf16, two of f32), so a
// warp reads PW = 32 / LPP positions per load; each thread issues the
// table lookups, then the K and V loads of all its kSteps positions,
// before it uses any.  The CTA's query heads (at most kMaxGroup) live in
// registers, as do the scores: a butterfly over the lane group sums a
// score, each warp takes the max and the sum of exp over its own positions
// with warp shuffles and accumulates p V in registers, and one barrier
// later the CTA merges its four warps in warp order through shared memory.
// With one split the CTA writes the row's output; with more it writes an
// f32 partial (m, l, acc[Dh]) per (row, head, split) to a scratch buffer
// that the caller allocates, and merge_kernel folds a row's splits in split
// order with log-sum-exp rescaling, divides and casts to T; it is a
// programmatic dependent launch, so its launch overlaps the split grid's
// tail.  Every sum has a fixed order and nothing uses atomics: bitwise
// equal from run to run.
// Any Dh <= 256 works (16-byte loads where Dh % 8 == 0 and the pointers
// are aligned, element loads otherwise), f32 or bf16, f32 accumulate.
//
// The head group is its own grid axis: G > kMaxGroup runs ceil(G /
// kMaxGroup) CTAs per (split, row, KV head), each reading the K/V rows.
//
// Wide heads (256 < Dh <= kMaxWideDh: MLA's latent rows, Dh = R + dr =
// 576 with Hkv = 1, G = 128 and K = V the same pool) cut a row into
// splits of kWideSplitLen = 256 positions, not 64: at this layout a
// (row, split) partial is 128 heads x (576 + 2) f32 = 295,936 bytes,
// against 256 x 576 x 2 = 294,912 bytes of the latent rows it summarises
// (4x them at a split of 64).  At the engine's 512 positions a row has 2
// splits: B = 40 writes and reads 23.7 MB of partials (94.7 MB each way
// at 64), B = 8 runs 32 CTAs of 64 heads (those of rows under 257
// positions return at once) and B = 40 160, one an SM.  The length is a
// constant of the head width, so a row's result never depends on the
// batch or the table width.
//
// bf16 with K = V one pool, Dh = kLatDh and G a multiple of kLatHeads (the
// serving path's latent layout) takes latent_kernel, on the tensor cores,
// chosen from the layout alone (a launch whose q, pool or output is not
// 16-byte aligned fails; it never falls back):
//   * One CTA takes a (split, row, KV head) and kLatHeads = 64 query
//     heads: G = 128 runs two CTAs a (split, row), so each latent row is
//     read twice (the second from L2), not 32 times.  Its 64 queries are
//     staged once in shared memory (73.7 KB, swizzled rows of 72 16-byte
//     chunks); the split's 256 pool offsets are read through the block
//     table once, and its latent rows come a tile of kLatTile = 32
//     positions at a time (36.9 KB) by 16-byte cp.async into a ring of
//     kLatStages = 3, two tiles ahead; positions outside the window are
//     zero-filled, tiles wholly outside it never loaded.  The one staged
//     tile is both K and V.
//   * S = Q K^T: warp w takes 32 heads x 16 positions over half of Dh
//     (18 k-steps of mma.sync m16n8k16, ldmatrix fragments); the two
//     halves' f32 partials meet in shared memory and are summed in half
//     order.
//   * Softmax: warp w owns heads 8w .. 8w + 7, a quad of lanes a head,
//     a lane 8 of the tile's positions: one expf per (head, position),
//     the head's max and sum over its quad by two shuffles, an online
//     (m, l) per head across the split's tiles; p rounded to bf16 (as the
//     plain version's p.to(v.dtype)) into shared memory, with each head's
//     rescale factor.
//   * O += P V: warp w owns output columns 72w .. 72w + 71 of all 64
//     heads (4 x 9 m16n8 tiles, 144 f32 registers a thread), P by
//     ldmatrix, V by ldmatrix.trans from the same tile.
//   * 256 threads, one CTA an SM (212,480 bytes of shared memory, 235
//     registers a thread); the split's (m, l, acc) go to the partials, or
//     with one split the row's output, as wide_kernel's, O staged
//     through the freed q and ring memory so that rows leave in 16-byte
//     stores.
//   What bounds it on an H100 (scripts/latent_phases.py): a 32-position
//   tile costs a CTA ~3 us, S = QK^T ~1.2 (1,152 mma.sync in all and 221
//   KB of ldmatrix reads), P V ~0.75, the softmax and its barrier ~0.7,
//   the wait ~0.6; so the 8-tile CTAs of a full split set a call's pace.
//   Running S of the next tile beside P V of this one (half the warps in
//   each order) measured no faster: the two share the SM's mma.sync and
//   shared-memory pipes.  wgmma, reading both operands from shared
//   memory at twice the rate, is the next step.
// f32 (which the tensor cores would multiply as TF32, past the 1e-4
// tolerance), K and V as two pools, other widths and head counts take
// wide_kernel: the same grid, splits and merge, but a whole warp reads
// one position, lane l holding chunks l, l + 32, ... (NC of them) of its
// 8 elements, so a row of 576 is 72 chunks over the 32 lanes.  A thread
// cannot hold all of its 64 positions' rows at that width, so a warp walks
// them kBatch at a time (lookups, then every load of the batch, then the
// scores) with an online softmax across batches; the CTA's query heads
// sit in shared memory, read a chunk at a time against the batch's rows.
// Where K and V are one pool each row is loaded once and serves as both.
// paged::launch picks the kernel from the type, the pools and the shapes,
// never from a failure.
//
// lse (optional, f32 (B, H)): the natural-log log-sum-exp of each row's
// scaled scores over its valid positions, m + log(l) from the same (m, l)
// that normalise the row; with it, out is f32 (B, H, Dh) instead of T, so
// that partials of one row over disjoint position ranges (a context-
// parallel decode's ranks) merge exactly by their lse.  A row with no
// valid position gives lse = -inf and out = 0.  Without it (null) every
// kernel computes and stores what it did before, bit for bit.
#pragma once
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace paged {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitLen = 64;     // positions per split, Dh <= kMaxDh
constexpr int kWideSplitLen = 256;  // positions per split, Dh > kMaxDh
constexpr int kMaxGroup = 4;      // query heads one CTA holds in registers
constexpr int kVec = 8;           // elements of Dh per lane
constexpr int kMaxDh = 256;
constexpr int kMaxWideDh = 768;   // wide_kernel: 3 chunks a lane
constexpr int kMergeThreads = 128;
constexpr float kNegInf = -1e30f;

// One output element: in T, or in f32 where the call asked for the lse.
template <typename T>
__device__ __forceinline__ void store_out(T* out, const float* lse,
                                          long long i, float v) {
  if (lse != nullptr) reinterpret_cast<float*>(out)[i] = v;
  else out[i] = from_float<T>(v);
}

// A split's length: a constant of the head width.
inline int split_len(int Dh) {
  return Dh > kMaxDh ? kWideSplitLen : kSplitLen;
}

inline int n_splits(int bs, int max_blk, int Dh) {
  const int sl = split_len(Dh);
  const long long n = ((long long)bs * max_blk + sl - 1) / sl;
  return n > 1 ? (int)n : 1;
}

// Scratch of one launch: per (row, query head, split) m and l, then
// acc[Dh], all f32; none with a single split.
inline size_t scratch_bytes(int B, int H, int Dh, int bs, int max_blk) {
  const int ns = n_splits(bs, max_blk, Dh);
  return ns == 1 ? 0 : (size_t)B * H * ns * (Dh + 2) * sizeof(float);
}

// The scratch's layout: m (BH, ns), l (BH, ns), acc (BH, ns, Dh), f32.
struct Part {
  float* base;
  long long BH;
  int ns, Dh;
  __device__ float* m(long long row, int s) const {
    return base + row * ns + s;
  }
  __device__ float* l(long long row, int s) const {
    return base + (BH + row) * ns + s;
  }
  __device__ float* acc(long long row, int s) const {
    return base + 2 * BH * ns + (row * ns + s) * Dh;
  }
};

// kVec elements of T held as raw 16-byte words until they are used.
template <typename T>
struct Chunk {
  static constexpr int kWords = kVec * (int)sizeof(T) / 16;
  uint4 w[kWords];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = make_uint4(0, 0, 0, 0);
  }
  // the 0 < n <= kVec elements at p (vec: 16-byte loads, n == kVec)
  __device__ __forceinline__ void load(const T* p, int n, bool vec) {
    if (vec && n == kVec) {
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
    } else {
      uint32_t bits[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) bits[e] = e < n ? raw(p[e]) : 0u;
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        w[i] = make_uint4(pack(bits, 4 * i), pack(bits, 4 * i + 1),
                          pack(bits, 4 * i + 2), pack(bits, 4 * i + 3));
    }
  }
  __device__ __forceinline__ float at(int e) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(word(w[e / 4], e % 4));
    } else {
      const uint32_t x = word(w[e / 8], (e % 8) / 2);
      return __uint_as_float(e % 2 ? x & 0xffff0000u : x << 16);
    }
  }

 private:
  static __device__ __forceinline__ uint32_t raw(float x) {
    return __float_as_uint(x);
  }
  static __device__ __forceinline__ uint32_t raw(__nv_bfloat16 x) {
    return __bfloat16_as_ushort(x);
  }
  // 32-bit word j of the chunk from the elements' bits
  static __device__ __forceinline__ uint32_t pack(const uint32_t* bits,
                                                  int j) {
    if constexpr (sizeof(T) == 4) return bits[j];
    else return bits[2 * j] | (bits[2 * j + 1] << 16);
  }
  static __device__ __forceinline__ uint32_t word(const uint4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};

// One (split, row, KV head, head group).  part: the scratch (Part, BH =
// B * H); unused (null) with one split, where the CTA writes out itself.
template <typename T, int GT, int LPP>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ seq_lens, const int* __restrict__ start_lens,
    T* __restrict__ out, float* __restrict__ part, float* __restrict__ lse,
    int B, int H, int Hkv, int Dh, int bs, int max_blk, int n_hg,
    float scale, bool vec) {
  constexpr int PW = 32 / LPP;                      // positions per warp load
  constexpr int kSteps = kSplitLen / (kWarps * PW);  // positions per thread
  static_assert(kSteps * kWarps * PW == kSplitLen, "split length");
  __shared__ float m_w[kWarps][GT], l_w[kWarps][GT];
  __shared__ float acc_w[kWarps][GT][kMaxDh];

  // let the merge kernel launch while this grid's CTAs finish (it waits
  // for the whole grid before it reads a partial)
  asm volatile("griddepcontrol.launch_dependents;");
  const int split = blockIdx.x;
  const int ns = gridDim.x;
  int r = blockIdx.y;
  const int hg = r % n_hg;
  r /= n_hg;
  const int h = r % Hkv;
  const int b = r / Hkv;
  const int G = H / Hkv;
  const int g0 = hg * GT;
  const int heads = min(GT, G - g0);                // live heads of the CTA
  const long long bh0 = (long long)b * H + (long long)h * G + g0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int end = min(seq_lens[b], max_blk * bs);
  const int begin = start_lens != nullptr ? max(start_lens[b], 0) : 0;
  const int lo = max(begin, split * kSplitLen);
  const int hi = min(end, (split + 1) * kSplitLen);
  if (lo >= hi) {   // no valid position: an empty partial, no K/V load
    if (ns == 1) {
      for (int i = tid; i < heads * Dh; i += kThreads)
        store_out(out, lse, bh0 * Dh + i, 0.f);
      if (lse != nullptr && tid < heads) lse[bh0 + tid] = -INFINITY;
    } else if (tid < heads) {
      const Part pa{part, (long long)B * H, ns, Dh};
      *pa.m(bh0 + tid, split) = kNegInf;
      *pa.l(bh0 + tid, split) = 0.f;
    }
    return;
  }

  const int grp = lane / LPP;             // the warp's position slot
  const int li = lane % LPP;              // the lane's chunk of Dh
  const int d0 = li * kVec;
  const int nd = max(0, min(kVec, Dh - d0));

  // the CTA's query heads, this lane's chunk of Dh (0 past Dh / heads)
  float qf[GT][kVec];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      qf[g][e] = g < heads && e < nd ? to_float(q[(bh0 + g) * Dh + d0 + e])
                                     : 0.f;

  // every lookup, then every K and V load, before any is used
  const long long row_stride = (long long)Hkv * Dh;
  long long off[kSteps];
  bool ok[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int pos = split * kSplitLen + (i * kWarps + warp) * PW + grp;
    ok[i] = pos >= lo && pos < hi;
    off[i] = 0;
    if (ok[i]) {
      const long long blk = tables[(long long)b * max_blk + pos / bs];
      off[i] = (blk * bs + pos % bs) * row_stride + (long long)h * Dh + d0;
    }
  }
  Chunk<T> kc[kSteps], vc[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    if (ok[i] && nd > 0) {
      kc[i].load(k_pool + off[i], nd, vec);
      vc[i].load(v_pool + off[i], nd, vec);
    } else {
      kc[i].zero();
      vc[i].zero();
    }
  }

  // scores: each lane's 8 products, then a butterfly over its lane group
  float s[kSteps][GT];
#pragma unroll
  for (int i = 0; i < kSteps; ++i)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) a = fmaf(qf[g][e], kc[i].at(e), a);
#pragma unroll
      for (int o = LPP / 2; o > 0; o >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, o);
      s[i][g] = ok[i] ? a * scale : kNegInf;
    }

  // the warp's softmax over its own positions: max, exp, sum, p @ V
  float mx[GT], ls[GT], acc[GT][kVec];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    mx[g] = kNegInf;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) mx[g] = fmaxf(mx[g], s[i][g]);
#pragma unroll
    for (int o = LPP; o < 32; o <<= 1)
      mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
    ls[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kSteps; ++i)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float p = ok[i] ? expf(s[i][g] - mx[g]) : 0.f;
      ls[g] += p;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[g][e] = fmaf(p, vc[i].at(e), acc[g][e]);
    }
  // sum over the warp's lane groups (each group's lanes hold the same ls)
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int o = LPP; o < 32; o <<= 1) {
      ls[g] += __shfl_xor_sync(0xffffffffu, ls[g], o);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (e < nd) acc_w[warp][g][d0 + e] = acc[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) m_w[warp][g] = mx[g], l_w[warp][g] = ls[g];
  }
  __syncthreads();

  // merge the warps in warp order (a warp with no valid position has l 0)
  for (int i = tid; i < heads * Dh; i += kThreads) {
    const int g = i / Dh;
    const int d = i - g * Dh;
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      if (l_w[w][g] > 0.f) m = fmaxf(m, m_w[w][g]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      if (l_w[w][g] > 0.f) {
        const float c = expf(m_w[w][g] - m);
        l += l_w[w][g] * c;
        a += acc_w[w][g][d] * c;
      }
    }
    const long long row = bh0 + g;
    if (ns == 1) {
      store_out(out, lse, row * Dh + d, a / l);
      if (lse != nullptr && d == 0) lse[row] = m + logf(l);
    } else {
      const Part pa{part, (long long)B * H, ns, Dh};
      pa.acc(row, split)[d] = a;
      if (d == 0) *pa.m(row, split) = m, *pa.l(row, split) = l;
    }
  }
}

// Fold one (row, head)'s splits in split order: out = sum acc_s e^(m_s - M)
// / sum l_s e^(m_s - M), or exactly 0 for a row with no valid position.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(
    const float* __restrict__ part, T* __restrict__ out,
    float* __restrict__ lse, int BH, int Dh, int ns) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the split grid
  const long long row = blockIdx.x;
  const Part pa{const_cast<float*>(part), BH, ns, Dh};
  const float* m = pa.m(row, 0);
  const float* l = pa.l(row, 0);
  const float* acc = pa.acc(row, 0);
  float M = kNegInf;
  for (int s = 0; s < ns; ++s)
    if (l[s] > 0.f) M = fmaxf(M, m[s]);
  for (int d = threadIdx.x; d < Dh; d += kMergeThreads) {
    float L = 0.f, a = 0.f;
    for (int s = 0; s < ns; ++s) {
      if (l[s] > 0.f) {
        const float c = expf(m[s] - M);
        L += l[s] * c;
        a += acc[(long long)s * Dh + d] * c;
      }
    }
    store_out(out, lse, row * Dh + d, L > 0.f ? a / L : 0.f);
    if (lse != nullptr && d == 0) lse[row] = L > 0.f ? M + logf(L) : -INFINITY;
  }
}

// One (split, row, KV head, head group) of a wide head (kMaxDh < Dh <=
// NC * 256): the warp reads a position whole, lane l chunks l + 32 j (j <
// NC), kBatch positions at a time, with an online softmax over its
// batches.  SAME: K and V are one pool, read once.  Dynamic shared memory:
// q_s[GT][NC * 256] (zeros past Dh), then acc_w[kWarps][GT][Dh].
template <typename T, int NC, bool SAME>
__global__ void __launch_bounds__(kThreads) wide_kernel(
    const T* __restrict__ q, const T* k_pool, const T* v_pool,
    const int* __restrict__ tables, const int* __restrict__ seq_lens,
    const int* __restrict__ start_lens, T* __restrict__ out,
    float* __restrict__ part, float* __restrict__ lse, int B, int H, int Hkv,
    int Dh, int bs, int max_blk, int n_hg, float scale, bool vec) {
  constexpr int GT = kMaxGroup;
  constexpr int kDp = NC * 32 * kVec;                // q_s row, padded
  constexpr int kSteps = kWideSplitLen / kWarps;         // positions per warp
  constexpr int kBatch = 8 / (int)sizeof(T);         // positions a batch
  static_assert(kSteps % kBatch == 0, "batches");
  extern __shared__ __align__(16) float wide_smem[];
  float* q_s = wide_smem;                            // GT * kDp
  float* acc_w = q_s + GT * kDp;                     // kWarps * GT * Dh
  __shared__ float m_w[kWarps][GT], l_w[kWarps][GT];

  asm volatile("griddepcontrol.launch_dependents;");
  const int split = blockIdx.x;
  const int ns = gridDim.x;
  int r = blockIdx.y;
  const int hg = r % n_hg;
  r /= n_hg;
  const int h = r % Hkv;
  const int b = r / Hkv;
  const int G = H / Hkv;
  const int g0 = hg * GT;
  const int heads = min(GT, G - g0);
  const long long bh0 = (long long)b * H + (long long)h * G + g0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int end = min(seq_lens[b], max_blk * bs);
  const int begin = start_lens != nullptr ? max(start_lens[b], 0) : 0;
  const int lo = max(begin, split * kWideSplitLen);
  const int hi = min(end, (split + 1) * kWideSplitLen);
  if (lo >= hi) {   // no valid position: an empty partial, no K/V load
    if (ns == 1) {
      for (int i = tid; i < heads * Dh; i += kThreads)
        store_out(out, lse, bh0 * Dh + i, 0.f);
      if (lse != nullptr && tid < heads) lse[bh0 + tid] = -INFINITY;
    } else if (tid < heads) {
      const Part pa{part, (long long)B * H, ns, Dh};
      *pa.m(bh0 + tid, split) = kNegInf;
      *pa.l(bh0 + tid, split) = 0.f;
    }
    return;
  }
  for (int i = tid; i < GT * kDp; i += kThreads) {
    const int g = i / kDp, d = i - g * kDp;
    q_s[i] = g < heads && d < Dh ? to_float(q[(bh0 + g) * Dh + d]) : 0.f;
  }
  __syncthreads();

  int nd[NC];                     // this lane's elements in chunk j
#pragma unroll
  for (int j = 0; j < NC; ++j)
    nd[j] = max(0, min(kVec, Dh - (lane + 32 * j) * kVec));
  const long long row_stride = (long long)Hkv * Dh;
  float m[GT], l[GT], acc[GT][NC][kVec];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][j][e] = 0.f;
  }

  for (int i0 = 0; i0 < kSteps; i0 += kBatch) {
    // the batch's positions (warp-uniform), lookups, then every load
    bool ok[kBatch];
    long long off[kBatch];
    bool any = false;
#pragma unroll
    for (int p = 0; p < kBatch; ++p) {
      const int pos = split * kWideSplitLen + (i0 + p) * kWarps + warp;
      ok[p] = pos >= lo && pos < hi;
      any |= ok[p];
      off[p] = 0;
      if (ok[p]) {
        const long long blk = tables[(long long)b * max_blk + pos / bs];
        off[p] = (blk * bs + pos % bs) * row_stride + (long long)h * Dh;
      }
    }
    if (!any) continue;
    Chunk<T> kc[kBatch][NC];
    Chunk<T> vc[SAME ? 1 : kBatch][NC];
#pragma unroll
    for (int p = 0; p < kBatch; ++p)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int d0 = (lane + 32 * j) * kVec;
        if (ok[p] && nd[j] > 0) {
          kc[p][j].load(k_pool + off[p] + d0, nd[j], vec);
          if constexpr (!SAME) vc[p][j].load(v_pool + off[p] + d0, nd[j], vec);
        } else {
          kc[p][j].zero();
          if constexpr (!SAME) vc[p][j].zero();
        }
      }

    // scores: each lane's products, then a butterfly over the warp
    float s[kBatch][GT];
#pragma unroll
    for (int p = 0; p < kBatch; ++p)
#pragma unroll
      for (int g = 0; g < GT; ++g) s[p][g] = 0.f;
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4* qp = reinterpret_cast<const float4*>(
            q_s + g * kDp + (lane + 32 * j) * kVec);
        const float4 qa = qp[0], qb = qp[1];
        const float qv[kVec] = {qa.x, qa.y, qa.z, qa.w,
                                qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int p = 0; p < kBatch; ++p)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            s[p][g] = fmaf(qv[e], kc[p][j].at(e), s[p][g]);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int p = 0; p < kBatch; ++p)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[p][g] += __shfl_xor_sync(0xffffffffu, s[p][g], o);

    // the online softmax over the warp's batches
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float bm = kNegInf;
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        s[p][g] = ok[p] ? s[p][g] * scale : kNegInf;
        bm = fmaxf(bm, s[p][g]);
      }
      const float mn = fmaxf(m[g], bm);
      const float corr = expf(m[g] - mn);
      m[g] = mn;
      l[g] *= corr;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][j][e] *= corr;
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        const float pe = ok[p] ? expf(s[p][g] - mn) : 0.f;
        l[g] += pe;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const Chunk<T>& v = SAME ? kc[p][j] : vc[SAME ? 0 : p][j];
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[g][j][e] = fmaf(pe, v.at(e), acc[g][j][e]);
        }
      }
    }
  }

  // hand the warp's state to shared memory; a warp with no valid
  // position has l = 0 and is skipped by the merge
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (e < nd[j])
          acc_w[(warp * GT + g) * Dh + (lane + 32 * j) * kVec + e] =
              acc[g][j][e];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) m_w[warp][g] = m[g], l_w[warp][g] = l[g];
  }
  __syncthreads();

  // merge the warps in warp order, as split_kernel
  for (int i = tid; i < heads * Dh; i += kThreads) {
    const int g = i / Dh;
    const int d = i - g * Dh;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      if (l_w[w][g] > 0.f) mm = fmaxf(mm, m_w[w][g]);
    float ll = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      if (l_w[w][g] > 0.f) {
        const float c = expf(m_w[w][g] - mm);
        ll += l_w[w][g] * c;
        a += acc_w[(w * GT + g) * Dh + d] * c;
      }
    }
    const long long row = bh0 + g;
    if (ns == 1) {
      store_out(out, lse, row * Dh + d, a / ll);
      if (lse != nullptr && d == 0) lse[row] = mm + logf(ll);
    } else {
      const Part pa{part, (long long)B * H, ns, Dh};
      pa.acc(row, split)[d] = a;
      if (d == 0) *pa.m(row, split) = mm, *pa.l(row, split) = ll;
    }
  }
}

inline size_t wide_smem_bytes(int Dh, int nc) {
  return sizeof(float) * (size_t)kMaxGroup * (nc * 32 * kVec + kWarps * Dh);
}

template <typename T, int NC, bool SAME>
cudaError_t launch_wide_nc(const T* q, const T* k_pool, const T* v_pool,
                           const int* tables, const int* seq_lens,
                           const int* start_lens, T* out, float* part,
                           float* lse, int B, int H, int Hkv, int Dh, int bs,
                           int max_blk, int n_hg, dim3 grid, bool vec,
                           cudaStream_t stream) {
  const size_t smem = wide_smem_bytes(Dh, NC);
  // always set: the static m_w / l_w count toward the default 48 KB
  cudaError_t err = cudaFuncSetAttribute(
      wide_kernel<T, NC, SAME>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  wide_kernel<T, NC, SAME><<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, tables, seq_lens, start_lens, out, part, lse, B, H,
      Hkv, Dh, bs, max_blk, n_hg, 1.0f / sqrtf((float)Dh), vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const T* q, const T* k_pool, const T* v_pool,
                        const int* tables, const int* seq_lens,
                        const int* start_lens, T* out, float* part,
                        float* lse, int B, int H, int Hkv, int Dh, int bs,
                        int max_blk, int n_hg, dim3 grid, bool vec,
                        cudaStream_t stream) {
  const bool same = k_pool == v_pool;
#define PAGED_WIDE(NC, SAME)                                                  \
  launch_wide_nc<T, NC, SAME>(q, k_pool, v_pool, tables, seq_lens,            \
                              start_lens, out, part, lse, B, H, Hkv, Dh, bs,  \
                              max_blk, n_hg, grid, vec, stream)
  if (Dh <= 2 * 32 * kVec) return same ? PAGED_WIDE(2, true)
                                       : PAGED_WIDE(2, false);
  return same ? PAGED_WIDE(3, true) : PAGED_WIDE(3, false);
#undef PAGED_WIDE
}

// ---------------------------------------------- latent_kernel (bf16) ----

constexpr int kLatDh = 576;        // MLA's R + dr
constexpr int kLatHeads = 64;      // query heads a CTA
constexpr int kLatTile = 32;       // positions a staged tile
constexpr int kLatStages = 3;      // tiles in the ring
constexpr int kLatThreads = 256;
constexpr int kLatWarps = kLatThreads / 32;
constexpr int kLatSRow = kLatTile + 8;   // f32 score row, padded
constexpr int kLatPRow = kLatTile + 8;   // bf16 p row, padded (80 bytes)

// Dynamic shared memory: q_s (kLatHeads x DH bf16), the ring (kLatStages
// x kLatTile x DH bf16), the two k-halves' scores (f32), p (bf16), per
// head the rescale factor and l (f32), and the element offset of each of
// the split's positions in the pool (i64, -1 outside the window).
template <int DH>
constexpr size_t latent_smem_bytes() {
  return 2 * ((size_t)kLatHeads * DH + (size_t)kLatStages * kLatTile * DH) +
         4 * (size_t)2 * kLatHeads * kLatSRow +
         2 * (size_t)kLatHeads * kLatPRow + 4 * (size_t)2 * kLatHeads +
         8 * (size_t)kWideSplitLen;
}

// One (split, row, KV head, group of kLatHeads query heads) of a bf16
// latent pool that serves as K and V (the design is in the note at the
// top).  part: as split_kernel's.
template <int DH>
__global__ void __launch_bounds__(kLatThreads, 1) latent_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ pool,
    const int* __restrict__ tables, const int* __restrict__ seq_lens,
    const int* __restrict__ start_lens, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, float* __restrict__ lse, int B, int H, int Hkv,
    int bs, int max_blk, int n_hg, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int kCh = DH / 8;              // 16-byte chunks a row
  constexpr int kKHalf = DH / 32;          // k-steps of a warp's half of DH
  constexpr int kNT = DH / 8 / kLatWarps;  // 8-column tiles a warp's P V
  constexpr int kRows = kLatHeads / kLatWarps;   // softmax heads a warp
  constexpr int kORow = DH + 8;            // f32 output row, padded
  static_assert(kCh % 8 == 0 && DH % (8 * kLatWarps) == 0, "head width");
  static_assert(kLatTile == 32 && kLatHeads == 64 && kLatWarps == 8,
                "the warp roles below");
  static_assert(kLatTile * kCh % kLatThreads == 0, "a tile's copies");
  static_assert(2 * kLatHeads * kORow <=
                    (kLatHeads + kLatStages * kLatTile) * DH,
                "the output's staging fits over q_s and the ring");
  extern __shared__ __align__(128) unsigned char lat_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(lat_smem);
  bf16* kv_s = q_s + kLatHeads * DH;
  float* s_s = reinterpret_cast<float*>(kv_s + kLatStages * kLatTile * DH);
  bf16* p_s = reinterpret_cast<bf16*>(s_s + 2 * kLatHeads * kLatSRow);
  float* corr_s = reinterpret_cast<float*>(p_s + kLatHeads * kLatPRow);
  float* l_s = corr_s + kLatHeads;
  long long* off_s = reinterpret_cast<long long*>(l_s + kLatHeads);

  asm volatile("griddepcontrol.launch_dependents;");
  const int split = blockIdx.x;
  const int ns = gridDim.x;
  int r = blockIdx.y;
  const int hg = r % n_hg;
  r /= n_hg;
  const int h = r % Hkv;
  const int b = r / Hkv;
  const long long bh0 =
      (long long)b * H + (long long)h * (H / Hkv) + hg * kLatHeads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;

  const int end = min(seq_lens[b], max_blk * bs);
  const int begin = start_lens != nullptr ? max(start_lens[b], 0) : 0;
  const int s0 = split * kWideSplitLen;
  const int lo = max(begin, s0);
  const int hi = min(end, s0 + kWideSplitLen);
  if (lo >= hi) {   // no valid position: an empty partial, no load
    if (ns == 1) {
      for (int i = tid; i < kLatHeads * DH; i += kLatThreads)
        store_out(out, lse, bh0 * DH + i, 0.f);
      if (lse != nullptr && tid < kLatHeads) lse[bh0 + tid] = -INFINITY;
    } else if (tid < kLatHeads) {
      const Part pa{part, (long long)B * H, ns, DH};
      *pa.m(bh0 + tid, split) = kNegInf;
      *pa.l(bh0 + tid, split) = 0.f;
    }
    return;
  }
  // the tiles that hold a valid position: [t_first, t_first + nt)
  const int t_first = (lo - s0) / kLatTile;
  const int nt = (hi - 1 - s0) / kLatTile - t_first + 1;

  // the split's positions through the block table, once; then the
  // queries and the first tiles: 16-byte copies, rows swizzled
  const long long row_stride = (long long)Hkv * DH;
  const int* tab = tables + (long long)b * max_blk;
  for (int i = tid; i < kWideSplitLen; i += kLatThreads) {
    const int pos = s0 + i;
    off_s[i] = pos >= lo && pos < hi
                   ? ((long long)tab[pos / bs] * bs + pos % bs) * row_stride
                   : -1;
  }
  for (int c = tid; c < kLatHeads * kCh; c += kLatThreads) {
    const int rr = c / kCh, ci = c - rr * kCh;
    cp_async16(q_s + swz(rr, ci, kCh), q + (bh0 + rr) * DH + ci * 8);
  }
  __syncthreads();   // off_s
  const bf16* pool_h = pool + (long long)h * DH;
  auto load_tile = [&](int buf, int i) {
    const long long* off = off_s + (t_first + i) * kLatTile;
    bf16* dst = kv_s + buf * kLatTile * DH;
#pragma unroll
    for (int j = 0; j < kLatTile * kCh / kLatThreads; ++j) {
      const int c = tid + j * kLatThreads;
      const int rr = c / kCh, ci = c - rr * kCh;
      const long long o = off[rr];
      cp_async16(dst + swz(rr, ci, kCh),
                 o >= 0 ? pool_h + o + ci * 8 : pool_h, o >= 0 ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kLatStages - 1; ++st) {   // q joins the first group
    if (st < nt) load_tile(st, st);
    cp_async_commit();
  }

  // warp roles: S = Q K^T over heads 32 mh.., positions 16 nh.., k-steps
  // 18 kh..; softmax over heads kRows * warp..; P V over columns 8 kNT
  // warp..; the output through shared memory, a row's columns in order
  const int mh = warp & 1, nh = (warp >> 1) & 1, kh = warp >> 2;
  const int c0w = warp * kNT;   // the warp's first 8-column chunk of P V
  const int srow = warp * kRows + (lane >> 2), q8 = (lane & 3) * 8;
  float m_run = kNegInf, l_run = 0.f;   // head srow's, over the tiles
  float o[4][kNT][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      o[mi][n][0] = o[mi][n][1] = o[mi][n][2] = o[mi][n][3] = 0.f;
  auto tile_of = [&](int t) {
    return kv_s + (t % kLatStages) * kLatTile * DH;
  };

  // S partials of tile t: 2 x 2 m16n8 tiles over this warp's half of DH
  auto scores = [&](int t) {
    const bf16* kt = tile_of(t);
    float s[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        s[mi][ni][0] = s[mi][ni][1] = s[mi][ni][2] = s[mi][ni][3] = 0.f;
    const int qrow = mh * 32 + (lane & 15);
    const int krow = nh * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll 6
    for (int kk = 0; kk < kKHalf; ++kk) {
      const int ks = kh * kKHalf + kk;
      uint32_t a0[4], a1[4], kb[4];
      ldmatrix_x4(a0, q_s + swz(qrow, ks * 2 + (lane >> 4), kCh));
      ldmatrix_x4(a1, q_s + swz(qrow + 16, ks * 2 + (lane >> 4), kCh));
      ldmatrix_x4(kb, kt + swz(krow, ks * 2 + ((lane >> 3) & 1), kCh));
      mma_bf16(s[0][0], a0, kb[0], kb[1]);
      mma_bf16(s[0][1], a0, kb[2], kb[3]);
      mma_bf16(s[1][0], a1, kb[0], kb[1]);
      mma_bf16(s[1][1], a1, kb[2], kb[3]);
    }
    float* sp = s_s + kh * kLatHeads * kLatSRow;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int row = mh * 32 + mi * 16 + g8;
        const int col = nh * 16 + ni * 8 + 2 * t4;
        *reinterpret_cast<float2*>(sp + row * kLatSRow + col) =
            make_float2(s[mi][ni][0], s[mi][ni][1]);
        *reinterpret_cast<float2*>(sp + (row + 8) * kLatSRow + col) =
            make_float2(s[mi][ni][2], s[mi][ni][3]);
      }
  };

  // online softmax of tile t, one expf per (head, position): lane l takes
  // head srow and the tile's positions q8 .. q8 + 7, its row's max and sum
  // over the four lanes of its quad
  auto softmax = [&](int t) {
    float x[8];
    const float4* h0 =
        reinterpret_cast<const float4*>(s_s + srow * kLatSRow + q8);
    const float4* h1 = reinterpret_cast<const float4*>(
        s_s + (kLatHeads + srow) * kLatSRow + q8);
    const float4 a0 = h0[0], a1 = h0[1], b0 = h1[0], b1 = h1[1];
    x[0] = a0.x + b0.x, x[1] = a0.y + b0.y, x[2] = a0.z + b0.z;
    x[3] = a0.w + b0.w, x[4] = a1.x + b1.x, x[5] = a1.y + b1.y;
    x[6] = a1.z + b1.z, x[7] = a1.w + b1.w;
    const int pos0 = s0 + (t_first + t) * kLatTile + q8;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = pos0 + j >= lo && pos0 + j < hi ? x[j] * scale : kNegInf;
      mx = fmaxf(mx, x[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m_run, mx);
    const float corr = expf(m_run - mn);
    m_run = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = x[j] != kNegInf ? expf(x[j] - mn) : 0.f;
      ps += x[j];
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l_run = l_run * corr + ps;
    *reinterpret_cast<uint4*>(p_s + srow * kLatPRow + q8) =
        make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                   pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
    if ((lane & 3) == 0) corr_s[srow] = corr;
  };

  // O = O * corr + P V of tile t over this warp's columns, V the same tile
  auto values = [&](int t) {
    const bf16* kt = tile_of(t);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const float c0 = corr_s[mi * 16 + g8], c1 = corr_s[mi * 16 + g8 + 8];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        o[mi][n][0] *= c0;
        o[mi][n][1] *= c0;
        o[mi][n][2] *= c1;
        o[mi][n][3] *= c1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kLatTile / 16; ++kk) {
      uint32_t pa[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(pa[mi], p_s + (mi * 16 + (lane & 15)) * kLatPRow +
                                kk * 16 + (lane >> 4) * 8);
      const int vr = kk * 16 + (lane & 15);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, kt + swz(vr, c0w + np * 2 + (lane >> 4), kCh));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(o[mi][2 * np], pa[mi], vb[0], vb[1]);
          mma_bf16(o[mi][2 * np + 1], pa[mi], vb[2], vb[3]);
        }
      }
      if constexpr (kNT % 2 == 1) {
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, kt + swz(vr, c0w + kNT - 1, kCh));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          mma_bf16(o[mi][kNT - 1], pa[mi], vb[0], vb[1]);
      }
    }
  };

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kLatStages - 2>();   // tile it (and q) has landed
    __syncthreads();                   // ... for all; tile it - 1 is done
    const int nxt = it + kLatStages - 1;
    if (nxt < nt) load_tile(nxt % kLatStages, nxt);
    cp_async_commit();
    scores(it);
    __syncthreads();
    softmax(it);
    __syncthreads();
    values(it);
  }
  cp_async_wait<0>();

  // the heads' (m, l): the split's partial, or the row's output; then O
  // through shared memory (over q_s and the ring) so that each row leaves
  // in 16-byte stores, a warp's in the row's order
  const Part pa{part, (long long)B * H, ns, DH};
  if ((lane & 3) == 0) {
    l_s[srow] = l_run;
    if (ns == 1 && lse != nullptr) lse[bh0 + srow] = m_run + logf(l_run);
    if (ns > 1) {
      *pa.m(bh0 + srow, split) = m_run;
      *pa.l(bh0 + srow, split) = l_run;
    }
  }
  __syncthreads();   // every warp is done with q_s and the ring
  float* o_s = reinterpret_cast<float*>(lat_smem);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int row = mi * 16 + g8, col = (c0w + n) * 8 + 2 * t4;
      *reinterpret_cast<float2*>(o_s + row * kORow + col) =
          make_float2(o[mi][n][0], o[mi][n][1]);
      *reinterpret_cast<float2*>(o_s + (row + 8) * kORow + col) =
          make_float2(o[mi][n][2], o[mi][n][3]);
    }
  __syncthreads();
  if (ns == 1 && lse != nullptr) {   // f32 rows, 16-byte stores
    float* o32 = reinterpret_cast<float*>(out);
    for (int c = tid; c < kLatHeads * DH / 4; c += kLatThreads) {
      const int row = c / (DH / 4), c4 = c - row * (DH / 4);
      const float l = l_s[row];
      const float4 u = *reinterpret_cast<const float4*>(o_s + row * kORow +
                                                        c4 * 4);
      *reinterpret_cast<float4*>(o32 + (bh0 + row) * DH + c4 * 4) =
          make_float4(u.x / l, u.y / l, u.z / l, u.w / l);
    }
  } else if (ns == 1) {
    for (int c = tid; c < kLatHeads * kCh; c += kLatThreads) {
      const int row = c / kCh, ci = c - row * kCh;
      const float l = l_s[row];
      const float4 u = *reinterpret_cast<const float4*>(o_s + row * kORow +
                                                        ci * 8);
      const float4 w = *reinterpret_cast<const float4*>(o_s + row * kORow +
                                                        ci * 8 + 4);
      *reinterpret_cast<uint4*>(out + (bh0 + row) * DH + ci * 8) =
          make_uint4(pack_bf16(u.x / l, u.y / l), pack_bf16(u.z / l, u.w / l),
                     pack_bf16(w.x / l, w.y / l), pack_bf16(w.z / l, w.w / l));
    }
  } else {
    for (int c = tid; c < kLatHeads * DH / 4; c += kLatThreads) {
      const int row = c / (DH / 4), c4 = c - row * (DH / 4);
      *reinterpret_cast<float4*>(pa.acc(bh0 + row, split) + c4 * 4) =
          *reinterpret_cast<const float4*>(o_s + row * kORow + c4 * 4);
    }
  }
}

template <int DH>
cudaError_t launch_latent(const __nv_bfloat16* q, const __nv_bfloat16* pool,
                          const int* tables, const int* seq_lens,
                          const int* start_lens, __nv_bfloat16* out,
                          float* part, float* lse, int B, int H, int Hkv,
                          int bs, int max_blk, dim3 grid,
                          cudaStream_t stream) {
  constexpr size_t smem = latent_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      latent_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  latent_kernel<DH><<<grid, kLatThreads, smem, stream>>>(
      q, pool, tables, seq_lens, start_lens, out, part, lse, B, H, Hkv, bs,
      max_blk, H / Hkv / kLatHeads, 1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

template <typename T, int GT>
cudaError_t launch_gt(const T* q, const T* k_pool, const T* v_pool,
                      const int* tables, const int* seq_lens,
                      const int* start_lens, T* out, float* part, float* lse,
                      int B, int H, int Hkv, int Dh, int bs, int max_blk,
                      int n_hg, dim3 grid, bool vec, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)Dh);
  const int lanes = (Dh + kVec - 1) / kVec;
#define PAGED_SPLIT(LPP)                                                     \
  split_kernel<T, GT, LPP><<<grid, kThreads, 0, stream>>>(                   \
      q, k_pool, v_pool, tables, seq_lens, start_lens, out, part, lse, B, H, \
      Hkv, Dh, bs, max_blk, n_hg, scale, vec)
  if (lanes <= 8) PAGED_SPLIT(8);
  else if (lanes <= 16) PAGED_SPLIT(16);
  else PAGED_SPLIT(32);
#undef PAGED_SPLIT
  return cudaGetLastError();
}

// Enqueue the split kernel and, with more than one split, the merge: out
// (B, H, Dh) in T, or in f32 with lse.  start_lens may be null; part holds
// scratch_bytes.  took_latent, where not null, is set to 1 when the launch
// runs latent_kernel and to 0 otherwise (the wrapper counts it).  lse,
// where not null, takes each (row, head)'s log-sum-exp (the note at the
// top).
template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* seq_lens,
                   const int* start_lens, void* out, void* part, int B, int H,
                   int Hkv, int Dh, int bs, int max_blk, cudaStream_t stream,
                   int* took_latent = nullptr, float* lse = nullptr) {
  if (Dh < 1 || Dh > kMaxWideDh || Hkv < 1 || H % Hkv)
    return cudaErrorInvalidValue;
  const int ns = n_splits(bs, max_blk, Dh);
  if (ns > 1 && part == nullptr) return cudaErrorInvalidValue;
  const bool wide = Dh > kMaxDh;
  const int G = H / Hkv;
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = Dh % kVec == 0 && al(q) && al(k_pool) && al(v_pool);
  // bf16 over one latent pool as K and V: the tensor-core kernel, chosen
  // by the layout alone (its 16-byte loads and stores need aligned q,
  // pool and out, or the launch fails)
  const bool latent = std::is_same_v<T, __nv_bfloat16> && k_pool == v_pool &&
                      Dh == kLatDh && G % kLatHeads == 0;
  if (latent && !(al(q) && al(k_pool) && al(out)))
    return cudaErrorMisalignedAddress;
  if (took_latent != nullptr) *took_latent = latent ? 1 : 0;
  const int gt = latent               ? kLatHeads
                 : G == 1 && !wide    ? 1
                 : G == 2 && !wide    ? 2
                                      : kMaxGroup;
  const int n_hg = (G + gt - 1) / gt;
  const long long rows = (long long)B * Hkv * n_hg;
  if (rows > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(ns, (unsigned)rows);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k_pool);
  const T* vt = static_cast<const T*>(v_pool);
  T* ot = static_cast<T*>(out);
  float* pt = static_cast<float*>(part);
  cudaError_t err = cudaSuccess;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (latent)
      err = launch_latent<kLatDh>(qt, kt, tables, seq_lens, start_lens, ot,
                                  pt, lse, B, H, Hkv, bs, max_blk, grid,
                                  stream);
  }
  if (!latent)
    err = wide      ? launch_wide<T>(qt, kt, vt, tables, seq_lens,
                                     start_lens, ot, pt, lse, B, H, Hkv, Dh,
                                     bs, max_blk, n_hg, grid, vec, stream)
          : gt == 1 ? launch_gt<T, 1>(qt, kt, vt, tables, seq_lens,
                                      start_lens, ot, pt, lse, B, H, Hkv, Dh,
                                      bs, max_blk, n_hg, grid, vec, stream)
          : gt == 2 ? launch_gt<T, 2>(qt, kt, vt, tables, seq_lens,
                                      start_lens, ot, pt, lse, B, H, Hkv, Dh,
                                      bs, max_blk, n_hg, grid, vec, stream)
                    : launch_gt<T, kMaxGroup>(qt, kt, vt, tables, seq_lens,
                                              start_lens, ot, pt, lse, B, H,
                                              Hkv, Dh, bs, max_blk, n_hg,
                                              grid, vec, stream);
  if (err != cudaSuccess || ns == 1) return err;
  // a programmatic dependent launch: the merge is launched while the split
  // grid drains, and waits for it inside
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const float* cpt = pt;
  return cudaLaunchKernelEx(&cfg, merge_kernel<T>, cpt, ot, lse, B * H, Dh,
                            ns);
}

}  // namespace paged
