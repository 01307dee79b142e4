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
// MLA (Dh = R + dr = 576, G = 128) will need a wider lane chunk or Dh split
// over lane groups beside it (and the Dh <= 256 check lifted for that
// layout).
#pragma once
#include "common.cuh"

namespace paged {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitLen = 64;     // positions per split
constexpr int kMaxGroup = 4;      // query heads one CTA holds in registers
constexpr int kVec = 8;           // elements of Dh per lane
constexpr int kMaxDh = 256;
constexpr int kMergeThreads = 128;
constexpr float kNegInf = -1e30f;

inline int n_splits(int bs, int max_blk) {
  const long long n = ((long long)bs * max_blk + kSplitLen - 1) / kSplitLen;
  return n > 1 ? (int)n : 1;
}

// Scratch of one launch: per (row, query head, split) m and l, then
// acc[Dh], all f32; none with a single split.
inline size_t scratch_bytes(int B, int H, int Dh, int bs, int max_blk) {
  const int ns = n_splits(bs, max_blk);
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
    T* __restrict__ out, float* __restrict__ part, int B, int H, int Hkv,
    int Dh, int bs, int max_blk, int n_hg, float scale, bool vec) {
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
        out[bh0 * Dh + i] = from_float<T>(0.f);
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
      out[row * Dh + d] = from_float<T>(a / l);
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
    const float* __restrict__ part, T* __restrict__ out, int BH, int Dh,
    int ns) {
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
    out[row * Dh + d] = from_float<T>(L > 0.f ? a / L : 0.f);
  }
}

template <typename T, int GT>
cudaError_t launch_gt(const T* q, const T* k_pool, const T* v_pool,
                      const int* tables, const int* seq_lens,
                      const int* start_lens, T* out, float* part, int B,
                      int H, int Hkv, int Dh, int bs, int max_blk, int n_hg,
                      dim3 grid, bool vec, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)Dh);
  const int lanes = (Dh + kVec - 1) / kVec;
#define PAGED_SPLIT(LPP)                                                     \
  split_kernel<T, GT, LPP><<<grid, kThreads, 0, stream>>>(                   \
      q, k_pool, v_pool, tables, seq_lens, start_lens, out, part, B, H, Hkv, \
      Dh, bs, max_blk, n_hg, scale, vec)
  if (lanes <= 8) PAGED_SPLIT(8);
  else if (lanes <= 16) PAGED_SPLIT(16);
  else PAGED_SPLIT(32);
#undef PAGED_SPLIT
  return cudaGetLastError();
}

// Enqueue the split kernel and, with more than one split, the merge: out
// (B, H, Dh) in T.  start_lens may be null; part holds scratch_bytes.
template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* seq_lens,
                   const int* start_lens, void* out, void* part, int B, int H,
                   int Hkv, int Dh, int bs, int max_blk,
                   cudaStream_t stream) {
  if (Dh < 1 || Dh > kMaxDh || Hkv < 1 || H % Hkv)
    return cudaErrorInvalidValue;
  const int ns = n_splits(bs, max_blk);
  if (ns > 1 && part == nullptr) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int gt = G == 1 ? 1 : G == 2 ? 2 : kMaxGroup;
  const int n_hg = (G + gt - 1) / gt;
  const long long rows = (long long)B * Hkv * n_hg;
  if (rows > 65535) return cudaErrorInvalidConfiguration;
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = Dh % kVec == 0 && al(q) && al(k_pool) && al(v_pool);
  const dim3 grid(ns, (unsigned)rows);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k_pool);
  const T* vt = static_cast<const T*>(v_pool);
  T* ot = static_cast<T*>(out);
  float* pt = static_cast<float*>(part);
  cudaError_t err =
      gt == 1   ? launch_gt<T, 1>(qt, kt, vt, tables, seq_lens, start_lens,
                                  ot, pt, B, H, Hkv, Dh, bs, max_blk, n_hg,
                                  grid, vec, stream)
      : gt == 2 ? launch_gt<T, 2>(qt, kt, vt, tables, seq_lens, start_lens,
                                  ot, pt, B, H, Hkv, Dh, bs, max_blk, n_hg,
                                  grid, vec, stream)
                : launch_gt<T, kMaxGroup>(qt, kt, vt, tables, seq_lens,
                                          start_lens, ot, pt, B, H, Hkv, Dh,
                                          bs, max_blk, n_hg, grid, vec,
                                          stream);
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
  return cudaLaunchKernelEx(&cfg, merge_kernel<T>, cpt, ot, B * H, Dh, ns);
}

}  // namespace paged
