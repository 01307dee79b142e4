// Paged GQA decode attention for Hopper (sm_90a): the kernel, shared by
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
// ridge point.
//
// Design.  The TPU kernel walks a sequential page axis of its grid and
// carries the online-softmax state in VMEM scratch across grid steps.  Hopper
// runs blocks in parallel, in no order, so that axis becomes a loop inside
// the block: one CTA per (row, KV head) walks its row's valid positions in
// tiles of kTile, keeping the G query heads, the running max / denominator
// and the f32 accumulator in shared memory.  Within a tile each warp scores
// positions (lanes split Dh, a butterfly shuffle reduces), one thread per head
// folds the tile into the online softmax, then all threads update the
// accumulator with coalesced V reads.  Every reduction runs in a fixed order
// and there are no atomics, so results are bitwise equal from run to run.
// Any Dh <= 256 works (not only powers of two), f32 or bf16, f32 accumulate.
//
// MLA attends with K = V = its latent pool, Dh = R + dr = 576 and G = 128
// heads per KV head: its q and accumulator (2 * G * Dh floats) do not fit
// one CTA's shared memory, so it will need the heads split over several
// CTAs per row (and the Dh <= 256 check lifted for that layout).
#pragma once
#include "common.cuh"

namespace paged {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr float kNegInf = -1e30f;

inline size_t smem_bytes(int G, int Dh) {
  return kTile * sizeof(long long) +
         (2 * (size_t)G * Dh + (size_t)G * kTile + 3 * (size_t)G) *
             sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ seq_lens, const int* __restrict__ start_lens,
    T* __restrict__ out, int H, int Hkv, int Dh, int bs, int max_blk,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / Hkv;
  const int GD = G * Dh;
  long long* row_s = reinterpret_cast<long long*>(smem_raw);  // kTile
  float* q_s = reinterpret_cast<float*>(row_s + kTile);       // G*Dh
  float* acc_s = q_s + GD;                                    // G*Dh
  float* p_s = acc_s + GD;                                    // G*kTile
  float* m_s = p_s + G * kTile;                               // G
  float* l_s = m_s + G;                                       // G
  float* corr_s = l_s + G;                                    // G

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qrow = q + ((long long)b * H + (long long)h * G) * Dh;
  for (int i = tid; i < GD; i += kThreads) {
    q_s[i] = to_float(qrow[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int end = min(seq_lens[b], max_blk * bs);
  const int begin = start_lens != nullptr ? max(start_lens[b], 0) : 0;
  const long long row_stride = (long long)Hkv * Dh;
  const long long head_off = (long long)h * Dh;
  __syncthreads();

  for (int p0 = begin; p0 < end; p0 += kTile) {
    const int n = min(kTile, end - p0);
    if (tid < n) {
      const int pos = p0 + tid;
      const long long bid = tables[(long long)b * max_blk + pos / bs];
      row_s[tid] = (bid * bs + pos % bs) * row_stride + head_off;
    }
    __syncthreads();

    // scores: warp per (head, position) pair, lanes over Dh
    for (int pi = warp; pi < G * n; pi += kWarps) {
      const int g = pi / n;
      const int t = pi - g * n;
      const T* krow = k_pool + row_s[t];
      const float* qg = q_s + g * Dh;
      float s = 0.f;
      for (int d = lane; d < Dh; d += 32) s += qg[d] * to_float(krow[d]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) p_s[g * kTile + t] = s * scale;
    }
    __syncthreads();

    // online softmax: one thread per head, positions in order
    for (int g = tid; g < G; g += kThreads) {
      float* pg = p_s + g * kTile;
      const float m_old = m_s[g];
      float m_new = m_old;
      for (int t = 0; t < n; ++t) m_new = fmaxf(m_new, pg[t]);
      float sum = 0.f;
      for (int t = 0; t < n; ++t) {
        const float e = expf(pg[t] - m_new);
        pg[t] = e;
        sum += e;
      }
      const float corr = expf(m_old - m_new);
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = m_new;
      corr_s[g] = corr;
    }
    __syncthreads();

    // accumulate p @ V: threads over (head, dim), coalesced along Dh
    for (int i = tid; i < GD; i += kThreads) {
      const int g = i / Dh;
      const int d = i - g * Dh;
      const float* pg = p_s + g * kTile;
      float a = acc_s[i] * corr_s[g];
      for (int t = 0; t < n; ++t) a += pg[t] * to_float(v_pool[row_s[t] + d]);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  T* orow = out + ((long long)b * H + (long long)h * G) * Dh;
  for (int i = tid; i < GD; i += kThreads) {
    orow[i] = from_float<T>(acc_s[i] / fmaxf(l_s[i / Dh], 1e-30f));
  }
}

// Enqueue the kernel: out (B, H, Dh) in T.  start_lens may be null.
template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* seq_lens,
                   const int* start_lens, void* out, int B, int H, int Hkv,
                   int Dh, int bs, int max_blk, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, Dh);
  cudaError_t err = allow_smem(attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  attention_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, seq_lens, start_lens,
      static_cast<T*>(out), H, Hkv, Dh, bs, max_blk,
      1.0f / sqrtf((float)Dh));
  return cudaGetLastError();
}

}  // namespace paged
