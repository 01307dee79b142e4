// Whole-prompt causal GQA attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py
// (flash_prefill_pallas / _flash_prefill_kernel) and computes what
// repro.kernels.ref.flash_prefill_ref computes: q (B, Sq, H, Dh) attends
// over k / v (B, Skv, Hkv, Dh), G = H / Hkv query heads per KV head, scores
// scaled by 1/sqrt(Dh), online softmax in f32.  It also applies what the
// model's flash_attention applies (repro/models/attention.py:54-57): key j is
// visible to query i where q_pos[i] >= kv_pos[j] (causal) and
// q_pos[i] - kv_pos[j] < window (window > 0).  A row that sees no key
// outputs 0.  At window 0 with positions arange(S) this is exactly
// flash_prefill_ref.
//
// Bound: at prefill widths (S <= 512, Dh = 128) the bytes of q, k, v and
// out are a few MB (1.3 us at 3.35 TB/s) and the products 4 * S^2 / 2 * H
// * Dh flops (0.3 us on the tensor cores at S = 256): what bounds a call
// on the H100 is latency — the chain of dependent tile loads and products
// of the CTA with the most visible keys, and filling 132 SMs at all.
//
// Design.  The Pallas grid (B, Hkv, Sq/bq, Skv/bk) walks KV tiles as its
// innermost, sequential axis and carries (m, l, acc) in VMEM across it.
// Hopper runs blocks in parallel, so that axis becomes a loop inside the
// block: one CTA owns a (batch, KV head, tile of bq query positions) with
// all G query heads of each, and walks the KV tiles in order.  A tile that
// no row of the CTA may see — wholly in the future of every row, or wholly
// behind every row's window — is found before any load and never loaded.
// No sum crosses CTAs, there are no atomics, and every reduction runs in
// a fixed pattern, so the result is bitwise equal from run to run.
//
// bf16 (the serving path): FlashAttention-2 on mma.sync.
//   * Work.  Each warp owns 16 query rows as mma fragments and one of
//     four slices of every 64-key tile (16 keys; two slices of 32 when a
//     CTA holds 64 rows), with its own running (m, l, acc) in registers.
//     At the end the slices of a row group are merged in slice order —
//     the other warps hand their registers to the slice-0 warp through
//     shared memory — so no sum depends on timing.  Splitting the keys of
//     a tile over warps is what shortens the chain of the CTA with the
//     most visible keys: under a causal mask it sees S / 64 tiles, and
//     each tile costs a warp a chain of dependent ldmatrix / mma / softmax
//     steps that the other resident warps cannot hide.
//   * Grid.  bq starts at 16 positions (one warp of rows at G = 1) and
//     doubles while the grid has more CTAs than the 132 SMs, up to 128
//     rows and 8 warps a CTA: at B = 1, H = Hkv = 16 that is 32 positions
//     (2 row groups x 4 key slices, 128 CTAs) at S = 256 and 64 (4 x 2,
//     128 CTAs) at S = 512, so every CTA starts at once.
//   * Tiles.  q and a ring of 3 K/V tiles (2 at Dh = 256) sit in bf16
//     shared memory, rows swizzled by 16-byte chunk, filled by 16-byte
//     cp.async two tiles ahead; Dh pads to 64, 128 or 256 with zeros.
//     The q copies are issued first, so they land while the positions
//     are read and the visible tiles listed.
//   * Products.  S = q K^T and o += p V run on mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate) from ldmatrix fragments (V by ldmatrix.trans).  The
//     online softmax works on the accumulator registers in log2 units
//     (scores pre-scaled by log2 e / sqrt(Dh), exp2f); a row's max spans
//     the four lanes of its quad by two xor shuffles, each lane keeps its
//     part of the row sum, combined by the same butterfly at the end.  p,
//     rounded to bf16 (as repro's flash_attention casts p to V's type),
//     is repacked in registers as the A operand of p V and never touches
//     shared memory.  A tile every row of a warp sees whole skips the
//     per-key mask.  The output is acc * (1 / max(l, 1e-30)).
// f32 keeps the FMA kernel below as its own instantiation: on the tensor
// cores f32 would multiply as TF32, which breaks the 2e-4 tolerance the
// f32 model phase holds the card to.  It keeps the rows' q, m, l and f32
// acc in shared memory (R = G * bq rows, about 16), stages each KV tile as
// f32 (K transposed) with 16-byte loads, lets lane t score key t against
// kRowsPerPass rows at once, and updates the accumulator a column per
// thread, kAccRows rows at once; p stays f32 before p @ V.
#include <climits>

#include "common.cuh"
#include "mma.cuh"

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 32;       // keys per tile: one per lane
constexpr int kKS = kTileK + 1;  // padded row of the transposed K tile
constexpr int kRowTarget = 16;   // query rows per CTA (G heads x bq)
constexpr int kRowsPerPass = 4;  // rows a warp scores at once
constexpr int kLoads = 8;        // global loads in flight per thread (q)
constexpr int kAccRows = 16;     // accumulator rows a thread updates at once
constexpr float kNegInf = -1e30f;

inline int rows_per_head(int G) {
  return G >= kRowTarget ? 1 : kRowTarget / G;
}

inline size_t smem_bytes(int G, int Dh) {
  const int bq = rows_per_head(G);
  const size_t R = (size_t)G * bq;
  const size_t floats = 2 * R * Dh + (size_t)Dh * kKS +
                        (size_t)kTileK * Dh + R * kTileK + 3 * R;
  return floats * sizeof(float) + ((size_t)bq + kTileK) * sizeof(int);
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// Butterfly reductions over a warp: every lane ends with the same value,
// combined in a fixed pattern.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of T, loaded at once (the wrapper checks the alignment)
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float operator[](int i) const {
    return to_float(reinterpret_cast<const T*>(&raw)[i]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, T* __restrict__ out, int Sq, int Skv,
    int H, int Hkv, int Dh, int bq, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / Hkv;
  const int R = G * bq;
  const int RD = R * Dh;
  float* q_s = reinterpret_cast<float*>(smem_raw);  // R * Dh
  float* acc_s = q_s + RD;                           // R * Dh
  float* kt_s = acc_s + RD;                          // Dh * kKS (K^T)
  float* v_s = kt_s + Dh * kKS;                      // kTileK * Dh
  float* p_s = v_s + kTileK * Dh;                    // R * kTileK
  float* m_s = p_s + R * kTileK;                     // R
  float* l_s = m_s + R;                              // R
  float* corr_s = l_s + R;                           // R
  int* qpos_s = reinterpret_cast<int*>(corr_s + R);  // bq
  int* kpos_s = qpos_s + bq;                         // kTileK

  const int n_qtiles = (Sq + bq - 1) / bq;
  const int qt = blockIdx.x % n_qtiles;
  const int h = (blockIdx.x / n_qtiles) % Hkv;
  const long long b = blockIdx.x / n_qtiles / Hkv;
  const int q0 = qt * bq;
  const int nq = min(bq, Sq - q0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // row r = g * bq + i: query head h * G + g at position q0 + i (rows past
  // Sq read position Sq - 1 and are never written)
  for (int base = tid; base < RD; base += kThreads * kLoads) {
    float val[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = base + j * kThreads;
      const int r = min(i, RD - 1) / Dh;
      const int g = r / bq;
      const int qi = min(r - g * bq, nq - 1);
      val[j] = to_float(q[((b * Sq + q0 + qi) * H + h * G + g) * Dh +
                          (min(i, RD - 1) - r * Dh)]);
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = base + j * kThreads;
      if (i < RD) {
        q_s[i] = val[j];
        acc_s[i] = 0.f;
      }
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < bq; i += kThreads) {
    qpos_s[i] = i < nq ? q_pos[q0 + i] : 0;
  }
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = 0; i < nq; ++i) {
    qmin = min(qmin, qpos_s[i]);
    qmax = max(qmax, qpos_s[i]);
  }

  const long long kv_row = (long long)Hkv * Dh;
  for (int k0 = 0; k0 < Skv; k0 += kTileK) {
    const int n = min(kTileK, Skv - k0);
    if (tid < n) kpos_s[tid] = kv_pos[k0 + tid];
    __syncthreads();
    int kmin = INT_MAX, kmax = INT_MIN;
    for (int t = 0; t < n; ++t) {
      kmin = min(kmin, kpos_s[t]);
      kmax = max(kmax, kpos_s[t]);
    }
    // every thread reads the same positions: the skip is uniform
    const bool skip = (causal && kmin > qmax) ||
                      (window > 0 && (long long)qmin - kmax >= window);
    if (!skip) {
      // stage K transposed (K^T[d][t], rows padded against bank conflicts)
      // and V, 16 bytes a load, all of a thread's loads in flight at once;
      // keys past n are 0
      const T* kt = k + (b * Skv + k0) * kv_row + (long long)h * Dh;
      const T* vt = v + (b * Skv + k0) * kv_row + (long long)h * Dh;
      constexpr int kN = Vec<T>::kN;
      const int chunks = kTileK * Dh / kN;
      for (int base = tid; base < chunks; base += kThreads * kLoads) {
        Vec<T> kv[kLoads], vv[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int c = base + j * kThreads;
          const int t = c * kN / Dh;
          if (c < chunks && t < n) {
            const long long off = t * kv_row + (c * kN - t * Dh);
            kv[j].load(kt + off);
            vv[j].load(vt + off);
          } else {
            kv[j].raw = vv[j].raw = make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int c = base + j * kThreads;
          if (c < chunks) {
            const int t = c * kN / Dh;
            const int d0 = c * kN - t * Dh;
#pragma unroll
            for (int e = 0; e < kN; ++e) {
              kt_s[(d0 + e) * kKS + t] = kv[j][e];
              v_s[t * Dh + d0 + e] = vv[j][e];
            }
          }
        }
      }
      __syncthreads();

      // scores and the online softmax: a warp owns rows warp, warp + 4, ...
      // and lane t owns key t; kRowsPerPass rows share each K read, q is
      // read four dims at a time
      for (int r0 = warp; r0 < R; r0 += kWarps * kRowsPerPass) {
        float dot[kRowsPerPass];
        const float* qr[kRowsPerPass];
#pragma unroll
        for (int j = 0; j < kRowsPerPass; ++j) {
          dot[j] = 0.f;
          qr[j] = q_s + min(r0 + j * kWarps, R - 1) * Dh;
        }
        for (int d = 0; d < Dh; d += 4) {
          const float k0v = kt_s[d * kKS + lane];
          const float k1v = kt_s[(d + 1) * kKS + lane];
          const float k2v = kt_s[(d + 2) * kKS + lane];
          const float k3v = kt_s[(d + 3) * kKS + lane];
#pragma unroll
          for (int j = 0; j < kRowsPerPass; ++j) {
            const float4 qv = *reinterpret_cast<const float4*>(qr[j] + d);
            dot[j] += qv.x * k0v;
            dot[j] += qv.y * k1v;
            dot[j] += qv.z * k2v;
            dot[j] += qv.w * k3v;
          }
        }
        // the pass's rows' reductions run interleaved; rows past R are
        // all hidden and write nothing
        float sv[kRowsPerPass], mx[kRowsPerPass], e[kRowsPerPass];
#pragma unroll
        for (int j = 0; j < kRowsPerPass; ++j) {
          const int r = r0 + j * kWarps;
          const int i = min(r, R - 1) % bq;
          const bool vis = r < R && lane < n && i < nq &&
                           visible(qpos_s[i], kpos_s[lane], causal, window);
          sv[j] = vis ? dot[j] * scale : kNegInf;
          mx[j] = sv[j];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int j = 0; j < kRowsPerPass; ++j) {
            mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
          }
        }
        float m_old[kRowsPerPass];
#pragma unroll
        for (int j = 0; j < kRowsPerPass; ++j) {
          const int r = min(r0 + j * kWarps, R - 1);
          m_old[j] = m_s[r];
          mx[j] = fmaxf(m_old[j], mx[j]);                // the new max
          // a hidden key contributes exactly 0
          e[j] = sv[j] != kNegInf ? expf(sv[j] - mx[j]) : 0.f;
          if (r0 + j * kWarps < R) p_s[r * kTileK + lane] = e[j];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int j = 0; j < kRowsPerPass; ++j) {
            e[j] += __shfl_xor_sync(0xffffffffu, e[j], o);
          }
        }
        __syncwarp();            // every lane has read m_s and l_s
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < kRowsPerPass; ++j) {
            const int r = r0 + j * kWarps;
            if (r < R) {
              const float corr = expf(m_old[j] - mx[j]);
              l_s[r] = l_s[r] * corr + e[j];
              m_s[r] = mx[j];
              corr_s[r] = corr;
            }
          }
        }
      }
      __syncthreads();

      // acc = acc * corr + p @ V: a thread owns one column d and kAccRows
      // rows at a time, reading each V value once and p four keys at a
      // time (p and V past n are 0: +0 products change no sum)
      const int n4 = (n + 3) & ~3;
      for (int d = tid; d < Dh; d += kThreads) {
        for (int r0 = 0; r0 < R; r0 += kAccRows) {
          float a[kAccRows];
#pragma unroll
          for (int j = 0; j < kAccRows; ++j) {
            const int r = min(r0 + j, R - 1);
            a[j] = acc_s[r * Dh + d] * corr_s[r];
          }
          for (int t = 0; t < n4; t += 4) {
            const float v0 = v_s[t * Dh + d];
            const float v1 = v_s[(t + 1) * Dh + d];
            const float v2 = v_s[(t + 2) * Dh + d];
            const float v3 = v_s[(t + 3) * Dh + d];
#pragma unroll
            for (int j = 0; j < kAccRows; ++j) {
              const float4 p4 = *reinterpret_cast<const float4*>(
                  p_s + min(r0 + j, R - 1) * kTileK + t);
              a[j] += p4.x * v0;
              a[j] += p4.y * v1;
              a[j] += p4.z * v2;
              a[j] += p4.w * v3;
            }
          }
#pragma unroll
          for (int j = 0; j < kAccRows; ++j) {
            if (r0 + j < R) acc_s[(r0 + j) * Dh + d] = a[j];
          }
        }
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < RD; idx += kThreads) {
    const int r = idx / Dh;
    const int d = idx - r * Dh;
    const int g = r / bq;
    const int i = r - g * bq;
    if (i < nq) {
      out[((b * Sq + q0 + i) * H + h * G + g) * Dh + d] =
          from_float<T>(acc_s[idx] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                   int window, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const int bq = rows_per_head(G);
  const size_t smem = smem_bytes(G, Dh);
  cudaError_t err = allow_smem(flash_prefill_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * Hkv * ((Sq + bq - 1) / bq);
  flash_prefill_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), Sq, Skv,
      H, Hkv, Dh, bq, causal, window, scale);
  return cudaGetLastError();
}

// -- bf16: tensor cores ------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;            // keys per tile
constexpr int kMaxWarps = 8;
constexpr int kTargetCtas = 132;   // one CTA on each SM of an H100
constexpr float kLog2e = 1.4426950408889634f;

// K/V ring depth: two tiles in flight, one at Dh = 256 (whose tiles are
// twice as large).
__host__ __device__ constexpr int stages_for(int dh) {
  return dh <= 128 ? 3 : 2;
}

// The launch's shape: bq query positions per CTA (all G heads of each);
// wq warps of 16 rows each hold the rows, and each row group's keys are
// split over wk warps.  The bf16 region (q, then the K/V ring) is later
// reused for the warps' partial results; the ring's positions, the
// visible tiles' count and list and every tile's position range follow it
// at byte `ints`.
struct Plan {
  int bq, wq, wk, dh;
  size_t ints, smem;
};

inline Plan plan(int B, int Sq, int Skv, int H, int Hkv, int Dh) {
  const int G = H / Hkv;
  Plan p;
  // the fewest positions that fill a warp's 16 rows, doubled while the
  // grid would not run in one wave and a CTA keeps room for its rows
  p.bq = std::max(1, std::min(16 / G, Sq));
  while (p.bq < Sq && G * p.bq * 2 <= 16 * kMaxWarps &&
         (long long)B * Hkv * ((Sq + p.bq - 1) / p.bq) > kTargetCtas) {
    p.bq *= 2;
  }
  p.wq = 1;
  while (p.wq * 16 < G * p.bq) p.wq *= 2;
  p.wk = std::max(1, std::min(4, kMaxWarps / p.wq));
  p.dh = Dh <= 64 ? 64 : Dh <= 128 ? 128 : 256;
  const size_t rows = (size_t)p.wq * 16;
  const size_t stages = stages_for(p.dh);
  const size_t tiles = (rows + 2 * stages * kBK) * p.dh * 2;
  const size_t parts = p.wk * rows * 2 * (p.dh / 2 + 4) * 4;
  p.ints = std::max(tiles, parts);
  p.smem = p.ints +
           (stages * kBK + 1 + 3 * ((Skv + kBK - 1) / kBK)) * sizeof(int);
  return p;
}

__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// One CTA per (batch, KV head, tile of bq query positions); row r of the
// CTA is query head h * G + r / bq at position q0 + r % bq.  Warp w owns
// rows 16 (w % WQ) .. + 15 and keys KS (w / WQ) .. + KS - 1 of every
// tile, keeping its own running (m, l, acc); the WK partial results of a
// row group are merged at the end in key-slice order.  Every bf16 row of
// shared memory is swizzled by 16-byte chunk.
template <int DH, int WK>
__global__ void __launch_bounds__(32 * kMaxWarps) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, bf16* __restrict__ out, int Sq, int Skv,
    int H, int Hkv, int Dh, int bq, int causal, int window, float scale_log2,
    int ints) {
  constexpr int kCh = DH / 8;        // 16-byte chunks in a row
  constexpr int KS = kBK / WK;       // keys of a tile per warp
  constexpr int kStages = stages_for(DH);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int WQ = (blockDim.x >> 5) / WK;
  const int R = WQ * 16;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + R * DH;
  bf16* v_s = k_s + kStages * kBK * DH;
  const int ntiles = (Skv + kBK - 1) / kBK;
  int* kpos_s = reinterpret_cast<int*>(smem_raw + ints);
  int* list_s = kpos_s + kStages * kBK;  // [0]: count; then tile indices
  int* kmin_s = list_s + 1 + ntiles;     // every tile's position range
  int* kmax_s = kmin_s + ntiles;

  const int G = H / Hkv;
  const int n_qtiles = (Sq + bq - 1) / bq;
  const int qt = blockIdx.x % n_qtiles;
  const int h = (blockIdx.x / n_qtiles) % Hkv;
  const long long b = blockIdx.x / n_qtiles / Hkv;
  const int q0 = qt * bq;
  const int nq = min(bq, Sq - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qg = warp % WQ, ks = warp / WQ;

  // This thread copies chunk c of rows r0, r0 + rstep, ... of every q and
  // K/V tile.  Rows past the CTA's heads, positions or Skv and dims past
  // Dh are zeros (a zero dim adds +0 to a score; such keys are masked).
  const int c = threadIdx.x % kCh, r0 = threadIdx.x / kCh;
  const int rstep = blockDim.x / kCh;
  const bool c_in = c * 8 < Dh;
  const long long kv_row = (long long)Hkv * Dh;
  const long long kv_off = (b * Skv * Hkv + h) * Dh + c * 8;
  auto load_kv = [&](int buf, int tile) {
    const int k0 = tile * kBK;
    bf16* kd = k_s + buf * kBK * DH;
    bf16* vd = v_s + buf * kBK * DH;
    for (int r = r0; r < kBK; r += rstep) {
      const bool in = c_in && k0 + r < Skv;
      const long long off = kv_off + (k0 + r) * kv_row;
      cp_async16(kd + swz(r, c, kCh), in ? k + off : k, in ? 16 : 0);
      cp_async16(vd + swz(r, c, kCh), in ? v + off : v, in ? 16 : 0);
    }
    for (int j = threadIdx.x; j < kBK; j += blockDim.x) {
      const bool in = k0 + j < Skv;
      cp_async4(kpos_s + buf * kBK + j, in ? kv_pos + k0 + j : kv_pos,
                in ? 4 : 0);
    }
  };

  for (int r = r0; r < R; r += rstep) {
    const int g = r / bq, qi = r - g * bq;
    bf16* d = q_s + swz(r, c, kCh);
    if (g < G && qi < nq && c_in) {
      cp_async16(d, q + ((b * Sq + q0 + qi) * H + h * G + g) * Dh + c * 8);
    } else {
      cp_async16(d, q, 0);
    }
  }
  // Positions: this thread's two rows (g8 and g8 + 8 of its warp's 16),
  // the range of the CTA's positions and of every key tile's (warp w
  // judges tiles w, w + warps, ...).
  const int g8 = lane >> 2, t4 = lane & 3;
  int qp[2];
  bool rv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = qg * 16 + g8 + hr * 8;
    const int g = r / bq, qi = r - g * bq;
    rv[hr] = g < G && qi < nq;
    qp[hr] = rv[hr] ? q_pos[q0 + qi] : 0;
  }
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int i = lane; i < nq; i += 32) {
    const int p = q_pos[q0 + i];
    qmin = min(qmin, p);
    qmax = max(qmax, p);
  }
  for (int t = warp; t < ntiles; t += blockDim.x >> 5) {
    int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
    for (int j = lane; j < kBK; j += 32) {
      if (t * kBK + j < Skv) {
        const int p = kv_pos[t * kBK + j];
        kmin = min(kmin, p);
        kmax = max(kmax, p);
      }
    }
    kmin = warp_min_int(kmin);
    kmax = warp_max_int(kmax);
    if (lane == 0) {
      kmin_s[t] = kmin;
      kmax_s[t] = kmax;
    }
  }
  // the CTA's positions, and its warp's valid rows'
  qmin = warp_min_int(qmin);
  qmax = warp_max_int(qmax);
  const int wmin = warp_min_int(min(rv[0] ? qp[0] : INT_MAX,
                                    rv[1] ? qp[1] : INT_MAX));
  const int wmax = warp_max_int(max(rv[0] ? qp[0] : INT_MIN,
                                    rv[1] ? qp[1] : INT_MIN));
  __syncthreads();
  // A tile wholly in the future of every row, or wholly behind every
  // row's window, is never loaded: it would change nothing.  Warp 0 lists
  // the others in order, 32 tiles a ballot.
  if (warp == 0) {
    int n = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      const bool keep =
          t < ntiles &&
          !((causal && kmin_s[t] > qmax) ||
            (window > 0 && (long long)qmin - kmax_s[t] >= window));
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (keep) list_s[1 + n + __popc(mask & ((1u << lane) - 1))] = t;
      n += __popc(mask);
    }
    if (lane == 0) list_s[0] = n;
  }
  __syncthreads();
  const int nvis = list_s[0];
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {   // q joins the first group
    if (st < nvis) load_kv(st, list_s[1 + st]);
    cp_async_commit();
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  const int qrow = qg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;

  for (int it = 0; it < nvis; ++it) {
    cp_async_wait<kStages - 2>();  // tile it (and q) has landed
    __syncthreads();               // ... for every thread; it - 1 is free
    const int next = it + kStages - 1;
    if (next < nvis) load_kv(next % kStages, list_s[1 + next]);
    cp_async_commit();
    const int buf = it % kStages;
    const bf16* kt = k_s + buf * kBK * DH;
    const bf16* vt = v_s + buf * kBK * DH;
    const int* kp = kpos_s + buf * kBK;
    const int tile = list_s[1 + it];
    const int n = min(kBK, Skv - tile * kBK);
    const int key0 = ks * KS;      // this warp's slice of the tile

    // S = q K^T over all DH dims (the padding is zeros): q A fragments
    // (16 rows x 16 dims), K B fragments for two 8-key blocks per ldmatrix.
    // No branch splits the unrolled chain, so loads run ahead of products.
    float s[KS / 8][4];
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + swz(qrow, kk * 2 + (lane >> 4), kCh));
#pragma unroll
      for (int nb = 0; nb < KS / 16; ++nb) {
        uint32_t kb[4];
        const int kr = key0 + nb * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(kb, kt + swz(kr, kk * 2 + ((lane >> 3) & 1), kCh));
        mma_bf16(s[2 * nb], a, kb[0], kb[1]);
        mma_bf16(s[2 * nb + 1], a, kb[2], kb[3]);
      }
    }

    // online softmax on the accumulators, in log2 units: s[j][i] is row
    // g8 (+8 for i >= 2), key key0 + 8 j + 2 t4 (+1 for odd i); a row's
    // max spans the four lanes of its quad.  A tile every valid row of
    // the warp sees whole skips the per-key mask (the same values).
    const bool whole = n == kBK && (!causal || wmin >= kmax_s[tile]) &&
                       (window <= 0 || (long long)wmax - kmin_s[tile] <
                                           window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hr = i >> 1, key = key0 + 8 * j + 2 * t4 + (i & 1);
        const bool vis = whole || (rv[hr] && key < n &&
                                   visible(qp[hr], kp[key], causal, window));
        s[j][i] = vis ? s[j][i] * scale_log2 : kNegInf;
        mx[hr] = fmaxf(mx[hr], s[j][i]);
      }
    }
    float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      corr[hr] = exp2f(m[hr] - m_new);
      m[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hr = i >> 1;   // a hidden key contributes exactly 0
        s[j][i] = s[j][i] != kNegInf ? exp2f(s[j][i] - m[hr]) : 0.f;
        ls[hr] += s[j][i];
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * corr[hr] + ls[hr];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }

    // o += p V: p, rounded to V's type, is the A operand straight from the
    // score registers; V B fragments by ldmatrix.trans, two 8-dim blocks
    // per load
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const uint32_t pa4[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int vr = key0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nd = 0; nd < DH / 16; ++nd) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + swz(vr, nd * 2 + (lane >> 4), kCh));
        mma_bf16(o[2 * nd], pa4, vb[0], vb[1]);
        mma_bf16(o[2 * nd + 1], pa4, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // every warp is done with q and the ring

  // Every warp hands its (acc, m, l) to shared memory (over q and the
  // ring), value j of lane l at j * 32 + l, so every access is
  // conflict-free; l first combines the quad's lanes in a fixed
  // butterfly.  Then warp ks merges 8-dim blocks ks * kDPer .. of its row
  // group's rows, over the key slices in order, and writes them.
  constexpr int kVals = DH / 2 + 4;          // acc, then m and l per row
  constexpr int kDPer = DH / 8 / WK;         // 8-dim blocks a warp merges
  float* part = reinterpret_cast<float*>(smem_raw);
  float* mine = part + (ks * WQ + qg) * kVals * 32 + lane;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    mine[(DH / 2 + hr) * 32] = m[hr];
    mine[(DH / 2 + 2 + hr) * 32] = l[hr];
  }
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mine[(d * 4 + i) * 32] = o[d][i];
  }
  __syncthreads();
  float w[WK][2], inv[2];                    // the slices' weights
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float pm[WK], mm = kNegInf, den = 0.f;
#pragma unroll
    for (int p = 0; p < WK; ++p) {
      pm[p] = part[((p * WQ + qg) * kVals + DH / 2 + hr) * 32 + lane];
      mm = fmaxf(mm, pm[p]);
    }
#pragma unroll
    for (int p = 0; p < WK; ++p) {
      w[p][hr] = exp2f(pm[p] - mm);
      den += part[((p * WQ + qg) * kVals + DH / 2 + 2 + hr) * 32 + lane] *
             w[p][hr];
    }
    inv[hr] = 1.f / fmaxf(den, 1e-30f);      // one division a row
  }
  float acc[kDPer][4];
#pragma unroll
  for (int dd = 0; dd < kDPer; ++dd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = (ks * kDPer + dd) * 4 + i;
      acc[dd][i] = 0.f;
#pragma unroll
      for (int p = 0; p < WK; ++p) {
        acc[dd][i] += part[((p * WQ + qg) * kVals + j) * 32 + lane] *
                      w[p][i >> 1];
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (!rv[hr]) continue;
    const int r = qg * 16 + g8 + hr * 8;
    const int g = r / bq, qi = r - g * bq;
    bf16* orow = out + ((b * Sq + q0 + qi) * H + h * G + g) * Dh;
#pragma unroll
    for (int dd = 0; dd < kDPer; ++dd) {
      const int col = (ks * kDPer + dd) * 8 + 2 * t4;
      if (col < Dh) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[dd][2 * hr] * inv[hr], acc[dd][2 * hr + 1] * inv[hr]);
      }
    }
  }
}

template <int DH, int WK>
cudaError_t run(const Plan& p, const bf16* q, const bf16* k, const bf16* v,
                const int* q_pos, const int* kv_pos, bf16* out, int B, int Sq,
                int Skv, int H, int Hkv, int Dh, int causal, int window,
                float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_mma_kernel<DH, WK>, p.smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * Hkv * ((Sq + p.bq - 1) / p.bq);
  flash_mma_kernel<DH, WK><<<(unsigned)blocks, 32 * p.wq * WK, p.smem,
                             stream>>>(
      q, k, v, q_pos, kv_pos, out, Sq, Skv, H, Hkv, Dh, p.bq, causal, window,
      scale * kLog2e, (int)p.ints);
  return cudaGetLastError();
}

template <int DH>
cudaError_t run_dh(const Plan& p, const bf16* q, const bf16* k, const bf16* v,
                   const int* q_pos, const int* kv_pos, bf16* out, int B,
                   int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                   int window, float scale, cudaStream_t stream) {
  if (p.wk == 4) {
    return run<DH, 4>(p, q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv, Dh,
                      causal, window, scale, stream);
  }
  if (p.wk == 2) {
    return run<DH, 2>(p, q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv, Dh,
                      causal, window, scale, stream);
  }
  return run<DH, 1>(p, q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, Hkv, Dh,
                    causal, window, scale, stream);
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                   int window, float scale, cudaStream_t stream) {
  const Plan p = plan(B, Sq, Skv, H, Hkv, Dh);
  if (p.wq * p.wk > kMaxWarps) return cudaErrorInvalidConfiguration;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  if (p.dh == 64) {
    return run_dh<64>(p, qb, kb, vb, q_pos, kv_pos, ob, B, Sq, Skv, H, Hkv,
                      Dh, causal, window, scale, stream);
  }
  if (p.dh == 128) {
    return run_dh<128>(p, qb, kb, vb, q_pos, kv_pos, ob, B, Sq, Skv, H, Hkv,
                       Dh, causal, window, scale, stream);
  }
  return run_dh<256>(p, qb, kb, vb, q_pos, kv_pos, ob, B, Sq, Skv, H, Hkv,
                     Dh, causal, window, scale, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// Shared memory one CTA needs (the wrapper checks it against the card);
// LLONG_MAX where a CTA would need more than tc::kMaxWarps warps.
long long flash_prefill_smem_bytes(int B, int Sq, int Skv, int H, int Hkv,
                                   int Dh, int dtype) {
  if (dtype != 1) return (long long)smem_bytes(H / Hkv, Dh);
  const tc::Plan p = tc::plan(B, Sq, Skv, H, Hkv, Dh);
  return p.wq * p.wk > tc::kMaxWarps ? LLONG_MAX : (long long)p.smem;
}

// q (B, Sq, H, Dh); k / v (B, Skv, Hkv, Dh); q_pos (Sq,) and kv_pos (Skv,)
// i32; out (B, Sq, H, Dh).  causal: 0 or 1; window: 0 = none; scale: the
// score scale.  dtype: 0 = f32, 1 = bf16 (q, k, v and out share it).
// Returns the launch's cudaError_t (0 = launched).
int flash_prefill(const void* q, const void* k, const void* v,
                  const void* q_pos, const void* kv_pos, void* out, int B,
                  int Sq, int Skv, int H, int Hkv, int Dh, int causal,
                  int window, float scale, int dtype, void* stream) {
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1
          ? tc::launch(q, k, v, qp, kp, out, B, Sq, Skv, H, Hkv, Dh, causal,
                       window, scale, s)
          : launch<float>(q, k, v, qp, kp, out, B, Sq, Skv, H, Hkv, Dh,
                          causal, window, scale, s);
  return (int)err;
}

}  // extern "C"
