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
// Bound: at prefill widths (S <= 512, Dh = 128) the bytes of q, k, v and out
// are a few MB and the products ~4 * S^2 / 2 * H * Dh flops — microseconds
// either way, so a call is bound by its launch.
//
// Design.  The Pallas grid (B, Hkv, Sq/bq, Skv/bk) walks KV tiles as its
// innermost, sequential axis and carries (m, l, acc) in VMEM across it.
// Hopper runs blocks in parallel, so that axis becomes a loop inside the
// block: one CTA owns a (batch, KV head, q tile) with all G query heads of
// that tile (R = G * bq rows, bq chosen so R is about 16), keeps the rows'
// q, running max, denominator and f32 accumulator in shared memory, and
// walks the KV tiles of kTileK positions in order, each staged in shared
// memory as f32 (K transposed) with 16-byte loads, all in flight at once.
// A tile that no row of the CTA may see — wholly in the future of every
// row, or wholly behind every row's window — is skipped before it is
// loaded; a skipped tile would have changed nothing.  Within a tile a warp
// owns a set of rows and lane t owns key t: the lane scores its key against
// kRowsPerPass rows at once (serial dots over Dh), then butterfly shuffles,
// interleaved over those rows, give each row's tile max and sum for the
// online softmax.  Each thread then owns one column of the accumulator and
// updates kAccRows rows at once, reading each V value once.  There is no
// split over K/V and no atomics, and every reduction runs in a fixed
// pattern, so the result is bitwise equal from run to run.  Dh is a
// multiple of 8 up to 256, f32 or bf16 storage, f32 arithmetic; p stays f32
// before p @ V (the JAX flash_attention casts it to V's type).  The products
// are FMA loops over shared memory (mma and TMA come later).
#include <climits>

#include "common.cuh"

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

}  // namespace

extern "C" {

// Shared memory one CTA needs (the wrapper checks it against the card).
long long flash_prefill_smem_bytes(int G, int Dh) {
  return (long long)smem_bytes(G, Dh);
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
          ? launch<__nv_bfloat16>(q, k, v, qp, kp, out, B, Sq, Skv, H, Hkv,
                                  Dh, causal, window, scale, s)
          : launch<float>(q, k, v, qp, kp, out, B, Sq, Skv, H, Hkv, Dh,
                          causal, window, scale, s);
  return (int)err;
}

}  // extern "C"
