// The gradient of whole-prompt GQA attention, for Hopper (sm_90a).
//
// Replaces no TPU kernel: src/repro has no backward kernel (no custom_vjp);
// training there differentiates the jnp flash_attention
// (src/repro/models/attention.py:78) with jax.value_and_grad.  The port
// computes that forward with flash_prefill.cu on the card, so its gradient
// needs a kernel too.  It computes what flash_prefill_bwd_plain computes
// (src/repro_torch/kernels/flash_prefill.py): for q (B, Sq, H, Dq), k (B,
// Skv, Hkv, Dq), v (B, Skv, Hkv, Dv), the forward's output o and the
// output gradient do (B, Sq, H, Dv), with the mask of the forward (key j
// visible to query i where q_pos[i] >= kv_pos[j] if causal, and
// q_pos[i] - kv_pos[j] < window if window > 0):
//   P = softmax of the visible scores s = q k^T / sqrt(Dq) (0 elsewhere),
//   D_i = sum_c do_ic o_ic,  dV = P^T do,  dS = P (do v^T - D),
//   dQ = dS k / sqrt(Dq),  dK = dS^T q / sqrt(Dq),
// dK and dV summed over the G = H / Hkv query heads of a KV head.  A row
// that sees no key has P = 0 and adds nothing.
//
// Statistics.  The forward kernel saves no log-sum-exp, and serving calls
// it too, so it is left as it is: the first kernel here recomputes each
// row's max and sum in a sweep over its visible key tiles before the sweep
// that forms dQ, and writes the log-sum-exp and D for the second kernel.
// That costs one more q k^T product per visible tile pair, a fifth of the
// backward's products.
//
// Work.  FlashAttention-2's split, so no sum crosses CTAs:
//   * dq_kernel: one CTA per (batch, query head, tile of 32 query rows);
//     D from the rows' do and o; sweep 1 over the key tiles for the rows'
//     max and sum (online, in f32); sweep 2 for P, dP = do v^T, dS and
//     dQ += dS k.  Writes dq, the log-sum-exp and D.
//   * dkv_kernel: one CTA per (batch, KV head, tile of 32 keys); loops over
//     the G query heads of its KV head, and for each over the query tiles,
//     in that fixed order: P and dS of the tile pair, dV += P^T do, dK +=
//     dS^T q.
// A tile pair that no (query, key) pair of it may see — keys wholly in the
// future of every row, or wholly behind every row's window — is found from
// the tiles' position ranges before any load, and skipped.  Every sum runs
// in one thread in a fixed order (or a fixed butterfly), there are no
// atomics, and two calls give bitwise equal gradients.
//
// Arithmetic.  f32 on FMA for both storage types (bf16 is read into f32
// shared memory; the gradients are rounded to bf16 once, at the end): on
// the tensor cores f32 would multiply as TF32.  Tiles live in shared
// memory with rows padded by one float, so the 8 threads that share a
// row's reads hit 8 banks.  Each thread owns 4 of a 32 x 32 score tile's
// entries and 1/8 of the columns of 1 accumulator row (up to 32 dQ, or 32
// dK and 32 dV values, in registers).
//
// Bound: at training widths (B 4, S 256, H 16, Dh 128) the bytes are ~21
// MB (6 us at 3.35 TB/s) and the products 5 * 2 * B * H * S^2 / 2 * Dh ~
// 2.7 GFLOP (40 us on the f32 FMA units): the FMA rate bounds it, and
// this simple design, one FMA per shared-memory read pair, reaches a
// fraction of it; wgmma is later work.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;          // query rows or keys a tile
constexpr int kTS = kTile + 1;     // padded row of a 32 x 32 tile
constexpr int kMaxCols = 32;       // a thread's columns of one row: D / 8
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// Whether any (query, key) pair of two tiles, given their position ranges,
// may be visible (conservative: a pair may pass one test and fail the
// other).
__device__ __forceinline__ bool tiles_meet(int qmin, int qmax, int kmin,
                                           int kmax, int causal,
                                           int window) {
  return (!causal || qmax >= kmin) && (window <= 0 || qmin - kmax < window);
}

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

inline size_t smem_bytes(int Dq, int Dv) {
  const size_t floats = 2 * (size_t)kTile * (Dq + 1) +
                        2 * (size_t)kTile * (Dv + 1) + 2 * kTile * kTS +
                        4 * kTile;
  return floats * sizeof(float) + 2 * kTile * sizeof(int);
}

// rows [r0, r0 + n) of a (.., S, heads, D) tensor at head `head`, into a
// 32-row f32 tile of row stride D + 1; rows past n are zero
template <typename T>
__device__ void load_rows(float* dst, const T* __restrict__ src, long long b,
                          int S, int heads, int head, int D, int r0, int n) {
  const int stride = D + 1;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * stride + c] =
        r < n ? to_float(src[((b * S + r0 + r) * heads + head) * D + c])
              : 0.f;
  }
}

// positions [p0, p0 + n) into dst[0, 32) (0 past n), then every thread's
// min and max over the n valid ones (after the barrier inside)
__device__ void load_positions(int* dst, const int* __restrict__ pos, int p0,
                               int n, int& lo, int& hi) {
  if (threadIdx.x < kTile) {
    dst[threadIdx.x] = threadIdx.x < n ? pos[p0 + threadIdx.x] : 0;
  }
  __syncthreads();
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = 0; i < n; ++i) {
    lo = min(lo, dst[i]);
    hi = max(hi, dst[i]);
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int c = 0; c < D; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ dout, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, float* __restrict__ lse_out,
    float* __restrict__ delta_out, T* __restrict__ dq, int Sq, int Skv,
    int H, int Hkv, int Dq, int Dv, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int QS = Dq + 1, VS = Dv + 1;
  float* q_s = reinterpret_cast<float*>(smem_raw);  // 32 x QS
  float* k_s = q_s + kTile * QS;                     // 32 x QS
  float* do_s = k_s + kTile * QS;                    // 32 x VS
  float* v_s = do_s + kTile * VS;                    // 32 x VS (first: o)
  float* s_s = v_s + kTile * VS;                     // 32 x kTS
  float* ds_s = s_s + kTile * kTS;                   // 32 x kTS
  float* m_s = ds_s + kTile * kTS;                   // 32
  float* l_s = m_s + kTile;                          // 32
  float* lse_s = l_s + kTile;                        // 32
  float* dl_s = lse_s + kTile;                       // 32
  int* qpos_s = reinterpret_cast<int*>(dl_s + kTile);  // 32
  int* kpos_s = qpos_s + kTile;                        // 32

  const int G = H / Hkv;
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % H;
  const long long b = blockIdx.x / n_qt / H;
  const int hk = h / G;
  const int q0 = qt * kTile;
  const int nq = min(kTile, Sq - q0);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // this thread's score entries (r, j0 + 8 i) and accumulator row r
  const int r = tid >> 3, j0 = tid & 7;

  load_rows(q_s, q, b, Sq, H, h, Dq, q0, nq);
  load_rows(do_s, dout, b, Sq, H, h, Dv, q0, nq);
  load_rows(v_s, o, b, Sq, H, h, Dv, q0, nq);
  if (tid < kTile) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  int qmin, qmax;
  load_positions(qpos_s, q_pos, q0, nq, qmin, qmax);   // its barrier
  // D of rows warp * 4 + i: a butterfly over the lanes' partial sums
  for (int i = 0; i < kTile / (kThreads / 32); ++i) {
    const int row = warp * (kTile / (kThreads / 32)) + i;
    float part = 0.f;
    for (int c = lane; c < Dv; c += 32) {
      part = fmaf(do_s[row * VS + c], v_s[row * VS + c], part);
    }
    part = warp_sum(part);
    if (lane == 0) dl_s[row] = part;
  }

  const int n_kt = (Skv + kTile - 1) / kTile;
  // sweep 1: each row's max and sum over its visible keys
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile, nk = min(kTile, Skv - k0);
    __syncthreads();                     // the last tile's readers are done
    int kmin, kmax;
    load_positions(kpos_s, kv_pos, k0, nk, kmin, kmax);
    if (nq <= 0 || !tiles_meet(qmin, qmax, kmin, kmax, causal, window)) {
      continue;
    }
    load_rows(k_s, k, b, Skv, Hkv, hk, Dq, k0, nk);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + 8 * i;
      float s = kNegInf;
      if (r < nq && j < nk &&
          visible(qpos_s[r], kpos_s[j], causal, window)) {
        s = dot(q_s + r * QS, k_s + j * QS, Dq) * scale;
      }
      s_s[r * kTS + j] = s;
    }
    __syncthreads();
    for (int i = 0; i < kTile / (kThreads / 32); ++i) {
      const int row = warp * (kTile / (kThreads / 32)) + i;
      const float s = s_s[row * kTS + lane];
      const float mx = warp_max(s);
      if (mx > 0.5f * kNegInf) {         // the row sees a key of this tile
        const float m_old = m_s[row];
        const float m_new = fmaxf(m_old, mx);
        const float p = s > 0.5f * kNegInf ? expf(s - m_new) : 0.f;
        const float sum = warp_sum(p);
        if (lane == 0) {
          l_s[row] = l_s[row] * expf(m_old - m_new) + sum;
          m_s[row] = m_new;
        }
      }
    }
  }
  __syncthreads();
  if (tid < kTile) {
    // a row that sees no key: P = exp(s - 1e30) = 0 wherever it is formed
    lse_s[tid] = l_s[tid] > 0.f ? m_s[tid] + logf(l_s[tid]) : -kNegInf;
    if (tid < nq) {
      const long long at = (b * H + h) * Sq + q0 + tid;
      lse_out[at] = lse_s[tid];
      delta_out[at] = dl_s[tid];
    }
  }

  // sweep 2: dQ = sum over the visible keys of dS k
  float acc[kMaxCols];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile, nk = min(kTile, Skv - k0);
    __syncthreads();
    int kmin, kmax;
    load_positions(kpos_s, kv_pos, k0, nk, kmin, kmax);
    if (nq <= 0 || !tiles_meet(qmin, qmax, kmin, kmax, causal, window)) {
      continue;
    }
    load_rows(k_s, k, b, Skv, Hkv, hk, Dq, k0, nk);
    load_rows(v_s, v, b, Skv, Hkv, hk, Dv, k0, nk);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + 8 * i;
      float ds = 0.f;
      if (r < nq && j < nk &&
          visible(qpos_s[r], kpos_s[j], causal, window)) {
        const float s = dot(q_s + r * QS, k_s + j * QS, Dq) * scale;
        const float p = expf(s - lse_s[r]);
        const float dp = dot(do_s + r * VS, v_s + j * VS, Dv);
        ds = p * (dp - dl_s[r]);
      }
      ds_s[r * kTS + j] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      const int c = j0 + 8 * i;
      if (c < Dq) {
        float a = acc[i];
        for (int j = 0; j < kTile; ++j) {
          a = fmaf(ds_s[r * kTS + j], k_s[j * QS + c], a);
        }
        acc[i] = a;
      }
    }
  }
  if (r < nq) {
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      const int c = j0 + 8 * i;
      if (c < Dq) {
        dq[((b * Sq + q0 + r) * H + h) * Dq + c] =
            from_float<T>(acc[i] * scale);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
    int Dq, int Dv, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int QS = Dq + 1, VS = Dv + 1;
  float* k_s = reinterpret_cast<float*>(smem_raw);  // 32 x QS
  float* q_s = k_s + kTile * QS;                     // 32 x QS
  float* v_s = q_s + kTile * QS;                     // 32 x VS
  float* do_s = v_s + kTile * VS;                    // 32 x VS
  float* p_s = do_s + kTile * VS;                    // 32 x kTS (query rows)
  float* ds_s = p_s + kTile * kTS;                   // 32 x kTS
  float* lse_s = ds_s + kTile * kTS;                 // 32
  float* dl_s = lse_s + kTile;                       // 32
  int* qpos_s = reinterpret_cast<int*>(dl_s + kTile);  // 32
  int* kpos_s = qpos_s + kTile;                        // 32

  const int G = H / Hkv;
  const int n_kt = (Skv + kTile - 1) / kTile;
  const int kt = blockIdx.x % n_kt;
  const int hk = (blockIdx.x / n_kt) % Hkv;
  const long long b = blockIdx.x / n_kt / Hkv;
  const int k0 = kt * kTile;
  const int nk = min(kTile, Skv - k0);
  const int tid = threadIdx.x;
  // score entries (query r, key j0 + 8 i); accumulator row: key r
  const int r = tid >> 3, j0 = tid & 7;

  load_rows(k_s, k, b, Skv, Hkv, hk, Dq, k0, nk);
  load_rows(v_s, v, b, Skv, Hkv, hk, Dv, k0, nk);
  int kmin, kmax;
  load_positions(kpos_s, kv_pos, k0, nk, kmin, kmax);   // its barrier

  float dk_acc[kMaxCols], dv_acc[kMaxCols];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int n_qt = (Sq + kTile - 1) / kTile;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile, nq = min(kTile, Sq - q0);
      __syncthreads();                   // the last tile's readers are done
      int qmin, qmax;
      load_positions(qpos_s, q_pos, q0, nq, qmin, qmax);
      if (nk <= 0 || !tiles_meet(qmin, qmax, kmin, kmax, causal, window)) {
        continue;
      }
      load_rows(q_s, q, b, Sq, H, h, Dq, q0, nq);
      load_rows(do_s, dout, b, Sq, H, h, Dv, q0, nq);
      if (tid < kTile) {
        const long long at = (b * H + h) * Sq + q0 + tid;
        lse_s[tid] = tid < nq ? lse[at] : 0.f;
        dl_s[tid] = tid < nq ? delta[at] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + 8 * i;
        float p = 0.f, ds = 0.f;
        if (r < nq && j < nk &&
            visible(qpos_s[r], kpos_s[j], causal, window)) {
          const float s = dot(q_s + r * QS, k_s + j * QS, Dq) * scale;
          p = expf(s - lse_s[r]);
          const float dp = dot(do_s + r * VS, v_s + j * VS, Dv);
          ds = p * (dp - dl_s[r]);
        }
        p_s[r * kTS + j] = p;
        ds_s[r * kTS + j] = ds;
      }
      __syncthreads();
      // key r's rows of dV and dK, summed over the tile's queries in order
#pragma unroll
      for (int i = 0; i < kMaxCols; ++i) {
        const int c = j0 + 8 * i;
        if (c < Dv) {
          float a = dv_acc[i];
          for (int qi = 0; qi < kTile; ++qi) {
            a = fmaf(p_s[qi * kTS + r], do_s[qi * VS + c], a);
          }
          dv_acc[i] = a;
        }
        if (c < Dq) {
          float a = dk_acc[i];
          for (int qi = 0; qi < kTile; ++qi) {
            a = fmaf(ds_s[qi * kTS + r], q_s[qi * QS + c], a);
          }
          dk_acc[i] = a;
        }
      }
    }
  }
  if (r < nk) {
#pragma unroll
    for (int i = 0; i < kMaxCols; ++i) {
      const int c = j0 + 8 * i;
      const long long row = (b * Skv + k0 + r) * Hkv + hk;
      if (c < Dq) dk[row * Dq + c] = from_float<T>(dk_acc[i] * scale);
      if (c < Dv) dv[row * Dv + c] = from_float<T>(dv_acc[i]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const int* q_pos, const int* kv_pos, float* lse,
           float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
           int H, int Hkv, int Dq, int Dv, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(Dq, Dv);
  cudaError_t err = allow_smem(dq_kernel<T>, smem);
  if (err == cudaSuccess) err = allow_smem(dkv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_q = (long long)B * H * ((Sq + kTile - 1) / kTile);
  const long long n_k = (long long)B * Hkv * ((Skv + kTile - 1) / kTile);
  if (n_q > INT_MAX || n_k > INT_MAX) return (int)cudaErrorInvalidValue;
  dq_kernel<T><<<(unsigned)n_q, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      q_pos, kv_pos, lse, delta, (T*)dq, Sq, Skv, H, Hkv, Dq, Dv, causal,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<T><<<(unsigned)n_k, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, q_pos, kv_pos,
      lse, delta, (T*)dk, (T*)dv, Sq, Skv, H, Hkv, Dq, Dv, causal, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a CTA of either kernel takes at these widths.
long long flash_prefill_bwd_smem_bytes(int Dq, int Dv) {
  return (long long)smem_bytes(Dq, Dv);
}

// dtype: 0 f32, 1 bf16 (q, k, v, o, do and the gradients alike).  lse and
// delta are (B, H, Sq) f32 scratch.  Returns a cudaError_t.
int flash_prefill_bwd(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const int* q_pos,
                      const int* kv_pos, float* lse, float* delta, void* dq,
                      void* dk, void* dv, int B, int Sq, int Skv, int H,
                      int Hkv, int Dq, int Dv, int causal, int window,
                      float scale, int dtype, cudaStream_t stream) {
  if (Dq > 8 * kMaxCols || Dv > 8 * kMaxCols || Dq % 8 || Dv % 8 ||
      H % Hkv) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return launch<float>(q, k, v, o, dout, q_pos, kv_pos, lse, delta, dq,
                         dk, dv, B, Sq, Skv, H, Hkv, Dq, Dv, causal, window,
                         scale, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, o, dout, q_pos, kv_pos, lse, delta,
                                 dq, dk, dv, B, Sq, Skv, H, Hkv, Dq, Dv,
                                 causal, window, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
