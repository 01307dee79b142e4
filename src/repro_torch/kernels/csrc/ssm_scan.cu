// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan_pallas /
// _ssm_scan_kernel) and computes what repro.kernels.ref.ssm_scan_ref
// computes, per batch row b, channel c and state n:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = sum_n h_t * C_t
// over u / dt (B, S, d), A (d, N) f32 and B / C (B, S, N), from h0 (B, d, N)
// or zero, returning y (B, S, d) and h_final (B, d, N).  Every input is read
// as f32 before any product, as the TPU kernel casts its blocks.  y and
// h_final are f32, or (the in-place mode of the decode step) y in the
// activation type and h_final in the state's own type, rounded to nearest
// as a cast would round them; h_final may be h0 itself.
//
// Bound: each input is read once and y and h_final are written once — bytes.
// What really limits a prefill is the issue of its steps: ~15 instructions
// per (step, channel, state), 8 of them the exp, which has to be expf to
// round as the plain version's torch.exp rounds; S steps of each h depend
// on each other.
//
// Design.  The Pallas grid (B, d / db, S / Sc) walks the time chunks in order
// and carries the (db, N) state in VMEM scratch from one grid step to the
// next.  A CUDA grid runs in no order, so scan_kernel gives one CTA kCh
// channels of one batch row for all of S and loops over the time chunks
// itself.  A thread holds kSpt states of one channel in registers (states
// jt, jt + kNt, ... of the channel's kNt threads).  The time chunks are
// staged double-buffered: each thread loads its share of chunk k + 1's u,
// dt, B and C into registers before chunk k's serial loop and stores it to
// shared memory after the loop, so those loads are in flight while the CTA
// scans chunk k.  The store is a parallel pass that forms, once per (step,
// channel), dt in f32 and dt * u (rounded, as the plain version rounds it),
// and lays B and C out in f32 with a thread's kSpt states side by side: a
// step reads three vectors.  In a step the only work that depends on the
// previous step is h = dA * h + dBu, one multiply and one add, each rounded
// (no FMA contraction), in the plain version's order, so h_final is
// bitwise the plain version's.  exp(dt * a), dBu and the thread's share of
// y_t depend on no earlier step, and the unrolled loop overlaps them with
// the h chains of the steps around them; each thread stores its share of
// y_t to shared memory, and after the chunk the CTA sums each y_t's kNt
// shares and writes the chunk's y, neighbouring threads on neighbouring
// channels.  y_t sums the products h * C in the order of a xor butterfly
// over the N states (tree_sum), the order of the kernel that first served
// the decode path, so the served streams stay what they were.  S is not
// split over CTAs: at B = 1 and d = 8192 the card already holds 16 warps an
// SM, and a chunked carry would add work to an issue-bound loop and
// reassociate h.  No shuffles, no atomics: bitwise equal from run to run.
//   The decode step (S = 1) has no sequence to stage: step_kernel gives a
// thread one (row, channel) with its N states, reads h0, A, B and C with
// 16-byte loads, takes the one step and writes h_final and y_t, no shared
// memory and no barrier.
#include "common.cuh"

namespace {

constexpr int kSpt = 2;       // states per thread (scan_kernel)
constexpr int kCh = 32;       // channels per CTA (scan_kernel)
constexpr int kChunk = 64;    // time steps staged per chunk
constexpr int kStepThreads = 128;

// a state's storage: 0 = f32, 1 = bf16 (the wrappers' dtype codes)
__device__ __forceinline__ float load_as(const void* p, long long i,
                                         int code) {
  return code == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                   : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_as(void* p, long long i, float x,
                                         int code) {
  if (code == 1) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else static_cast<float*>(p)[i] = x;
}

// n consecutive values of X from 16-byte-aligned p (n * sizeof(X) a
// multiple of 16), as f32
template <int n>
__device__ __forceinline__ void load16(const float* p, float* o) {
#pragma unroll
  for (int i = 0; i < n / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    o[4 * i] = v.x, o[4 * i + 1] = v.y, o[4 * i + 2] = v.z,
          o[4 * i + 3] = v.w;
  }
}
template <int n>
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
#pragma unroll
  for (int i = 0; i < n / 8; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      o[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}
template <int n>
__device__ __forceinline__ void store16(float* p, const float* x) {
#pragma unroll
  for (int i = 0; i < n / 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}
template <int n>
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* x) {
#pragma unroll
  for (int i = 0; i < n / 8; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = __bfloat16_as_ushort(__float2bfloat16(x[8 * i + 2 * j])) |
             (uint32_t)__bfloat16_as_ushort(
                 __float2bfloat16(x[8 * i + 2 * j + 1])) << 16;
    reinterpret_cast<uint4*>(p)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The sum of v[0..K) that a xor butterfly (offsets K/2, ..., 1) leaves in
// lane 0: v[j] + v[j + K/2] first, and so on down.  v is overwritten.
template <int K>
__device__ __forceinline__ float tree_sum(float* v) {
#pragma unroll
  for (int half = K / 2; half > 0; half /= 2)
#pragma unroll
    for (int j = 0; j < half; ++j) v[j] += v[j + half];
  return v[0];
}

// n consecutive f32 values of shared memory, aligned to 4 n bytes
template <int n>
__device__ __forceinline__ void lds_vec(const float* p, float* o) {
  if constexpr (n == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else if constexpr (n == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x, o[1] = v.y;
  } else {
    static_assert(n == 1, "states per thread");
    o[0] = *p;
  }
}

// scan_kernel's shared memory: a chunk as f32, double-buffered -- (dt,
// dt * u) per (step, channel), and the B and C rows with the states
// permuted so that a thread's kSpt lie side by side -- and each thread's
// share of every y_t of the chunk
template <int N>
struct ScanSmem {
  static constexpr int kNt = N / kSpt;        // threads per channel
  float2 dd[2][kChunk][kCh];
  alignas(16) float bc[2][kChunk][2][N];
  alignas(16) float y[kChunk][kCh][kNt];
};

// The whole-sequence scan.  grid (ceil(d / kCh), B), N / kSpt * kCh threads.
template <typename T, int N>
__global__ void __launch_bounds__(N / kSpt * kCh) scan_kernel(
    const T* __restrict__ u, const T* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const void* h0, int h0_code, void* y,
    int y_code, void* h_out, int h_code, int S, int d) {
  constexpr int kNt = ScanSmem<N>::kNt;
  constexpr int kThreads = kNt * kCh;
  constexpr int kU = kChunk * kCh / kThreads;  // (step, channel) pairs and
  constexpr int kB = kChunk * N / kThreads;    // B / C values a thread stages
  static_assert(kU * kThreads == kChunk * kCh && kB * kThreads == kChunk * N,
                "staging shares");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem<N>& sm = *reinterpret_cast<ScanSmem<N>*>(smem_raw);
  auto& dd_s = sm.dd;
  auto& bc_s = sm.bc;
  auto& y_s = sm.y;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCh;
  const int c = tid / kNt;                    // channel within the CTA
  const int jt = tid % kNt;                   // states jt + kNt * j
  const bool live = c0 + c < d;
  const long long hrow = ((long long)b * d + c0 + c) * N + jt;
  float a[kSpt], h[kSpt];
#pragma unroll
  for (int j = 0; j < kSpt; ++j) {
    a[j] = live ? A[(long long)(c0 + c) * N + jt + kNt * j] : 0.f;
    h[j] = live && h0 != nullptr ? load_as(h0, hrow + kNt * j, h0_code)
                                 : 0.f;
  }

  const T* ub = u + (long long)b * S * d;
  const T* dtb = dt + (long long)b * S * d;
  const T* bb = Bm + (long long)b * S * N;
  const T* cb = Cm + (long long)b * S * N;
  const long long yb = (long long)b * S * d;

  // the next chunk's inputs, loaded into registers before a chunk's loop
  // and stored to shared memory after it
  T pu[kU], pdt[kU], pb[kB], pc[kB];
  auto fetch = [&](int t0) {
    const int steps = min(kChunk, S - t0);
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const int i = tid + q * kThreads, r = i / kCh, j = i - r * kCh;
      const bool in = r < steps && c0 + j < d;
      const long long g = (long long)(t0 + r) * d + c0 + j;
      pu[q] = in ? ub[g] : from_float<T>(0.f);
      pdt[q] = in ? dtb[g] : from_float<T>(0.f);
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int i = tid + q * kThreads, r = i / N, n = i - r * N;
      const long long g = (long long)(t0 + r) * N + n;
      pb[q] = r < steps ? bb[g] : from_float<T>(0.f);
      pc[q] = r < steps ? cb[g] : from_float<T>(0.f);
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const int i = tid + q * kThreads, r = i / kCh, j = i - r * kCh;
      const float dtv = to_float(pdt[q]);
      dd_s[buf][r][j] = make_float2(dtv, __fmul_rn(dtv, to_float(pu[q])));
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int i = tid + q * kThreads, r = i / N, n = i - r * N;
      const int at = (n % kNt) * kSpt + n / kNt;
      bc_s[buf][r][0][at] = to_float(pb[q]);
      bc_s[buf][r][1][at] = to_float(pc[q]);
    }
  };

  const int n_chunks = (S + kChunk - 1) / kChunk;
  fetch(0);
  put(0);
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk;
    const int steps = min(kChunk, S - t0);
    if (k + 1 < n_chunks) fetch(t0 + kChunk);   // in flight during the loop
    __syncthreads();

    const int buf = k & 1;
#pragma unroll 8
    for (int r = 0; r < steps; ++r) {
      const float2 dd = dd_s[buf][r][c];       // dt, dt * u
      float bv[kSpt], cv[kSpt], p[kSpt];
      lds_vec<kSpt>(&bc_s[buf][r][0][jt * kSpt], bv);
      lds_vec<kSpt>(&bc_s[buf][r][1][jt * kSpt], cv);
#pragma unroll
      for (int j = 0; j < kSpt; ++j) {
        const float dA = expf(__fmul_rn(dd.x, a[j]));
        h[j] = __fadd_rn(__fmul_rn(dA, h[j]), __fmul_rn(dd.y, bv[j]));
        p[j] = __fmul_rn(h[j], cv[j]);
      }
      y_s[r][c][jt] = tree_sum<kSpt>(p);
    }
    // the other buffer was last read in chunk k - 1's loop, before this
    // chunk's barrier
    if (k + 1 < n_chunks) put(buf ^ 1);
    __syncthreads();

    // y_t of the chunk: each channel's kNt shares
    for (int i = tid; i < steps * kCh; i += kThreads) {
      const int r = i / kCh, j = i - r * kCh;
      if (c0 + j >= d) continue;
      float sh[kNt];
#pragma unroll
      for (int q = 0; q < kNt; q += kNt < 4 ? kNt : 4)
        lds_vec<kNt < 4 ? kNt : 4>(&y_s[r][j][q], sh + q);
      store_as(y, yb + (long long)(t0 + r) * d + c0 + j, tree_sum<kNt>(sh),
               y_code);
    }
    // y_s is written again only after the next chunk's first barrier
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kSpt; ++j)
      store_as(h_out, hrow + kNt * j, h[j], h_code);
  }
}

// One step from h0 (S = 1): a thread per (row, channel) with its N states.
// Every pointer 16-byte aligned (the launcher checks).
template <typename T, int N>
__global__ void __launch_bounds__(kStepThreads) step_kernel(
    const T* __restrict__ u, const T* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const void* h0, int h0_code, void* y,
    int y_code, void* h_out, int h_code, int B, int d) {
  const int i = blockIdx.x * kStepThreads + threadIdx.x;
  if (i >= B * d) return;
  const int b = i / d;
  const int c = i - b * d;
  const float dtv = to_float(dt[i]);
  const float du = __fmul_rn(dtv, to_float(u[i]));
  float a[N], h[N], bv[N], cv[N];
  load16<N>(A + (long long)c * N, a);
  load16<N>(Bm + (long long)b * N, bv);
  load16<N>(Cm + (long long)b * N, cv);
  if (h0 == nullptr) {
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = 0.f;
  } else if (h0_code == 1) {
    load16<N>(static_cast<const __nv_bfloat16*>(h0) + (long long)i * N, h);
  } else {
    load16<N>(static_cast<const float*>(h0) + (long long)i * N, h);
  }
  float p[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float dA = expf(__fmul_rn(dtv, a[n]));
    h[n] = __fadd_rn(__fmul_rn(dA, h[n]), __fmul_rn(du, bv[n]));
    p[n] = __fmul_rn(h[n], cv[n]);
  }
  const long long hi = (long long)i * N;
  if (h_code == 1) store16<N>(static_cast<__nv_bfloat16*>(h_out) + hi, h);
  else store16<N>(static_cast<float*>(h_out) + hi, h);
  store_as(y, i, tree_sum<N>(p), y_code);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int N>
cudaError_t launch_n(const void* u, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* h0,
                     int h0_code, void* y, int y_code, void* h_out,
                     int h_code, int B, int S, int d, cudaStream_t stream) {
  const T *ut = static_cast<const T*>(u), *dtt = static_cast<const T*>(dt);
  const T *bt = static_cast<const T*>(Bm), *ct = static_cast<const T*>(Cm);
  const float* at = static_cast<const float*>(A);
  const bool al = aligned16(u) && aligned16(dt) && aligned16(Bm) &&
                  aligned16(Cm);
  if (S == 1 && al && aligned16(A) && aligned16(h0) && aligned16(h_out)) {
    const int n = B * d;
    step_kernel<T, N><<<(n + kStepThreads - 1) / kStepThreads, kStepThreads,
                        0, stream>>>(
        ut, dtt, at, bt, ct, h0, h0_code, y, y_code, h_out, h_code, B, d);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(ScanSmem<N>);
  cudaError_t err = allow_smem(scan_kernel<T, N>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((d + kCh - 1) / kCh, B);
  scan_kernel<T, N><<<grid, N / kSpt * kCh, smem, stream>>>(
      ut, dtt, at, bt, ct, h0, h0_code, y, y_code, h_out, h_code, S, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* h0,
                   int h0_code, void* y, int y_code, void* h_out, int h_code,
                   int B, int S, int d, int N, cudaStream_t stream) {
  switch (N) {   // falcon-mamba's d_state, and 8 (the tests' second N)
    case 8:
      return launch_n<T, 8>(u, dt, A, Bm, Cm, h0, h0_code, y, y_code, h_out,
                            h_code, B, S, d, stream);
    case 16:
      return launch_n<T, 16>(u, dt, A, Bm, Cm, h0, h0_code, y, y_code,
                             h_out, h_code, B, S, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// u / dt (B, S, d), Bm / Cm (B, S, N) in one type (dtype: 0 = f32,
// 1 = bf16); A (d, N) f32; h0 (B, d, N) in h0_dtype, or NULL for a zero
// initial state; y (B, S, d) in y_dtype; h_out (B, d, N) in h_dtype, which
// may be h0 itself.  N is 8 or 16.
// Returns the launch's cudaError_t (0 = launched).
int ssm_scan(const void* u, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* h0, void* y, void* h_out, int B,
             int S, int d, int N, int dtype, int h0_dtype, int y_dtype,
             int h_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1
          ? launch<__nv_bfloat16>(u, dt, A, Bm, Cm, h0, h0_dtype, y, y_dtype,
                                  h_out, h_dtype, B, S, d, N, s)
          : launch<float>(u, dt, A, Bm, Cm, h0, h0_dtype, y, y_dtype, h_out,
                          h_dtype, B, S, d, N, s);
  return (int)err;
}

}  // extern "C"
