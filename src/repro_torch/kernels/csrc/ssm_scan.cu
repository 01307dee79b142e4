// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan_pallas /
// _ssm_scan_kernel) and computes what repro.kernels.ref.ssm_scan_ref
// computes, per batch row b, channel c and state n:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = sum_n h_t * C_t
// over u / dt (B, S, d), A (d, N) f32 and B / C (B, S, N), from h0 (B, d, N)
// or zero, returning y (B, S, d) f32 and h_final (B, d, N) f32.  Every input
// is read as f32 before any product, as the TPU kernel casts its blocks.
//
// Bound: each input is read once and y and h_final are written once — bytes.
// The ~7 S d N flops are nothing beside them.  What really limits it is the
// sequential depth: S dependent steps on each h.
//
// Design.  The Pallas grid (B, d / db, S / Sc) walks the time chunks in order
// and carries the (db, N) state in VMEM scratch from one grid step to the
// next.  A CUDA grid runs in no order, so here one CTA owns kThreads / N
// channels of one batch row for all of S and loops over the time chunks
// itself.  Each (channel, n) pair is one thread, which keeps its h in
// a register; a channel's N threads are N neighbouring lanes of one warp.
// Before a chunk's serial loop the CTA stages the chunk's u and dt columns of
// its channels and the batch row's B and C rows into shared memory as f32,
// so no step of the loop waits on a device-memory load.  y_t is a xor
// butterfly over the channel's N lanes (every lane ends with the same sum);
// lane 0 keeps it in shared memory and the CTA writes the chunk's y after
// the loop, neighbouring threads on neighbouring channels.  The update of h
// is one multiply and one add, each rounded (no FMA contraction), as the
// plain version computes it.  No atomics: bitwise equal from run to run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;    // time steps staged per chunk

template <typename T, typename H, int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    const T* __restrict__ u, const T* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const H* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ h_out, int S, int d) {
  constexpr int kCh = kThreads / N;   // channels per CTA
  __shared__ float u_s[kChunk][kCh];
  __shared__ float dt_s[kChunk][kCh];
  __shared__ float y_s[kChunk][kCh];
  __shared__ float b_s[kChunk][N];
  __shared__ float c_s[kChunk][N];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCh;
  const int c = threadIdx.x / N;      // channel within the CTA
  const int n = threadIdx.x % N;      // state index
  const bool live = c0 + c < d;       // ragged last CTA: dead lanes still
                                      // take part in the shuffles
  const long long hidx = ((long long)b * d + c0 + c) * N + n;
  const float a = live ? A[(long long)(c0 + c) * N + n] : 0.f;
  float h = (live && h0 != nullptr) ? to_float(h0[hidx]) : 0.f;

  const T* ub = u + (long long)b * S * d;
  const T* dtb = dt + (long long)b * S * d;
  const T* bb = Bm + (long long)b * S * N;
  const T* cb = Cm + (long long)b * S * N;
  float* yb = y + (long long)b * S * d;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    // only the chunk's `steps` rows are staged: the loop reads no others
    const int steps = min(kChunk, S - t0);
    for (int i = threadIdx.x; i < steps * kCh; i += kThreads) {
      const int r = i / kCh, j = i % kCh;
      const bool in = c0 + j < d;
      const long long g = (long long)(t0 + r) * d + c0 + j;
      u_s[r][j] = in ? to_float(ub[g]) : 0.f;
      dt_s[r][j] = in ? to_float(dtb[g]) : 0.f;
    }
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      const int r = i / N, j = i % N;
      const long long g = (long long)(t0 + r) * N + j;
      b_s[r][j] = to_float(bb[g]);
      c_s[r][j] = to_float(cb[g]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < steps; ++r) {
      const float dtv = dt_s[r][c];
      const float dA = expf(dtv * a);
      const float dBu = __fmul_rn(dtv * u_s[r][c], b_s[r][n]);
      h = __fadd_rn(__fmul_rn(dA, h), dBu);
      float p = h * c_s[r][n];
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (n == 0) y_s[r][c] = p;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < steps * kCh; i += kThreads) {
      const int r = i / kCh, j = i % kCh;
      if (c0 + j < d) yb[(long long)(t0 + r) * d + c0 + j] = y_s[r][j];
    }
    // the next chunk's staging writes only u_s .. c_s, which every thread
    // finished reading before the barrier above; y_s is written again only
    // after the next barrier
  }
  if (live) h_out[hidx] = h;
}

template <typename T, typename H, int N>
cudaError_t launch_n(const void* u, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* h0, void* y,
                     void* h_out, int B, int S, int d, cudaStream_t stream) {
  constexpr int kCh = kThreads / N;
  dim3 grid((d + kCh - 1) / kCh, B);
  ssm_scan_kernel<T, H, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const H*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_out), S, d);
  return cudaGetLastError();
}

template <typename T, typename H>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* h0, void* y,
                   void* h_out, int B, int S, int d, int N,
                   cudaStream_t stream) {
  switch (N) {   // falcon-mamba's d_state, and 8 (the tests' second N)
    case 8:
      return launch_n<T, H, 8>(u, dt, A, Bm, Cm, h0, y, h_out, B, S, d,
                               stream);
    case 16:
      return launch_n<T, H, 16>(u, dt, A, Bm, Cm, h0, y, h_out, B, S, d,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const void* u, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* h0,
                     int h0_dtype, void* y, void* h_out, int B, int S, int d,
                     int N, cudaStream_t stream) {
  if (h0 != nullptr && h0_dtype == 1)
    return launch<T, __nv_bfloat16>(u, dt, A, Bm, Cm, h0, y, h_out, B, S, d,
                                    N, stream);
  return launch<T, float>(u, dt, A, Bm, Cm, h0, y, h_out, B, S, d, N, stream);
}

}  // namespace

extern "C" {

// u / dt (B, S, d), Bm / Cm (B, S, N) in one type (dtype: 0 = f32,
// 1 = bf16); A (d, N) f32; h0 (B, d, N) in h0_dtype, or NULL for a zero
// initial state; y (B, S, d) f32; h_out (B, d, N) f32.  N is 8 or 16.
// Returns the launch's cudaError_t (0 = launched).
int ssm_scan(const void* u, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* h0, void* y, void* h_out, int B,
             int S, int d, int N, int dtype, int h0_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? launch_t<__nv_bfloat16>(u, dt, A, Bm, Cm, h0, h0_dtype, y,
                                           h_out, B, S, d, N, s)
                 : launch_t<float>(u, dt, A, Bm, Cm, h0, h0_dtype, y, h_out,
                                   B, S, d, N, s);
  return (int)err;
}

}  // extern "C"
