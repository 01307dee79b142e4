// The gradient of the Mamba-1 selective scan, for Hopper (sm_90a).
//
// Replaces no TPU kernel: src/repro has no backward kernel (no custom_vjp);
// training there differentiates its Mamba mixer's lax.scan
// (src/repro/models/mamba.py:90) with jax.value_and_grad.  The port runs
// that recurrence through ssm_scan.cu on the card, so its gradient needs a
// kernel too.  It computes what ssm_scan_bwd_plain computes
// (src/repro_torch/kernels/ssm_scan.py) for u / dt (B, S, d), A (d, N) f32,
// B / C (B, S, N), y's gradient dy (B, S, d) f32 and h_final's dh (B, d, N)
// f32 or null, with h_t the forward's states from zero and g_t the
// gradient of h_t, per batch row b, channel c and state n:
//   g_t   = dy_t C_t + exp(dt_{t+1} A) g_{t+1}     (g_{S-1} adds dh)
//   dC_t  = sum_c dy_t h_t
//   dB_t  = sum_c g_t dt_t u_t
//   du_t  = dt_t sum_n g_t B_t
//   ddt_t = u_t sum_n g_t B_t + sum_n A exp(dt_t A) g_t h_{t-1}
//   dA    = sum_{b,t} dt_t exp(dt_t A) g_t h_{t-1}
// du, ddt, dB and dC come back in the inputs' type, dA in f32.
//
// Bound: u, dt, dy, B and C read once, du, ddt, dB, dC and dA written once
// -- bytes; the issue is ~24 f32 operations per (row, step, channel,
// state): the forward's step recomputed, then the reverse step.  Both are
// near 0.05 ms at the training step's shape (B 4, S 256, d 8192, N 16).
//
// Design.  scan_bwd_kernel gives one CTA kCh channels of one batch row for
// all of S, as the forward does, and one thread to each (channel, state)
// pair, so the N threads of a channel are neighbouring lanes of one warp.
// A first sweep runs the forward recurrence (the forward kernel's
// roundings, no FMA contraction) and keeps each thread's state at the
// start of every kChunk-step chunk in global scratch.  Then the chunks run
// in reverse: a chunk's inputs are staged in shared memory as f32, its
// states recomputed from the chunk's first state into shared memory (kChunk
// x kCh x N f32: 64 KB at N 16), and a parallel pass sums dC's share of
// the CTA's channels per (step, state) from them.  The reverse loop then
// carries g in a register down the chunk; per step, du and ddt sum their
// channel's N lanes with a xor butterfly, and g dt u (dB's term) takes the
// place of h_t in shared memory, which no later step reads; after the loop
// a second parallel pass sums dB's share.  A CTA writes its dB and dC
// shares (B, d / kCh, S, N) and each thread its row's dA term (B, d, N) to
// scratch, and sum_kernel adds them over the CTAs and rows in a fixed
// order.  No atomics: two calls give bitwise equal gradients.  exp(dt A)
// is expf, as the forward's, so dA rounds as the plain torch.exp does.
// The loop over a chunk's steps is latency-bound: two CTAs share an SM
// (88 KB of shared memory each at N 16, at most 64 registers a thread),
// and the step loops are unrolled by 4, so the loads, exp and shuffle sums
// of neighbouring steps overlap the one chain that carries h or g.  The
// chunk length changes no rounding: each chunk restarts from the state
// the first sweep reached there.  The tensor cores have no part in a scan.
#include "common.cuh"

namespace {

constexpr int kCh = 32;       // channels per CTA
constexpr int kChunk = 32;    // time steps per chunk
constexpr int kCtasPerSm = 2; // 88 KB of shared memory each at N 16

// a chunk of one batch row's inputs, as f32, and what its passes leave
template <int N>
struct BwdSmem {
  float h[kChunk][kCh * N];   // the chunk's states; then g dt u (dB's terms)
  float u[kChunk][kCh], dt[kChunk][kCh], dy[kChunk][kCh];
  float du[kChunk][kCh], ddt[kChunk][kCh];
  float b[kChunk][N], c[kChunk][N];
};

// grid (ceil(d / kCh), B), kCh * N threads.  hb: (B, chunks, d, N) states
// at each chunk's start; pb / pc: (B, gridDim.x, S, N) the CTAs' shares of
// dB and dC; pa: (B, d, N) each row's share of dA.
template <typename T, int N>
__global__ void __launch_bounds__(kCh * N, kCtasPerSm) scan_bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ dy,
    const float* __restrict__ dh, float* __restrict__ hb,
    float* __restrict__ pb, float* __restrict__ pc, float* __restrict__ pa,
    T* __restrict__ du, T* __restrict__ ddt, int S, int d) {
  constexpr int kThreads = kCh * N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<N>& sm = *reinterpret_cast<BwdSmem<N>*>(smem_raw);
  const int tid = threadIdx.x;
  const int c = tid / N;                      // channel within the CTA
  const int n = tid % N;                      // state
  const int b = blockIdx.y;
  const int j = blockIdx.x;
  const int c0 = j * kCh;
  const bool live = c0 + c < d;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const long long row = (long long)b * S;     // the row's first (b, t)
  const long long hidx = (long long)(c0 + c) * N + n;
  const long long dn = (long long)d * N;
  float* hbb = hb + (long long)b * n_chunks * dn;
  const float a = live ? A[hidx] : 0.f;

  // stage a chunk's inputs as f32: zero past S and past d, so a channel
  // past d has no state and no gradient
  auto stage = [&](int t0, bool grads) {
    const int steps = min(kChunk, S - t0);
    for (int i = tid; i < kChunk * kCh; i += kThreads) {
      const int r = i / kCh, cc = i - r * kCh;
      const bool in = r < steps && c0 + cc < d;
      const long long g = (row + t0 + r) * d + c0 + cc;
      sm.u[r][cc] = in ? to_float(u[g]) : 0.f;
      sm.dt[r][cc] = in ? to_float(dt[g]) : 0.f;
      if (grads) sm.dy[r][cc] = in ? dy[g] : 0.f;
    }
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int r = i / N, nn = i - r * N;
      const long long g = (row + t0 + r) * N + nn;
      sm.b[r][nn] = r < steps ? to_float(Bm[g]) : 0.f;
      if (grads) sm.c[r][nn] = r < steps ? to_float(Cm[g]) : 0.f;
    }
  };
  // the forward's step, rounded as ssm_scan.cu rounds it
  auto step = [&](int r, float h) {
    const float dtv = sm.dt[r][c];
    const float decay = expf(__fmul_rn(dtv, a));
    return __fadd_rn(__fmul_rn(decay, h),
                     __fmul_rn(__fmul_rn(dtv, sm.u[r][c]), sm.b[r][n]));
  };
  // the CTA's share of sum_c sm.h[r][c][nn] x[r][c] (x null: 1) per (step,
  // state) of a chunk, channels in order, into p (B, gridDim.x, S, N)
  auto channel_sums = [&](float* p, const float (*x)[kCh], int t0,
                          int steps) {
    for (int i = tid; i < steps * N; i += kThreads) {
      const int r = i / N, nn = i - r * N;
      float s = 0.f;
      for (int cc = 0; cc < kCh; ++cc) {
        const float v = sm.h[r][cc * N + nn];
        s = __fadd_rn(s, x == nullptr ? v : __fmul_rn(x[r][cc], v));
      }
      p[(((long long)b * gridDim.x + j) * S + t0 + r) * N + nn] = s;
    }
  };

  // 1. the forward sweep: each chunk's first state
  float h = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    if (live) hbb[k * dn + hidx] = h;
    if (k + 1 == n_chunks) break;
    __syncthreads();                          // the last chunk's reads done
    stage(k * kChunk, false);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kChunk; ++r) h = step(r, h);
  }

  // 2. the chunks in reverse
  float g = live && dh != nullptr ? dh[(long long)b * dn + hidx] : 0.f;
  float ga = 0.f;                             // the row's share of dA
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int steps = min(kChunk, S - t0);
    __syncthreads();                          // the last chunk's passes done
    stage(t0, true);
    const float h_in = live ? hbb[k * dn + hidx] : 0.f;
    __syncthreads();
    float hh = h_in;
#pragma unroll 4
    for (int r = 0; r < steps; ++r) {
      hh = step(r, hh);
      sm.h[r][tid] = hh;
    }
    __syncthreads();
    channel_sums(pc, sm.dy, t0, steps);       // dC: sum_c dy_t h_t
    __syncthreads();                          // before h_t is overwritten
#pragma unroll 4
    for (int r = steps - 1; r >= 0; --r) {
      const float dtv = sm.dt[r][c], uv = sm.u[r][c];
      g = __fadd_rn(g, __fmul_rn(sm.dy[r][c], sm.c[r][n]));       // g_t
      const float hp = r > 0 ? sm.h[r - 1][tid] : h_in;           // h_{t-1}
      const float decay = expf(__fmul_rn(dtv, a));
      const float gdh = __fmul_rn(__fmul_rn(g, decay), hp);
      ga = __fadd_rn(ga, __fmul_rn(gdh, dtv));
      float gb = __fmul_rn(g, sm.b[r][n]);
      float agdh = __fmul_rn(a, gdh);
#pragma unroll
      for (int off = N / 2; off > 0; off /= 2) {   // the channel's N lanes
        gb = __fadd_rn(gb, __shfl_xor_sync(0xffffffffu, gb, off));
        agdh = __fadd_rn(agdh, __shfl_xor_sync(0xffffffffu, agdh, off));
      }
      if (n == 0) {
        sm.du[r][c] = __fmul_rn(dtv, gb);
        sm.ddt[r][c] = __fadd_rn(__fmul_rn(uv, gb), agdh);
      }
      sm.h[r][tid] = __fmul_rn(g, __fmul_rn(dtv, uv));  // dB's term
      g = __fmul_rn(g, decay);                          // to step t-1
    }
    __syncthreads();
    channel_sums(pb, nullptr, t0, steps);     // dB: sum_c g_t dt_t u_t
    for (int i = tid; i < steps * kCh; i += kThreads) {
      const int r = i / kCh, cc = i - r * kCh;
      if (c0 + cc >= d) continue;
      const long long gi = (row + t0 + r) * d + c0 + cc;
      du[gi] = from_float<T>(sm.du[r][cc]);
      ddt[gi] = from_float<T>(sm.ddt[r][cc]);
    }
  }
  if (live) pa[(long long)b * dn + hidx] = ga;
}

// dst[o][i] = sum_{q < Q} src[o][q][i], q in order, rounded to T once
template <typename T>
__global__ void sum_kernel(const float* __restrict__ src, T* __restrict__ dst,
                           int O, int Q, long long I) {
  const long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (x >= O * I) return;
  const long long o = x / I, i = x - o * I;
  const float* p = src + o * Q * I + i;
  float s = 0.f;
  for (int q = 0; q < Q; ++q) s = __fadd_rn(s, p[q * I]);
  dst[x] = from_float<T>(s);
}

template <typename T>
cudaError_t sum_into(const float* src, void* dst, int O, int Q, long long I,
                     cudaStream_t stream) {
  constexpr int kSumThreads = 256;
  const long long n = O * I;
  sum_kernel<T><<<(unsigned)((n + kSumThreads - 1) / kSumThreads),
                  kSumThreads, 0, stream>>>(src, static_cast<T*>(dst), O, Q,
                                            I);
  return cudaGetLastError();
}

struct Scratch {
  float *hb, *pb, *pc, *pa;
};

Scratch carve(float* base, int B, int S, int d, int N) {
  const long long chunks = (S + kChunk - 1) / kChunk;
  const long long ctas = (d + kCh - 1) / kCh;
  Scratch s;
  s.hb = base;
  s.pb = s.hb + B * chunks * d * N;
  s.pc = s.pb + B * ctas * S * N;
  s.pa = s.pc + B * ctas * S * N;
  return s;
}

long long scratch_floats(int B, int S, int d, int N) {
  const long long chunks = (S + kChunk - 1) / kChunk;
  const long long ctas = (d + kCh - 1) / kCh;
  return (long long)B * (chunks * d * N + 2 * ctas * S * N + (long long)d * N);
}

template <typename T, int N>
cudaError_t launch_n(const void* u, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* dy,
                     const void* dh, float* scratch, void* du, void* ddt,
                     void* dA, void* dB, void* dC, int B, int S, int d,
                     cudaStream_t stream) {
  const Scratch s = carve(scratch, B, S, d, N);
  const size_t smem = sizeof(BwdSmem<N>);
  cudaError_t err = allow_smem(scan_bwd_kernel<T, N>, smem);
  if (err != cudaSuccess) return err;
  const int ctas = (d + kCh - 1) / kCh;
  scan_bwd_kernel<T, N><<<dim3(ctas, B), kCh * N, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(dh), s.hb, s.pb, s.pc, s.pa,
      static_cast<T*>(du), static_cast<T*>(ddt), S, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_into<T>(s.pb, dB, B, ctas, (long long)S * N, stream)) !=
      cudaSuccess)
    return err;
  if ((err = sum_into<T>(s.pc, dC, B, ctas, (long long)S * N, stream)) !=
      cudaSuccess)
    return err;
  return sum_into<float>(s.pa, dA, 1, B, (long long)d * N, stream);
}

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* dy,
                   const void* dh, float* scratch, void* du, void* ddt,
                   void* dA, void* dB, void* dC, int B, int S, int d, int N,
                   cudaStream_t stream) {
  switch (N) {   // falcon-mamba's and Jamba's d_state, and the tests' 8
    case 8:
      return launch_n<T, 8>(u, dt, A, Bm, Cm, dy, dh, scratch, du, ddt, dA,
                            dB, dC, B, S, d, stream);
    case 16:
      return launch_n<T, 16>(u, dt, A, Bm, Cm, dy, dh, scratch, du, ddt, dA,
                             dB, dC, B, S, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The f32 scratch ssm_scan_bwd needs, in floats.
long long ssm_scan_bwd_scratch_floats(int B, int S, int d, int N) {
  return scratch_floats(B, S, d, N);
}

// u / dt (B, S, d), Bm / Cm (B, S, N) in one type (dtype: 0 = f32, 1 =
// bf16); A (d, N) f32; dy (B, S, d) f32; dh (B, d, N) f32 or NULL (zero);
// scratch of ssm_scan_bwd_scratch_floats(B, S, d, N) floats.  du / ddt /
// dB / dC in the inputs' type, dA (d, N) f32.  N is 8 or 16; S >= 1.
// Returns the first failed launch's cudaError_t (0 = all launched).
int ssm_scan_bwd(const void* u, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* dy, const void* dh,
                 void* scratch, void* du, void* ddt, void* dA, void* dB,
                 void* dC, int B, int S, int d, int N, int dtype,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(u, dt, A, Bm, Cm, dy, dh, sc, du,
                                         ddt, dA, dB, dC, B, S, d, N, s)
                 : launch<float>(u, dt, A, Bm, Cm, dy, dh, sc, du, ddt, dA,
                                 dB, dC, B, S, d, N, s);
  return (int)err;
}

}  // extern "C"
