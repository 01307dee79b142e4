// The gradient of the grouped expert SwiGLU FFN, for Hopper (sm_90a).
//
// Replaces no TPU kernel: src/repro has no backward kernel (no custom_vjp);
// training there differentiates the jnp experts_compute
// (src/repro/models/moe.py:163) with jax.value_and_grad.  The port computes
// that forward with expert_ffn.cu on the card, so its gradient needs a
// kernel too.  It computes what expert_ffn_bwd_plain computes
// (src/repro_torch/kernels/expert_ffn.py) for x (E, C, D), gate / up (E, D,
// F), down (E, F, D) and the output gradient dy (E, C, D), per expert:
//   a = x @ gate, b = x @ up            (f32, recomputed)
//   h = silu(a) * b rounded to x's type (what the forward's down product
//                                        read; the cast passes the gradient
//                                        straight through)
//   dh = dy @ down^T
//   da = dh * b * silu'(a),  db = dh * silu(a)
//   dx = da @ gate^T + db @ up^T
//   dgate = x^T @ da,  dup = x^T @ db,  ddown = h^T @ dy.
// An empty row of the capacity buffer (a dropped copy: x = 0) has a = b =
// 0, so da = db = h = 0 there and it adds nothing to any gradient.
//
// Work.  Seven products of one shape family, each a launch of one batched
// tiled product (gemm_kernel: C[e] = A[e] B[e] (+ A2[e] B2[e]), every
// operand read through its own strides, so the transposes cost nothing but
// the load pattern), and one elementwise pass between the first three and
// the last four that turns (a, b, dh) into (da, db, h) in place, in f32
// scratch the wrapper allocates.  A CTA owns a 64 x 64 tile of one
// expert's output, stages 16-deep slices of A and B in shared memory and
// gives each of its 256 threads a 4 x 4 block of outputs, each summed over
// the reduction axis (C for the weight gradients, F or D otherwise) in
// one fixed order: no atomics, and two calls give bitwise equal
// gradients.
//
// Arithmetic.  f32 on FMA for both storage types (bf16 operands are read
// into f32 shared memory; each gradient is rounded to its type once): on
// the tensor cores f32 would multiply as TF32.
//
// Bound: at the training step's capacity buffer (E 64, C 80, D 2048, F
// 1408) the gradients and weights are 3 x 0.74 GB each way in f32 (0.44 ms
// at 3.35 TB/s) and the products 7 x 2 E C D F = 207 GFLOP (3.1 ms on the
// f32 FMA units): the FMA rate bounds it in f32, the bytes in bf16.  This
// simple kernel runs well below either; the tensor cores (ffn_mma.cuh's
// tile loop) are later work.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kPad = kBM + 1;      // a staged slice's row: 64 values + 1

struct Strides {
  long long e, r, c;               // expert, row, column
};

// C[e][m][n] = sum_k A[e](m, k) B[e](k, n) (+ the same over A2, B2), for m
// < M, n < N; an operand's element (i, j) lies at e * s.e + i * s.r + j *
// s.c.  A2 / B2 (may be null) share A's / B's strides.
template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads) gemm_kernel(
    const TA* __restrict__ A, const TB* __restrict__ Bm,
    const TA* __restrict__ A2, const TB* __restrict__ B2, Strides sa,
    Strides sb, TC* __restrict__ C, Strides sc, int M, int N, int K) {
  __shared__ float a_s[kBK][kPad];   // a_s[k][m]
  __shared__ float b_s[kBK][kPad];   // b_s[k][n]
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // the load pattern follows the operand's unit stride, so neighbouring
  // threads read neighbouring addresses
  const bool a_k_fast = sa.c == 1, b_k_fast = sb.r == 1;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int n_pairs = A2 == nullptr ? 1 : 2;
  for (int pair = 0; pair < n_pairs; ++pair) {
    const TA* a = (pair == 0 ? A : A2) + e * sa.e;
    const TB* bm = (pair == 0 ? Bm : B2) + e * sb.e;
    for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
      for (int l = 0; l < kBM * kBK / kThreads; ++l) {
        const int idx = tid + l * kThreads;
        const int m = a_k_fast ? idx / kBK : idx % kBM;
        const int k = a_k_fast ? idx % kBK : idx / kBM;
        const int gm = m0 + m, gk = k0 + k;
        a_s[k][m] = gm < M && gk < K ? to_float(a[gm * sa.r + gk * sa.c])
                                     : 0.f;
      }
#pragma unroll
      for (int l = 0; l < kBN * kBK / kThreads; ++l) {
        const int idx = tid + l * kThreads;
        const int n = b_k_fast ? idx / kBK : idx % kBN;
        const int k = b_k_fast ? idx % kBK : idx / kBN;
        const int gn = n0 + n, gk = k0 + k;
        b_s[k][n] = gn < N && gk < K ? to_float(bm[gk * sb.r + gn * sb.c])
                                     : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a_s[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }
  TC* c = C + e * sc.e;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        c[gm * sc.r + gn * sc.c] = from_float<TC>(acc[i][j]);
      }
    }
  }
}

// (a, b, dh) -> (da, db, h) in place; h rounded to T as the forward's
// epilogue rounds it (the same f32 silu, g / (1 + exp(-g)))
template <typename T>
__global__ void swiglu_grad_kernel(float* __restrict__ a_da,
                                   float* __restrict__ b_db,
                                   float* __restrict__ dh_h, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float a = a_da[i], b = b_db[i], dh = dh_h[i];
    const float ex = expf(-a);
    const float silu = a / (1.f + ex);
    const float sig = 1.f / (1.f + ex);
    a_da[i] = dh * b * sig * (1.f + a * (1.f - sig));
    b_db[i] = dh * silu;
    dh_h[i] = round_to<T>(silu * b);
  }
}

template <typename TA, typename TB, typename TC>
cudaError_t gemm(const TA* A, const TB* B, const TA* A2, const TB* B2,
                 Strides sa, Strides sb, TC* C, Strides sc, int E, int M,
                 int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  gemm_kernel<TA, TB, TC><<<grid, kThreads, 0, stream>>>(A, B, A2, B2, sa,
                                                         sb, C, sc, M, N, K);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* x, const T* gate, const T* up, const T* down,
           const T* dy, float* a, float* b, float* dh, T* dx, T* dgate,
           T* dup, T* ddown, int E, int C, int D, int F,
           cudaStream_t stream) {
  const long long CD = (long long)C * D, CF = (long long)C * F,
                  DF = (long long)D * F;
  // row-major (E, C, D), (E, C, F), (E, D, F), (E, F, D) and transposes
  const Strides x_cd{CD, D, 1}, x_dc{CD, 1, D};
  const Strides s_cf{CF, F, 1}, s_fc{CF, 1, F};
  const Strides w_df{DF, F, 1}, w_fd{DF, 1, F};    // gate, up
  const Strides dn_fd{DF, D, 1}, dn_df{DF, 1, D};  // down
  cudaError_t err;
  // a, b, dh: (C, F) per expert, over D
  if ((err = gemm<T, T, float>(x, gate, nullptr, nullptr, x_cd, w_df, a,
                               s_cf, E, C, F, D, stream)) != cudaSuccess ||
      (err = gemm<T, T, float>(x, up, nullptr, nullptr, x_cd, w_df, b, s_cf,
                               E, C, F, D, stream)) != cudaSuccess ||
      (err = gemm<T, T, float>(dy, down, nullptr, nullptr, x_cd, dn_df, dh,
                               s_cf, E, C, F, D, stream)) != cudaSuccess) {
    return (int)err;
  }
  const long long n = (long long)E * CF;
  const int blocks = (int)std::min<long long>((n + 255) / 256, 132 * 16);
  swiglu_grad_kernel<T><<<blocks, 256, 0, stream>>>(a, b, dh, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dx = da gate^T + db up^T: (C, D) over F
  if ((err = gemm<float, T, T>(a, gate, b, up, s_cf, w_fd, dx, x_cd, E, C,
                               D, F, stream)) != cudaSuccess ||
      // dgate = x^T da, dup = x^T db: (D, F) over C
      (err = gemm<T, float, T>(x, a, nullptr, nullptr, x_dc, s_cf, dgate,
                               w_df, E, D, F, C, stream)) != cudaSuccess ||
      (err = gemm<T, float, T>(x, b, nullptr, nullptr, x_dc, s_cf, dup,
                               w_df, E, D, F, C, stream)) != cudaSuccess ||
      // ddown = h^T dy: (F, D) over C
      (err = gemm<float, T, T>(dh, dy, nullptr, nullptr, s_fc, x_cd, ddown,
                               dn_fd, E, F, D, C, stream)) != cudaSuccess) {
    return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16 (x, the weights, dy and the gradients alike).  a,
// b, dh: (E, C, F) f32 scratch each.  Returns a cudaError_t.
int expert_ffn_bwd(const void* x, const void* gate, const void* up,
                   const void* down, const void* dy, float* a, float* b,
                   float* dh, void* dx, void* dgate, void* dup, void* ddown,
                   int E, int C, int D, int F, int dtype,
                   cudaStream_t stream) {
  if (E > 65535 || (long long)D * F > INT_MAX / 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    using T = float;
    return launch<T>((const T*)x, (const T*)gate, (const T*)up,
                     (const T*)down, (const T*)dy, a, b, dh, (T*)dx,
                     (T*)dgate, (T*)dup, (T*)ddown, E, C, D, F, stream);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return launch<T>((const T*)x, (const T*)gate, (const T*)up,
                     (const T*)down, (const T*)dy, a, b, dh, (T*)dx,
                     (T*)dgate, (T*)dup, (T*)ddown, E, C, D, F, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
