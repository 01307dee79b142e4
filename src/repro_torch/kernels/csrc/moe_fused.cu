// Fused MoE expert FFN + combine for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_fused.py
// (moe_fused_pallas / _moe_fused_kernel) and computes what
// repro.kernels.ref.moe_fused_ref computes, with the same drop semantics.
// The sort pass stays outside, as on the TPU: moe_group_tokens (plain
// PyTorch on the device) turns routing into per-expert slot tables
//   tok_idx (E, cap) i32 — the token row filling each slot,
//   wgt     (E, cap) f32 — its combine weight, 0 = empty slot,
// plus the inverse map slot_of (T, k) i32 = e * cap + c, or -1 for a copy
// that was dropped (empty, over capacity, foreign to [offset, offset + E)
// or dead).  Dropped copies contribute 0.
//
// Bound: the bytes of the experts this call actually selected (3 * D * F
// weights each) plus x and y, at 3.35 TB/s — a few rows per expert give
// ~cap flops per weight byte, far below the ridge point.
//
// Design.  The Pallas grid visits every expert and combines with a
// read-modify-write into y that is race-free only because the TPU runs the
// grid in order.  Here three kernels, each sum in a fixed order:
//   1. gate_up: for each (expert, column tile of F) the expert's slot rows
//      of x, gathered through tok_idx (empty slots as zeros), times gate
//      and up; h = silu(x @ gate) * (x @ up) is rounded to x's type (as the
//      TPU kernel does before @down) and written to an (E, cap, F) scratch.
//      A CTA whose expert has no live slot returns before reading any
//      weight, so only the selected experts are read.
//   2. down: for each (expert, column tile of D) the expert's h rows times
//      down, written as f32 per-slot outputs (E, cap, D).
//   3. combine: one CTA per token sums its k copies in fixed k order
//      through slot_of and writes y in x's type.
// No float atomics anywhere: outputs are bitwise equal from run to run,
// which the engine's token-identity guarantees need.
//
// bf16 (the serving path): 1 and 2 are the tensor-core tile loop of
// ffn_mma.cuh.  A CTA owns one 128-column weight tile of one expert and
// covers all cap slots of it (at cap 8, one n8 block), so each live
// weight byte is read once: at T = 8, 23 live experts of 64 give 23 x 11
// gate/up CTAs streaming 1 MB each and 23 x 16 down CTAs of 360 KB.
// f32 keeps FMA kernels: the tensor cores would multiply f32 as TF32,
// which breaks the 1e-4 card-vs-CPU tolerance.  In them one CTA takes
// (expert, slot tile of kRows, column tile of kCols); the tile's x rows
// are gathered into shared memory, each thread owns one output column and
// keeps kRows sums in registers.
#include "common.cuh"
#include "ffn_mma.cuh"

namespace {

constexpr int kRows = 8;    // slots per CTA
constexpr int kCols = 128;  // output columns per CTA (one per thread)
constexpr int kCombineThreads = 256;

// Which of the tile's slots hold a live copy; false for the whole tile
// lets the CTA return before touching the expert's weights.
__device__ __forceinline__ bool tile_live(const float* __restrict__ wgt,
                                          int e, int c0, int cap,
                                          bool* live_s) {
  if (threadIdx.x < kRows) {
    const int c = c0 + threadIdx.x;
    live_s[threadIdx.x] = c < cap && wgt[(long long)e * cap + c] != 0.f;
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) any |= live_s[r];
  return any;
}

template <typename T>
__global__ void __launch_bounds__(kCols) gate_up_kernel(
    const T* __restrict__ x, const T* __restrict__ gate,
    const T* __restrict__ up, const int* __restrict__ tok_idx,
    const float* __restrict__ wgt, float* __restrict__ h_buf, int D, int F,
    int cap) {
  extern __shared__ __align__(16) float x_s[];  // kRows * D
  __shared__ bool live_s[kRows];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kRows;
  if (!tile_live(wgt, e, c0, cap, live_s)) return;

  for (int i = threadIdx.x; i < kRows * D; i += kCols) {
    const int r = i / D;
    const int d = i - r * D;
    float v = 0.f;
    if (live_s[r]) {
      const long long t = tok_idx[(long long)e * cap + c0 + r];
      v = to_float(x[t * D + d]);
    }
    x_s[i] = v;
  }
  __syncthreads();

  const int f = blockIdx.x * kCols + threadIdx.x;
  if (f >= F) return;
  float g[kRows], u[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) g[r] = u[r] = 0.f;
  const T* gcol = gate + (long long)e * D * F + f;
  const T* ucol = up + (long long)e * D * F + f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float gv = to_float(gcol[(long long)d * F]);
    const float uv = to_float(ucol[(long long)d * F]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float xv = x_s[r * D + d];
      g[r] += xv * gv;
      u[r] += xv * uv;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int c = c0 + r;
    if (c < cap) {
      const float silu = g[r] / (1.f + expf(-g[r]));
      h_buf[((long long)e * cap + c) * F + f] =
          to_float(from_float<T>(silu * u[r]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCols) down_kernel(
    const T* __restrict__ down, const float* __restrict__ wgt,
    const float* __restrict__ h_buf, float* __restrict__ out_buf, int D,
    int F, int cap) {
  extern __shared__ __align__(16) float h_s[];  // kRows * F
  __shared__ bool live_s[kRows];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kRows;
  if (!tile_live(wgt, e, c0, cap, live_s)) return;

  const int rows = min(kRows, cap - c0);
  for (int i = threadIdx.x; i < kRows * F; i += kCols) {
    const int r = i / F;
    h_s[i] = r < rows ? h_buf[((long long)e * cap + c0) * F + i] : 0.f;
  }
  __syncthreads();

  const int dcol = blockIdx.x * kCols + threadIdx.x;
  if (dcol >= D) return;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  const T* col = down + (long long)e * F * D + dcol;
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const float w = to_float(col[(long long)f * D]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += h_s[r * F + f] * w;
  }
  for (int r = 0; r < rows; ++r) {
    out_buf[((long long)e * cap + c0 + r) * D + dcol] = acc[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads) combine_kernel(
    const float* __restrict__ out_buf, const float* __restrict__ wgt,
    const int* __restrict__ slot_of, T* __restrict__ y, int k, int D) {
  const int t = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const int slot = slot_of[t * k + j];
      if (slot < 0) continue;
      const float w = wgt[slot];
      if (w != 0.f) acc += w * out_buf[(long long)slot * D + d];
    }
    y[(long long)t * D + d] = from_float<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gate, const void* up,
                   const void* down, const int* tok_idx, const float* wgt,
                   const int* slot_of, float* h_buf, float* out_buf, void* y,
                   int T_tok, int k, int D, int F, int E, int cap,
                   cudaStream_t stream) {
  const int ctiles = (cap + kRows - 1) / kRows;
  const size_t smem_gu = (size_t)kRows * D * sizeof(float);
  const size_t smem_dn = (size_t)kRows * F * sizeof(float);
  cudaError_t err = allow_smem(gate_up_kernel<T>, smem_gu);
  if (err != cudaSuccess) return err;
  err = allow_smem(down_kernel<T>, smem_dn);
  if (err != cudaSuccess) return err;

  dim3 grid_gu((F + kCols - 1) / kCols, ctiles, E);
  gate_up_kernel<T><<<grid_gu, kCols, smem_gu, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gate),
      static_cast<const T*>(up), tok_idx, wgt, h_buf, D, F, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_dn((D + kCols - 1) / kCols, ctiles, E);
  down_kernel<T><<<grid_dn, kCols, smem_dn, stream>>>(
      static_cast<const T*>(down), wgt, h_buf, out_buf, D, F, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  combine_kernel<T><<<T_tok, kCombineThreads, 0, stream>>>(
      out_buf, wgt, slot_of, static_cast<T*>(y), k, D);
  return cudaGetLastError();
}

namespace tc {

cudaError_t launch(const void* x, const void* gate, const void* up,
                   const void* down, const int* tok_idx, const float* wgt,
                   const int* slot_of, void* h_buf, float* out_buf, void* y,
                   int T_tok, int k, int D, int F, int E, int cap,
                   cudaStream_t stream) {
  Ffn p{};
  p.a0 = static_cast<const bf16*>(gate);
  p.a1 = static_cast<const bf16*>(up);
  p.b = static_cast<const bf16*>(x);
  p.rows = tok_idx;
  p.wgt = wgt;
  p.out0 = h_buf;
  p.E = E, p.N = cap, p.M = F, p.K = D, p.kc = D;
  p.epi = kEpiH;
  p.vec = aligned16(gate, up, x, F, D) && aligned16(down, h_buf, nullptr,
                                                    D, F);
  const int vec = p.vec;
  cudaError_t err = dispatch<2>(p, stream);
  if (err != cudaSuccess) return err;
  p = Ffn{};
  p.a0 = static_cast<const bf16*>(down);
  p.b = static_cast<const bf16*>(h_buf);
  p.wgt = wgt;
  p.out0 = out_buf;
  p.E = E, p.N = cap, p.M = D, p.K = F, p.kc = F;
  p.epi = kEpiF32;
  p.vec = vec;
  err = dispatch<1>(p, stream);
  if (err != cudaSuccess) return err;
  combine_kernel<bf16><<<T_tok, kCombineThreads, 0, stream>>>(
      out_buf, wgt, slot_of, static_cast<bf16*>(y), k, D);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// Shared memory the two product kernels need (the wrapper checks it).
long long moe_fused_smem_bytes(int D, int F, int cap, int dtype) {
  if (dtype == 1) return (long long)tc::smem_for(cap);
  const long long a = (long long)kRows * D * sizeof(float);
  const long long b = (long long)kRows * F * sizeof(float);
  return a > b ? a : b;
}

// x (T, D); gate / up (E, D, F); down (E, F, D); tok_idx / wgt (E, cap);
// slot_of (T, k); scratch h_buf (E, cap, F) in x's type and out_buf (E,
// cap, D) f32; y (T, D) in x's type.  dtype: 0 = f32, 1 = bf16 (x, the
// expert weights, h_buf and y share it).  Returns the launches'
// cudaError_t (0 = ok).
int moe_fused(const void* x, const void* gate, const void* up,
              const void* down, const void* tok_idx, const void* wgt,
              const void* slot_of, void* h_buf, void* out_buf, void* y,
              int T, int k, int D, int F, int E, int cap, int dtype,
              void* stream) {
  const int* ti = static_cast<const int*>(tok_idx);
  const float* w = static_cast<const float*>(wgt);
  const int* so = static_cast<const int*>(slot_of);
  float* ob = static_cast<float*>(out_buf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1
          ? tc::launch(x, gate, up, down, ti, w, so, h_buf, ob, y, T, k, D,
                       F, E, cap, s)
          : launch<float>(x, gate, up, down, ti, w, so,
                          static_cast<float*>(h_buf), ob, y, T, k, D, F, E,
                          cap, s);
  return (int)err;
}

}  // extern "C"
