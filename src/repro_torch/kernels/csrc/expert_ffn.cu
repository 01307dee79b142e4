// Grouped expert SwiGLU FFN for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/expert_ffn.py
// (expert_ffn_pallas / _expert_ffn_kernel) and computes what
// repro.kernels.ref.expert_ffn_ref computes: for every expert e,
//   h = silu(x[e] @ gate[e]) * (x[e] @ up[e])   (f32 accumulate)
//   y[e] = h.astype(x.dtype) @ down[e]          (f32 accumulate, one cast)
// over the dense capacity buffer x (E, C, D) of the dense-scatter MoE path.
//
// Bound: the buffer has no occupancy, so every expert's three matrices are
// read — 3 * E * D * F weights, 1.1 GB in bf16 at qwen2-moe-a2.7b's widths
// (E 64, D 2048, F 1408), 0.33 ms at 3.35 TB/s.  At C of 8 to 40 rows that
// is 2 to 13 flops per weight byte, far below the ridge point (~295 in
// bf16): bytes bound it, and the design's one aim is to read each weight
// byte once and keep enough of them in flight.
//
// Two kernels split the Pallas F sweep, so every sum has a fixed order:
// gate/up writes h in x's type to an (E, C, F) scratch (a few MB, read back
// from L2), down reads it.  Nothing is summed across CTAs and there are no
// atomics, so the result is bitwise equal from run to run.
//
// bf16 (the serving path): the tensor-core tile loop of ffn_mma.cuh, with
// every expert's C capacity rows as its activation rows (no gather, no
// empty slots).  A CTA owns one 128-column tile of one expert's weights (of
// F for gate/up, of D for down) and covers ALL C rows of that expert, so
// every weight byte leaves device memory exactly once, whatever C is:
// 11 x 64 = 704 CTAs for gate/up (epilogue: h in bf16), 16 x 64 = 1024 for
// down (epilogue: y in bf16).  ffn_mma.cuh says how the ring of cp.async
// stages keeps enough bytes in flight.
// f32 keeps the FMA kernels below as its own instantiation: the tensor
// cores would multiply f32 as TF32 (10-bit mantissa), which breaks the
// 1e-4 tolerance the f32 model phase holds the card to against the CPU.
//
// FMA design (f32).  The Pallas grid (E, C/Cb, F/Fb) sweeps F innermost
// and keeps the (Cb, D) output tile resident across it, which is
// race-free only because the TPU runs the grid in order.  Here:
//   1. gate_up: one CTA per (expert, row tile of kRows, column tile of kCols
//      of F).  Each thread owns one column f and keeps kRows gate and up sums
//      in registers, reading the weights coalesced along F, while the tile's
//      x rows pass through shared memory chunk by chunk.  h = silu(g) * u is
//      rounded to x's type and written to the (E, C, F) scratch.
//   2. down: one CTA per (expert, row tile, column tile of D); the tile's h
//      rows pass through shared memory, each thread owns one output column
//      and loops over all of F in order, then casts once.
#include "common.cuh"
#include "ffn_mma.cuh"

namespace {

constexpr int kRows = 8;      // capacity rows per CTA
constexpr int kCols = 128;    // output columns per CTA (one per thread)
constexpr int kChunk = 512;   // reduction positions staged in shared memory
constexpr int kUnroll = 16;   // weight rows each thread loads ahead
static_assert(kChunk % kUnroll == 0 && kUnroll % 4 == 0,
              "a chunk is whole unroll steps of whole float4 reads");

// The reduction over K (D for gate/up, F for down) runs in chunks of kChunk
// positions: the chunk of the tile's input rows is staged in shared memory
// as f32 (16 KB, so many CTAs stay resident) and read four values at a time,
// and each thread loads kUnroll weight rows into registers before it
// multiplies them, so many loads are in flight.  Positions past K carry
// x = 0 and w = 0: adding their +0 products leaves every sum bitwise what
// the plain sequential loop gives.
template <typename T>
__device__ __forceinline__ void stage_chunk(float* __restrict__ s,
                                            const T* __restrict__ in,
                                            int rows, int K, int k0,
                                            int nk) {
  for (int i = threadIdx.x; i < kRows * kChunk; i += kCols) {
    const int r = i / kChunk;
    const int k = i - r * kChunk;
    s[i] = r < rows && k < nk ? to_float(in[(long long)r * K + k0 + k]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCols) gate_up_kernel(
    const T* __restrict__ x, const T* __restrict__ gate,
    const T* __restrict__ up, T* __restrict__ h, int C, int D, int F) {
  __shared__ __align__(16) float x_s[kRows * kChunk];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kRows;
  const int rows = min(kRows, C - c0);
  const int f = blockIdx.x * kCols + threadIdx.x;
  const bool live = f < F;
  float g[kRows], u[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) g[r] = u[r] = 0.f;
  const T* gcol = gate + (long long)e * D * F + (live ? f : 0);
  const T* ucol = up + (long long)e * D * F + (live ? f : 0);
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const int nd = min(kChunk, D - d0);
    __syncthreads();   // the previous chunk is consumed
    stage_chunk(x_s, x + ((long long)e * C + c0) * D, rows, D, d0, nd);
    __syncthreads();
    for (int dd = 0; dd < nd; dd += kUnroll) {
      float gv[kUnroll], uv[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const bool in = live && dd + j < nd;
        const long long off = (long long)(d0 + dd + j) * F;
        gv[j] = in ? to_float(gcol[off]) : 0.f;
        uv[j] = in ? to_float(ucol[off]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; j += 4) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          // four x values in one read (0 past nd), summed in order
          const float4 xv =
              *reinterpret_cast<const float4*>(x_s + r * kChunk + dd + j);
          g[r] += xv.x * gv[j];
          u[r] += xv.x * uv[j];
          g[r] += xv.y * gv[j + 1];
          u[r] += xv.y * uv[j + 1];
          g[r] += xv.z * gv[j + 2];
          u[r] += xv.z * uv[j + 2];
          g[r] += xv.w * gv[j + 3];
          u[r] += xv.w * uv[j + 3];
        }
      }
    }
  }
  if (!live) return;
  T* ht = h + ((long long)e * C + c0) * F + f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
      const float silu = g[r] / (1.f + expf(-g[r]));
      ht[(long long)r * F] = from_float<T>(silu * u[r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCols) down_kernel(
    const T* __restrict__ h, const T* __restrict__ down, T* __restrict__ y,
    int C, int D, int F) {
  __shared__ __align__(16) float h_s[kRows * kChunk];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kRows;
  const int rows = min(kRows, C - c0);
  const int dcol = blockIdx.x * kCols + threadIdx.x;
  const bool live = dcol < D;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  const T* col = down + (long long)e * F * D + (live ? dcol : 0);
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int nf = min(kChunk, F - f0);
    __syncthreads();
    stage_chunk(h_s, h + ((long long)e * C + c0) * F, rows, F, f0, nf);
    __syncthreads();
    for (int ff = 0; ff < nf; ff += kUnroll) {
      float w[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const bool in = live && ff + j < nf;
        w[j] = in ? to_float(col[(long long)(f0 + ff + j) * D]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; j += 4) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 hv =                            // 0 past nf
              *reinterpret_cast<const float4*>(h_s + r * kChunk + ff + j);
          acc[r] += hv.x * w[j];
          acc[r] += hv.y * w[j + 1];
          acc[r] += hv.z * w[j + 2];
          acc[r] += hv.w * w[j + 3];
        }
      }
    }
  }
  if (!live) return;
  T* yt = y + ((long long)e * C + c0) * D + dcol;
  for (int r = 0; r < rows; ++r) yt[(long long)r * D] = from_float<T>(acc[r]);
}

template <typename T>
cudaError_t launch_fma(const void* x, const void* gate, const void* up,
                       const void* down, void* h, void* y, int E, int C,
                       int D, int F, cudaStream_t stream) {
  const int ctiles = (C + kRows - 1) / kRows;
  dim3 grid_gu((F + kCols - 1) / kCols, ctiles, E);
  gate_up_kernel<T><<<grid_gu, kCols, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gate),
      static_cast<const T*>(up), static_cast<T*>(h), C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_dn((D + kCols - 1) / kCols, ctiles, E);
  down_kernel<T><<<grid_dn, kCols, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(down),
      static_cast<T*>(y), C, D, F);
  return cudaGetLastError();
}

}  // namespace

// -- bf16: tensor cores (the tile loop of ffn_mma.cuh) ------------------------

namespace {
namespace tc {

cudaError_t launch(const void* x, const void* gate, const void* up,
                   const void* down, void* h, void* y, int E, int C, int D,
                   int F, cudaStream_t stream) {
  Ffn p{};
  p.a0 = static_cast<const bf16*>(gate);
  p.a1 = static_cast<const bf16*>(up);
  p.b = static_cast<const bf16*>(x);
  p.out0 = h;
  p.E = E, p.N = C, p.M = F, p.K = D, p.kc = D;
  p.epi = kEpiH;
  p.vec = D % 8 == 0 && F % 8 == 0;
  cudaError_t err = dispatch<2>(p, stream);
  if (err != cudaSuccess) return err;
  p = Ffn{};
  p.a0 = static_cast<const bf16*>(down);
  p.b = static_cast<const bf16*>(h);
  p.out0 = y;
  p.E = E, p.N = C, p.M = D, p.K = F, p.kc = F;
  p.epi = kEpiT;
  p.vec = D % 8 == 0 && F % 8 == 0;
  return dispatch<1>(p, stream);
}

}  // namespace tc

}  // namespace

extern "C" {

// x (E, C, D); gate / up (E, D, F); down (E, F, D); scratch h (E, C, F);
// y (E, C, D).  All in one type — dtype: 0 = f32, 1 = bf16.
// Returns the launches' cudaError_t (0 = ok).
int expert_ffn(const void* x, const void* gate, const void* up,
               const void* down, void* h, void* y, int E, int C, int D,
               int F, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? tc::launch(x, gate, up, down, h, y, E, C, D, F, s)
                 : launch_fma<float>(x, gate, up, down, h, y, E, C, D, F, s);
  return (int)err;
}

}  // extern "C"
