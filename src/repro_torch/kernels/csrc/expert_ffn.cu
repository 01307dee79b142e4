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
// bf16 (the serving path): one tensor-core kernel does both products, with
// the operands swapped as usual for skinny products — the weight tile is
// the mma's M side and the capacity rows its N side:
//   * A CTA owns one 128-column tile of one expert's weights (of F for
//     gate/up, of D for down) and covers ALL C capacity rows of that
//     expert, padded to a multiple of 8 (the mma's N).  So every weight
//     byte leaves device memory exactly once, whatever C is: 11 x 64 = 704
//     CTAs for gate/up, 16 x 64 = 1024 for down.  Eight warps split the
//     128 weight columns (16 each, one m16 tile); up to 64 rows (gate/up,
//     two accumulators a row) or 128 (down) sit in a warp's registers, and
//     a second warp column sharing the same staged weight tile doubles
//     that.  Only past 128 rows for gate/up, 256 for down, does a CTA
//     stream its weights a second time (not on the serving path, where C
//     is 8, 20 or 40).
//   * The reduction (D or F) runs in stages of 64 positions through a ring
//     of shared-memory stages filled by 16-byte cp.async (zero-filled past
//     the edges: a +0 product changes no sum).  A stage holds the weight
//     tile(s) (64 x 128 bf16, 16 KB each) and the matching 64-wide slice
//     of the capacity rows, streamed beside the weights rather than staged
//     whole: at C = 40 the whole x tile is 160 KB and would leave one CTA
//     per SM, while its slices come from L2 (x is read by every F tile of
//     its expert).  Weights are stored with M contiguous ((E, D, F) and
//     (E, F, D)), so their A fragments come from ldmatrix.trans; the
//     activation rows are K-contiguous, plain ldmatrix B fragments.  Rows
//     are XOR-swizzled by 16-byte chunk so ldmatrix does not conflict.
//     mma.sync.m16n8k16 bf16 with f32 accumulation; silu(g) * u and the
//     casts happen in registers in the epilogue.
//   * Bytes in flight: to cover ~1 us of loaded memory latency at
//     3.35 TB/s the card needs ~3.4 MB in flight, ~25 KB per SM.  The ring
//     has 3 stages (2 loading ahead) while a pass has at most 16 rows, else
//     2 (1 ahead), so the larger stages of wide passes still leave several
//     CTAs on an SM: 2 to 5 CTAs an SM, each 16 to 64 KB ahead, keep 80 to
//     130 KB in flight per SM.
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
#include "mma.cuh"

#include <algorithm>

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

// -- bf16: tensor cores ------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kM = 128;         // weight columns per CTA: 8 warps x m16
constexpr int kMW = kM / 16;
constexpr int kMChunks = kM / 8;
constexpr int kK = 64;          // reduction positions per stage
constexpr int kKChunks = kK / 8;
constexpr int kMaxCols = 2;     // warp columns sharing a staged weight tile
constexpr int kMaxThreads = 32 * kMW * kMaxCols;

// Ring depth: 3 stages (2 in flight) while a pass has at most 16 rows,
// else 2, so the larger stages of wide passes still leave several CTAs
// resident on an SM.
inline int stages_for(int rows) { return rows <= 16 ? 3 : 2; }

// n8 blocks of capacity rows a warp holds: 8 for gate/up (two
// accumulators a block, in the 128 registers a thread of 512 gets), 16 for
// down; with two warp columns a pass covers 128 rows, or 256.
template <int NA>
constexpr int kMaxNB = NA == 2 ? 8 : 16;

// A stage: NA weight tiles (kK rows of kM) and `rows` rows of kK.
template <int NA>
size_t smem_bytes(int rows) {
  return (size_t)stages_for(rows) * (NA * kK * kM + rows * kK) *
         sizeof(bf16);
}

// Stage rows [r0, r0 + nrows) x columns [c0, c0 + 8 CH) of a row-major
// matrix (row stride ld) into a swizzled tile of CH chunks a row;
// positions at or past (rlim, clim) are zeros.  `vec`: rows are 16-byte
// aligned, so whole chunks go by cp.async; a ragged or unaligned chunk is
// copied element by element.
template <int CH>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           int ld, int nrows, int r0,
                                           int rlim, int c0, int clim,
                                           bool vec) {
  for (int i = threadIdx.x; i < nrows * CH; i += blockDim.x) {
    const int r = i / CH, j = i % CH;
    const int gr = r0 + r, gc = c0 + j * 8;
    bf16* d = dst + swz(r, j, CH);
    const bf16* s = src + (long long)gr * ld + gc;
    if (gr < rlim && gc + 8 <= clim && vec) {
      cp_async16(d, s);
    } else if (gr < rlim && gc < clim) {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = gc + e < clim ? s[e] : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    } else {
      cp_async16(d, src, 0);
    }
  }
}

// out[e] (N, M) = epilogue(B[e] (N, K) @ A_a[e] (K, M)) for NA weight
// matrices A_0 (and A_1): NA = 2 is gate/up (out = silu(x @ gate) *
// (x @ up)), NA = 1 is down (out = h @ down).  Grid (ceil(M / kM), E);
// 32 kMW threads per warp column, each warp column holding NB n8 blocks.
template <int NA, int NB>
__global__ void __launch_bounds__(kMaxThreads) ffn_mma_kernel(
    const bf16* __restrict__ a0, const bf16* __restrict__ a1,
    const bf16* __restrict__ b, bf16* __restrict__ out, int N, int M, int K,
    int vec, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int rows = (blockDim.x / (32 * kMW)) * NB * 8;   // rows a pass
  const int a_elems = kK * kM;
  const int stage_elems = NA * a_elems + rows * kK;
  const int e = blockIdx.y;
  const int m0 = blockIdx.x * kM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % kMW, wn = warp / kMW;
  const bf16* a_src[2] = {a0 + (long long)e * K * M,
                          (NA == 2 ? a1 : a0) + (long long)e * K * M};
  const bf16* b_src = b + (long long)e * N * K;
  const int nk = (K + kK - 1) / kK;

  auto load = [&](int buf, int kt, int n0) {
    bf16* st = sm + buf * stage_elems;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      stage_tile<kMChunks>(st + a * a_elems, a_src[a], M, kK, kt * kK, K,
                           m0, M, vec);
    }
    stage_tile<kKChunks>(st + NA * a_elems, b_src, K, rows, n0, N, kt * kK,
                         K, vec);
  };

  for (int n0 = 0; n0 < N; n0 += rows) {
    float acc[NA][NB][4];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][j][c] = 0.f;
    __syncthreads();              // every warp is done with the last pass
#pragma unroll
    for (int s = 0; s < stages - 1; ++s) {
      if (s < nk) load(s, s, n0);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      if (stages == 3) {              // stage kt has landed
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();                // ... for every thread; kt - 1 is free
      const int next = kt + stages - 1;
      if (next < nk) load(next % stages, next, n0);
      cp_async_commit();
      const bf16* st = sm + (kt % stages) * stage_elems;
      const bf16* bt = st + NA * a_elems;
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        // A (16 weight columns x 16 positions) from the [k][m] tile,
        // transposed: matrix q = lane / 8 is k half q / 2, m half q % 2
        uint32_t af[NA][4];
        const int ar = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int ac = wm * 2 + ((lane >> 3) & 1);
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          ldmatrix_x4_trans(af[a], st + a * a_elems + swz(ar, ac, kMChunks));
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          // B (16 positions x 8 rows) from the [n][k] tile: lanes 0-7
          // address k 0-7, lanes 8-15 k 8-15
          uint32_t bfr[2];
          const int br = (wn * NB + j) * 8 + (lane & 7);
          ldmatrix_x2(bfr,
                      bt + swz(br, kk * 2 + ((lane >> 3) & 1), kKChunks));
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            mma_bf16(acc[a][j], af[a], bfr[0], bfr[1]);
          }
        }
      }
    }
    cp_async_wait<0>();

    // c[i]: weight column m0 + wm * 16 + g (+8 for i >= 2), capacity row
    // n0 + (wn * NB + j) * 8 + 2 t (+1 for odd i)
    const int g = lane >> 2, t = lane & 3;
    bf16* o = out + (long long)e * N * M;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + wm * 16 + g + (i >> 1) * 8;
        const int n = n0 + (wn * NB + j) * 8 + 2 * t + (i & 1);
        if (m < M && n < N) {
          float val = acc[0][j][i];
          if (NA == 2) val = val / (1.f + expf(-val)) * acc[NA - 1][j][i];
          o[(long long)n * M + m] = __float2bfloat16(val);
        }
      }
    }
  }
}

template <int NA, int NB>
cudaError_t run(const bf16* a0, const bf16* a1, const bf16* b, bf16* out,
                int E, int N, int M, int K, int vec, int warp_cols,
                cudaStream_t stream) {
  const int rows = warp_cols * NB * 8;
  const size_t smem = smem_bytes<NA>(rows);
  cudaError_t err = allow_smem(ffn_mma_kernel<NA, NB>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + kM - 1) / kM, E);
  ffn_mma_kernel<NA, NB><<<grid, 32 * kMW * warp_cols, smem, stream>>>(
      a0, a1, b, out, N, M, K, vec, stages_for(rows));
  return cudaGetLastError();
}

// The fewest warp columns that hold all N rows, then the fewest n8 blocks
// per warp; launched as the instantiation with that many blocks.
template <int NA, int NB = 1>
cudaError_t dispatch(const bf16* a0, const bf16* a1, const bf16* b,
                     bf16* out, int E, int N, int M, int K, int vec,
                     cudaStream_t stream) {
  const int blocks = (N + 7) / 8;
  const int cols =
      std::min(kMaxCols, (blocks + kMaxNB<NA> - 1) / kMaxNB<NA>);
  if constexpr (NB < kMaxNB<NA>) {
    if ((blocks + cols - 1) / cols > NB) {
      return dispatch<NA, NB + 1>(a0, a1, b, out, E, N, M, K, vec, stream);
    }
  }
  return run<NA, NB>(a0, a1, b, out, E, N, M, K, vec, cols, stream);
}

cudaError_t launch(const void* x, const void* gate, const void* up,
                   const void* down, void* h, void* y, int E, int C, int D,
                   int F, cudaStream_t stream) {
  const int vec = D % 8 == 0 && F % 8 == 0;
  bf16* hb = static_cast<bf16*>(h);
  cudaError_t err = dispatch<2>(static_cast<const bf16*>(gate),
                                static_cast<const bf16*>(up),
                                static_cast<const bf16*>(x), hb, E, C, F, D,
                                vec, stream);
  if (err != cudaSuccess) return err;
  return dispatch<1>(static_cast<const bf16*>(down), nullptr, hb,
                     static_cast<bf16*>(y), E, C, D, F, vec, stream);
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
