// The tensor-core tile loop of the bf16 expert products (sm_90a), shared by
// expert_ffn.cu, moe_fused.cu and decode_megastep.cu: one design for every
// skinny product of a weight bank with a few activation rows per matrix.
//
//   out[e] (N, M) = epilogue(B[e] (N, K) @ A_a[e] (K, M))   for a < NA
//
// NA = 2 is a gate/up product (A_0 = gate, A_1 = up, both applied to the
// same staged rows), NA = 1 a plain one (down, o @ w_post).  Grid
// (ceil(M / kM), E, splits).
//
// Bound: bytes.  At the serving path's few rows a matrix (8 to 40) the
// products do 2 to 16 flops per weight byte, far below the card's ridge
// (~295 in bf16), so the tensor cores' rate is not the limit; the two aims
// are to read each live weight byte exactly once and to keep ~25 KB in
// flight per SM (~1 us of loaded latency at 3.35 TB/s).
//
//   * Operands swapped, as usual for skinny products: the weight tile is
//     the mma's M side and the activation rows its N side.  A CTA owns one
//     kM = 128-column tile of one matrix's weights and covers ALL N rows
//     of it (padded to a multiple of 8, the mma's N), so every weight byte
//     leaves device memory once.  Eight warps split the 128 columns (16
//     each, one m16 tile); up to 64 rows (NA = 2, two accumulators a row)
//     or 128 (NA = 1) sit in a warp's registers, and a second warp column
//     sharing the staged weight tile doubles that.  Only past 128 / 256
//     rows does a CTA stream its weights a second time.
//   * K runs in stages of kK = 64 positions through a ring of shared-memory
//     stages filled by 16-byte cp.async (zero-filled past the edges: a +0
//     product changes no sum).  A stage holds the NA weight tiles (64 x 128
//     bf16, 16 KB each) and the matching 64-wide slice of the rows, which
//     stream beside the weights rather than being staged whole (at 40 rows
//     the whole x tile is 160 KB and would leave one CTA per SM; its slices
//     come from L2).  Weights are stored with M contiguous, so their A
//     fragments come from ldmatrix.trans; the rows are K-contiguous, plain
//     ldmatrix B fragments; both XOR-swizzled by 16-byte chunk.
//   * The ring has 3 stages (2 loading ahead) while a pass has at most 16
//     rows, else 2: 2 to 5 CTAs an SM, each 16 to 64 KB ahead.
//   * Gathered rows: with `rows`, row n of matrix e is row rows[e * N + n]
//     of b (a token of x); with `wgt`, a slot whose weight is 0 is empty
//     and stages zeros without reading anything, and a CTA whose matrix
//     has no live slot returns before it issues a single load, so only the
//     experts a step selected are read.
//   * Epilogues (Ffn::epi): h = bf16(silu(g) * u); a bf16 or f32 result;
//     or the f32 partial of one split of K (grid z), which its consumer
//     sums in split order.  Every sum has a fixed order and nothing uses
//     atomics, so results are bitwise equal from run to run.
#pragma once
#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kM = 128;         // weight columns per CTA: 8 warps x m16
constexpr int kMW = kM / 16;
constexpr int kMChunks = kM / 8;
constexpr int kK = 64;          // reduction positions per stage
constexpr int kKChunks = kK / 8;
constexpr int kMaxCols = 2;     // warp columns sharing a staged weight tile
constexpr int kMaxThreads = 32 * kMW * kMaxCols;

// n8 blocks of rows a warp holds: 8 for NA = 2 (two accumulators a block,
// in the 128 registers a thread of 512 gets), 16 for NA = 1.
template <int NA>
constexpr int kMaxNB = NA == 2 ? 8 : 16;
constexpr int kMaxRows = kMaxCols * kMaxNB<1> * 8;   // rows of one pass

// What the epilogue writes at out0 (and out1), for row n, column m of
// matrix e: at ((e * N + n) * M + m), or for a split z of K at
// (((z * E + e) * N + n) * M + m).
enum Epi : int {
  kEpiH = 0,     // NA = 2: bf16(silu(B @ A_0) * (B @ A_1))
  kEpiT = 1,     // NA = 1: bf16
  kEpiF32 = 2,   // NA = 1: f32
  kEpiPart = 3,  // f32 partial of split z: A_0's at out0, A_1's at out1
};

struct Ffn {
  const bf16* a0;     // (E, K, M) weights, M contiguous
  const bf16* a1;     // a second bank on the same rows (NA = 2)
  const bf16* b;      // activation rows, K contiguous: row r at b + r K
  const int* rows;    // (E, N) row of b for each slot; null: row e N + n
  const float* wgt;   // (E, N) slot weights, 0 = empty; null: all live
  void* out0;
  void* out1;
  int E, N, M, K;
  int kc;             // K range of one split (a multiple of kK), or >= K
  int epi;            // Epi
  int vec;            // rows of a0 / a1 / b 16-byte aligned, M, K % 8 == 0
};

// Ring depth by rows a pass.
inline int stages_for(int rows) { return rows <= 16 ? 3 : 2; }

// A stage: NA weight tiles (kK rows of kM) and `rows` rows of kK.
template <int NA>
size_t smem_bytes(int rows) {
  return (size_t)stages_for(rows) * (NA * kK * kM + rows * kK) *
         sizeof(bf16);
}

// Warp columns and n8 blocks per warp for N rows: the fewest warp columns
// that hold all N rows, then the fewest blocks per warp.
template <int NA>
void plan(int N, int* cols, int* nb) {
  const int blocks = std::max(1, (N + 7) / 8);
  *cols = std::min(kMaxCols, (blocks + kMaxNB<NA> - 1) / kMaxNB<NA>);
  *nb = std::min(kMaxNB<NA>, (blocks + *cols - 1) / *cols);
}

// The most shared memory a product over N rows asks for.
inline size_t smem_for(int N) {
  int c2, nb2, c1, nb1;
  plan<2>(N, &c2, &nb2);
  plan<1>(N, &c1, &nb1);
  return std::max(smem_bytes<2>(c2 * nb2 * 8), smem_bytes<1>(c1 * nb1 * 8));
}

// K range of one split so that `tiles` CTAs a split reach `target` CTAs:
// whole stages, at least one.
inline int split_kc(int K, long long tiles, int target) {
  const long long want = std::max(1LL, (target + tiles - 1) / tiles);
  return std::max<int>(kK, (int)((K + want - 1) / want) / kK * kK);
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

// Stage columns [c0, c0 + kK) of the pass's `nrows` activation rows into a
// swizzled tile; row_s[r] is the row of b for row r, -1 for an empty slot
// (zeros, nothing read).
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* b,
                                           const int* row_s, int K,
                                           int nrows, int c0, int clim,
                                           bool vec) {
  for (int i = threadIdx.x; i < nrows * kKChunks; i += blockDim.x) {
    const int r = i / kKChunks, j = i % kKChunks;
    const int gc = c0 + j * 8;
    const int row = row_s[r];
    bf16* d = dst + swz(r, j, kKChunks);
    const bf16* s = b + (long long)row * K + gc;
    if (row >= 0 && gc + 8 <= clim && vec) {
      cp_async16(d, s);
    } else if (row >= 0 && gc < clim) {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = gc + e < clim ? s[e] : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    } else {
      cp_async16(d, b, 0);
    }
  }
}

// 32 kMW threads per warp column, each warp column holding NB n8 blocks.
template <int NA, int NB>
__global__ void __launch_bounds__(kMaxThreads) ffn_mma_kernel(const Ffn p,
                                                              int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int row_s[kMaxRows];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.y;
  if (p.wgt != nullptr) {   // no live slot: the weights stay unread
    bool live = false;
    for (int n = threadIdx.x; n < p.N; n += blockDim.x) {
      live |= p.wgt[(long long)e * p.N + n] != 0.f;
    }
    if (!__syncthreads_or(live)) return;
  }
  const int rows = (blockDim.x / (32 * kMW)) * NB * 8;   // rows a pass
  const int a_elems = kK * kM;
  const int stage_elems = NA * a_elems + rows * kK;
  const int m0 = blockIdx.x * kM;
  const int split = blockIdx.z;
  const int k_lo = split * p.kc;
  const int k_hi = min(p.K, k_lo + p.kc);
  const int nk = (k_hi - k_lo + kK - 1) / kK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % kMW, wn = warp / kMW;
  const bool vec = p.vec != 0;
  const bf16* a_src[2] = {p.a0 + (long long)e * p.K * p.M,
                          (NA == 2 ? p.a1 : p.a0) + (long long)e * p.K * p.M};

  auto load = [&](int buf, int kt) {
    bf16* st = sm + buf * stage_elems;
    const int k = k_lo + kt * kK;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      stage_tile<kMChunks>(st + a * a_elems, a_src[a], p.M, kK, k, k_hi, m0,
                           p.M, vec);
    }
    stage_rows(st + NA * a_elems, p.b, row_s, p.K, rows, k, k_hi, vec);
  };

  for (int n0 = 0; n0 < p.N; n0 += rows) {
    float acc[NA][NB][4];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][j][c] = 0.f;
    __syncthreads();              // every warp is done with the last pass
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int n = n0 + r;
      const long long slot = (long long)e * p.N + n;
      int row = -1;
      if (n < p.N && (p.wgt == nullptr || p.wgt[slot] != 0.f)) {
        row = p.rows != nullptr ? p.rows[slot] : (int)slot;
      }
      row_s[r] = row;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < stages - 1; ++s) {
      if (s < nk) load(s, s);
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
      if (next < nk) load(next % stages, next);
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

    // c[i]: weight column m0 + wm * 16 + g (+8 for i >= 2), row
    // n0 + (wn * NB + j) * 8 + 2 t (+1 for odd i)
    const int g = lane >> 2, t = lane & 3;
    const long long plane = (long long)split * p.E * p.N * p.M;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + wm * 16 + g + (i >> 1) * 8;
        const int n = n0 + (wn * NB + j) * 8 + 2 * t + (i & 1);
        if (m >= p.M || n >= p.N) continue;
        const long long at = ((long long)e * p.N + n) * p.M + m;
        const float v0 = acc[0][j][i];
        if (p.epi == kEpiH) {
          static_cast<bf16*>(p.out0)[at] = __float2bfloat16(
              v0 / (1.f + expf(-v0)) * acc[NA - 1][j][i]);
        } else if (p.epi == kEpiT) {
          static_cast<bf16*>(p.out0)[at] = __float2bfloat16(v0);
        } else if (p.epi == kEpiF32) {
          static_cast<float*>(p.out0)[at] = v0;
        } else {
          static_cast<float*>(p.out0)[plane + at] = v0;
          if (NA == 2) {
            static_cast<float*>(p.out1)[plane + at] = acc[NA - 1][j][i];
          }
        }
      }
    }
  }
}

template <int NA, int NB>
cudaError_t run(const Ffn& p, int cols, cudaStream_t stream) {
  const int rows = cols * NB * 8;
  const size_t smem = smem_bytes<NA>(rows);
  // always set: the static row table counts toward the default 48 KB
  cudaError_t err = cudaFuncSetAttribute(
      ffn_mma_kernel<NA, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int splits = (p.K + p.kc - 1) / p.kc;
  dim3 grid((p.M + kM - 1) / kM, p.E, std::max(splits, 1));
  ffn_mma_kernel<NA, NB><<<grid, 32 * kMW * cols, smem, stream>>>(
      p, stages_for(rows));
  return cudaGetLastError();
}

// Launch the instantiation with plan<NA>'s n8 blocks per warp.
template <int NA, int NB = 1>
cudaError_t dispatch(const Ffn& p, cudaStream_t stream) {
  int cols, nb;
  plan<NA>(p.N, &cols, &nb);
  if constexpr (NB < kMaxNB<NA>) {
    if (nb > NB) return dispatch<NA, NB + 1>(p, stream);
  }
  return run<NA, NB>(p, cols, stream);
}

// Whether every row of these operands starts 16-byte aligned.
inline bool aligned16(const void* a, const void* b, const void* c, int M,
                      int K) {
  auto al = [](const void* q) {
    return q == nullptr || reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  return M % 8 == 0 && K % 8 == 0 && al(a) && al(b) && al(c);
}

}  // namespace tc
}  // namespace
