// One attention+MoE block's decode step for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_megakernel.py
// (decode_megastep_pallas / _megastep_kernel) and computes what it computes
// (repro.kernels.ref.decode_megastep_ref up to where each rounds to the
// activation type T): paged attention -> o @ w_post + x -> RMS norm ->
// router logits -> masked softmax and top-k -> replica select from l2p /
// replica_count / expert_mask -> per-expert slot tables -> shared SwiGLU ->
// routed SwiGLU -> weighted combine.  Returns y and h2, each (B, D) in T.
//
// Bound: bytes.  One step reads w_post, the router, the shared experts, the
// experts that received a live copy (3 * D * F each) and the valid K/V rows;
// at decode batch sizes that is ~cap flops per weight byte, far below the
// ridge point.
//
// Design.  The Pallas kernel runs five phases on one sequential grid and
// passes data between them through VMEM scratch — race-free only because
// the TPU runs the grid in order.  Hopper runs blocks in no order, so the
// phases become a fixed chain of this file's kernels, enqueued back to back
// on the caller's stream by one C call (no host synchronisation, no
// PyTorch operation in between), each reading what the previous one wrote
// to a device workspace:
//   1. attention (paged_attention.cuh): one CTA per (split of kSplitLen
//      positions, row, KV head), then the ordered merge of a row's splits
//      -> o in T, the split partials in the workspace;
//   2. o @ w_post, f32 partial sums over splits of K;
//   3. norm: one CTA per row: y = T(x + T(proj)), the proj partials summed
//      in split order, the sum of squares in a fixed tree,
//      h2 = T(T(y * rsqrt) * ln2);
//   4. gemm: the router logits h2 @ router, f32 partial sums;
//   5. route_slots: one CTA; each warp takes rows, sums a row's logit
//      partials in split order and runs router_topk.cuh's row function ->
//      (sel, w); then each copy's local expert (replica b + j mod count),
//      and thread e scans the copies in b-major, k-minor order and fills
//      expert e's first cap slots, so drop semantics equal
//      moe_group_tokens; it also writes the inverse map slot_of;
//   6. routed gate/up over the gathered h2 rows of each expert's slots; a
//      CTA whose expert has no live slot returns before it reads a weight,
//      so only experts with a live copy are read;
//   7. the shared experts' gate and up over every row;
//   8. routed down, and 9. shared down, over h = T(silu(g) * u);
//   10. combine: a thread per (row, column), y = T(x2 + shared + sum of
//      the row's k copies in k order).
// The shared experts (7, 9) read only h2, so they run on a second stream
// beside 4-6 and 8: forked from the caller's stream by an event after 3
// and joined back by one before 10, so the call is still one ordered unit
// on the caller's stream, and no two kernels write the same memory.
// bf16 (the serving path): the products 2 and 6-9 are the tensor-core tile
// loop of ffn_mma.cuh.  Routed gate/up takes the whole of D per CTA, so h
// comes out in T directly into an (E, cap, F) scratch; routed down writes
// one f32 plane of per-slot outputs.  The shared experts (Fs = 5632 over
// 128-column tiles: 44 of them) and o @ w_post (16 tiles) would leave most
// of the 132 SMs idle, so their K is split into ordered f32 partials until
// a grid holds ~kTcTargetCtas CTAs; the consumers (norm, swiglu for the
// shared h, combine) sum the splits in split order.  The router product
// (N = 60, 0.25 MB) stays on the FMA gemm.
// f32 keeps the FMA gemm for every product (the tensor cores would multiply
// f32 as TF32): a CTA owns 8 rows x 128 columns (4 per lane, one 8- or
// 16-byte load per weight row), its 8 warps split its K range, and K is
// also split across CTAs into f32 partials that the consumer sums in split
// order: enough splits for two waves where the grid is small, and at most
// kMaxKc of K per CTA, so that the routed experts' CTAs (how many is known
// only on the device) end in a short last wave; routed and shared down form
// SwiGLU from the gate/up partials while they stage their A tile.
// Nothing uses float atomics and every sum has a fixed order, so outputs
// are bitwise equal from run to run.  Routing state, paging arrays and
// expert_offset are device data: recovery edits change tensors, never the
// launch.
#include <algorithm>

#include <type_traits>

#include "ffn_mma.cuh"
#include "paged_attention.cuh"
#include "router_topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 8;              // rows per gemm CTA
constexpr int kVec = 4;            // columns per lane
constexpr int kTN = 32 * kVec;     // columns per gemm CTA
constexpr int kMaxKc = 512;        // most of K one gemm CTA takes (16 KB)
constexpr int kMinKc = 64;         // least of K one gemm CTA takes
constexpr int kTargetCtas = 264;   // two CTAs for each of the 132 SMs
constexpr int kTcTargetCtas = 132; // a tensor-core product: one per SM

__host__ __device__ inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// ---------------------------------------------------------------- gemm ----

struct Gemm {
  const void* a;       // rows mode: (rows, K) in T
  const int* a_rows;   // (n_mat * M) row of `a` per slot; null: row c
  const float* g;      // SwiGLU mode: (a_splits, n_mat * M, K) f32 partials
  const float* u;
  int a_splits;
  const float* live;   // (n_mat * M) slot weights, 0 = empty; null: all live
  const void* w0;      // (n_mat, K, N) in T
  const void* w1;      // a second matrix sharing the A tile, or null
  float* out0;         // (S, n_mat * M, N) f32 partial sums over K splits
  float* out1;
  int M, K, N, n_mat, S, kc, vec;
};

__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          int n0, int N, bool vec,
                                          float* o) {
  if (vec && n0 + kVec <= N) {
    const float4 v = *reinterpret_cast<const float4*>(row + n0);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) o[i] = n0 + i < N ? row[n0 + i] : 0.f;
  }
}

__device__ __forceinline__ void load_cols(
    const __nv_bfloat16* __restrict__ row, int n0, int N, bool vec,
    float* o) {
  if (vec && n0 + kVec <= N) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + n0);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    o[0] = lo.x, o[1] = lo.y, o[2] = hi.x, o[3] = hi.y;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      o[i] = n0 + i < N ? to_float(row[n0 + i]) : 0.f;
  }
}

// Sum the 8 warps' partials of one matrix in warp order; store the tile.
__device__ __forceinline__ void reduce_store(const float (&acc)[kR][kVec],
                                             float* red, float* out,
                                             const Gemm& p, int split,
                                             long long m0, int c0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      red[(warp * kR + r) * kTN + lane * kVec + v] = acc[r][v];
  __syncthreads();
  for (int i = tid; i < kR * kTN; i += kThreads) {
    const int r = i / kTN;
    const int col = i - r * kTN;
    const int n = blockIdx.x * kTN + col;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(w * kR + r) * kTN + col];
    if (c0 + r < p.M && n < p.N)
      out[((long long)split * p.n_mat * p.M + m0 + r) * p.N + n] = s;
  }
  __syncthreads();
}

// out[split][mat * M + c][n] = sum over k in the split of A[c][k] * W[mat][k][n]
// for the CTA's 8 slots c and 128 columns n.  grid: (N tiles, M tiles,
// n_mat * S).
template <typename T, bool kSwiGLU, bool kTwo>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const Gemm p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool live_s[kR];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mat = blockIdx.z / p.S;
  const int split = blockIdx.z - mat * p.S;
  const int c0 = blockIdx.y * kR;
  const long long m0 = (long long)mat * p.M + c0;
  if (tid < kR) {
    const int c = c0 + tid;
    live_s[tid] =
        c < p.M && (p.live == nullptr || p.live[m0 + tid] != 0.f);
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int r = 0; r < kR; ++r) any |= live_s[r];
  if (!any) return;   // no live slot: the expert's weights stay unread

  // stage the A tile (8 rows of this split's K range) as f32
  const int k0 = split * p.kc;
  const int kn = min(p.kc, p.K - k0);
  float* a_s = smem;
  for (int i = tid; i < kR * kn; i += kThreads) {
    const int r = i / kn;
    const int kk = i - r * kn;
    float v = 0.f;
    if (live_s[r]) {
      if constexpr (kSwiGLU) {
        const long long plane = (long long)p.n_mat * p.M * p.K;
        const long long at = (m0 + r) * p.K + k0 + kk;
        float g = 0.f, u = 0.f;
        for (int t = 0; t < p.a_splits; ++t) {
          g += p.g[t * plane + at];
          u += p.u[t * plane + at];
        }
        v = round_to<T>(g / (1.f + expf(-g)) * u);
      } else {
        const long long row =
            p.a_rows != nullptr ? p.a_rows[m0 + r] : (long long)(c0 + r);
        v = to_float(static_cast<const T*>(p.a)[row * p.K + k0 + kk]);
      }
    }
    a_s[i] = v;
  }
  __syncthreads();

  const int n0 = blockIdx.x * kTN + lane * kVec;
  const long long w_off = ((long long)mat * p.K + k0) * p.N;
  const T* __restrict__ w0 = static_cast<const T*>(p.w0) + w_off;
  const T* __restrict__ w1 =
      kTwo ? static_cast<const T*>(p.w1) + w_off : nullptr;
  const bool vec = p.vec != 0;
  float acc0[kR][kVec], acc1[kR][kVec];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc0[r][v] = acc1[r][v] = 0.f;

#pragma unroll 4
  for (int kk = warp; kk < kn; kk += kWarps) {
    float b0[kVec], b1[kVec];
    load_cols(w0 + (long long)kk * p.N, n0, p.N, vec, b0);
    if constexpr (kTwo) load_cols(w1 + (long long)kk * p.N, n0, p.N, vec, b1);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float a = a_s[r * kn + kk];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        acc0[r][v] = fmaf(a, b0[v], acc0[r][v]);
        if constexpr (kTwo) acc1[r][v] = fmaf(a, b1[v], acc1[r][v]);
      }
    }
  }
  __syncthreads();   // the A tile's memory now holds the warp partials
  reduce_store(acc0, smem, p.out0, p, split, m0, c0);
  if constexpr (kTwo) reduce_store(acc1, smem, p.out1, p, split, m0, c0);
}

struct Split {
  int S, kc;
};

// K splits across CTAs: enough CTAs for two waves, at least kMinKc of K
// each, at most kMaxKc staged; every split non-empty.
Split split_k(int K, long long tiles) {
  int s = cdiv(kTargetCtas, tiles);
  s = std::min(s, std::max(1, K / kMinKc));
  s = std::max(s, cdiv(K, kMaxKc));
  s = std::max(s, 1);
  const int kc = cdiv(K, s);
  return {cdiv(K, kc), kc};
}

size_t gemm_smem(int kc) {
  return sizeof(float) *
         std::max((size_t)kR * kc, (size_t)kWarps * kR * kTN);
}

template <typename T, bool kSwiGLU, bool kTwo>
cudaError_t gemm(Gemm p, Split sp, cudaStream_t st) {
  p.S = sp.S;
  p.kc = sp.kc;
  p.vec = p.N % kVec == 0 && reinterpret_cast<uintptr_t>(p.w0) % 16 == 0 &&
          (p.w1 == nullptr || reinterpret_cast<uintptr_t>(p.w1) % 16 == 0);
  const size_t smem = gemm_smem(sp.kc);
  cudaError_t err = allow_smem(gemm_kernel<T, kSwiGLU, kTwo>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(p.N, kTN), cdiv(p.M, kR), p.n_mat * p.S);
  gemm_kernel<T, kSwiGLU, kTwo><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- norm ----

size_t norm_smem(int D) { return sizeof(float) * ((size_t)D + kWarps); }

template <typename T>
__global__ void __launch_bounds__(kThreads) norm_kernel(
    const T* __restrict__ x, const float* __restrict__ proj, int proj_splits,
    const T* __restrict__ ln2, T* __restrict__ y, T* __restrict__ h2, int B,
    int D, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* y_s = smem;        // D
  float* part_s = y_s + D;  // kWarps
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long row = (long long)b * D;

  float ssq = 0.f;
  for (int d = tid; d < D; d += kThreads) {
    float pr = 0.f;
    for (int s = 0; s < proj_splits; ++s)
      pr += proj[((long long)s * B + b) * D + d];
    const float yv = round_to<T>(to_float(x[row + d]) + round_to<T>(pr));
    y[row + d] = from_float<T>(yv);
    y_s[d] = yv;
    ssq += yv * yv;
  }
  ssq = route::warp_sum(ssq);
  if (lane == 0) part_s[warp] = ssq;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kWarps; ++w) total += part_s[w];
  const float rs = rsqrtf(total / D + eps);
  for (int d = tid; d < D; d += kThreads)
    h2[row + d] =
        from_float<T>(round_to<T>(y_s[d] * rs) * to_float(ln2[d]));
}

// --------------------------------------------------------------- swiglu ----

// The shared experts' h = T(silu(g) * u) (bf16 chain), g and u summed over
// their K splits in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads) swiglu_kernel(
    const float* __restrict__ g, const float* __restrict__ u, int splits,
    long long n, T* __restrict__ h) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float gs = 0.f, us = 0.f;
  for (int s = 0; s < splits; ++s) {
    gs += g[s * n + i];
    us += u[s * n + i];
  }
  h[i] = from_float<T>(gs / (1.f + expf(-gs)) * us);
}

// ---------------------------------------------------------- route_slots ----

size_t route_slots_smem(int B, int k, int E_log) {
  return sizeof(float) * 2 * kWarps * (size_t)E_log +
         sizeof(int) * (size_t)B * k;
}

__global__ void __launch_bounds__(kThreads) route_slots_kernel(
    const float* __restrict__ logit_parts, int splits,
    const uint8_t* __restrict__ mask, const int* __restrict__ l2p,
    const int* __restrict__ rcnt, const int* __restrict__ offset,
    int* __restrict__ sel, float* __restrict__ wsel,
    int* __restrict__ tok_idx, float* __restrict__ wgt,
    int* __restrict__ slot_of, int B, int E_log, int k, int e_local,
    int cap, int max_rep) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* lg_s = smem + 2 * warp * E_log;   // this warp's row of logits
  float* work_s = lg_s + E_log;            // and its top-k scratch
  int* e_of = reinterpret_cast<int*>(smem + 2 * kWarps * E_log);  // B * k
  const int n_copies = B * k;

  // route: a warp per row
  for (int b = warp; b < B; b += kWarps) {
    for (int e = lane; e < E_log; e += 32) {
      float s = 0.f;
      for (int sp = 0; sp < splits; ++sp)
        s += logit_parts[((long long)sp * B + b) * E_log + e];
      lg_s[e] = s;
    }
    __syncwarp();
    route::router_topk_row(lg_s, mask, E_log, k, work_s, wsel + b * k,
                           sel + b * k);
  }
  for (int i = tid; i < e_local * cap; i += kThreads) {
    tok_idx[i] = 0;
    wgt[i] = 0.f;
  }
  __syncthreads();   // the block's sel / wsel writes are now visible

  // replica select: each copy's local expert, or -1
  const int off = *offset;
  for (int n = tid; n < n_copies; n += kThreads) {
    const int b = n / k, j = n - b * k;
    const int s = sel[n];
    const int rc = rcnt[s];
    const int rep = (b + j) % max(rc, 1);
    const int e = l2p[s * max_rep + rep] - off;
    e_of[n] = rc > 0 && e >= 0 && e < e_local ? e : -1;
    slot_of[n] = -1;
  }
  __syncthreads();
  // slot tables: thread e takes expert e's copies in b-major, k-minor order
  for (int e = tid; e < e_local; e += kThreads) {
    int c = 0;
    for (int n = 0; n < n_copies && c < cap; ++n) {
      if (e_of[n] != e) continue;
      tok_idx[e * cap + c] = n / k;
      wgt[e * cap + c] = wsel[n];
      slot_of[n] = e * cap + c;
      ++c;
    }
  }
}

// -------------------------------------------------------------- combine ----

template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ od, int od_splits, long long slots,
    const float* __restrict__ os, int os_splits,
    const float* __restrict__ wgt, const int* __restrict__ slot_of,
    T* __restrict__ y, int B, int k, int D) {
  const int b = blockIdx.x;
  const int d = blockIdx.y * kThreads + threadIdx.x;
  if (d >= D) return;
  const long long at = (long long)b * D + d;
  float acc = to_float(y[at]);   // x2, written by norm
  for (int s = 0; s < os_splits; ++s)
    acc += os[((long long)s * B + b) * D + d];
  for (int j = 0; j < k; ++j) {
    const int slot = slot_of[b * k + j];
    if (slot < 0) continue;
    const float w = wgt[slot];
    if (w == 0.f) continue;
    float o = 0.f;
    for (int s = 0; s < od_splits; ++s)
      o += od[((long long)s * slots + slot) * D + d];
    acc += w * o;
  }
  y[at] = from_float<T>(acc);
}

// ------------------------------------------------------------ the chain ----

struct Dims {
  int B, H, Hkv, Da, bs, max_blk, D, E_log, max_rep, E, F, Fs, cap, k;
};

struct Layout {
  Split proj, rt, gu, sgu, dn, sdn;
  // g / u: the routed gate/up f32 partials (FMA) or h in T (tensor cores,
  // u unused); hs: the shared h in T (tensor cores only)
  size_t o, attn, p1, lg, g, u, gs, us, hs, od, os, total;
};

// A tensor-core product's K splits: whole kK stages, enough that its
// column tiles times its splits reach kTcTargetCtas.
Split tc_split(int K, int M) {
  const int kc = tc::split_kc(K, cdiv(M, tc::kM), kTcTargetCtas);
  return {cdiv(K, kc), kc};
}

Layout layout(const Dims& d, size_t tsize) {
  Layout L{};
  const bool tcore = tsize == sizeof(__nv_bfloat16);
  const long long rt = cdiv(d.B, kR), ct = cdiv(d.cap, kR);
  L.rt = split_k(d.D, cdiv(d.E_log, kTN) * rt);
  if (tcore) {
    L.proj = tc_split(d.H * d.Da, d.D);
    L.gu = {1, d.D};
    L.dn = {1, d.F};
    L.sgu = d.Fs ? tc_split(d.D, d.Fs) : Split{0, 0};
    L.sdn = d.Fs ? tc_split(d.Fs, d.D) : Split{0, 0};
  } else {
    L.proj = split_k(d.H * d.Da, cdiv(d.D, kTN) * rt);
    L.gu = split_k(d.D, cdiv(d.F, kTN) * ct * d.E);
    L.dn = split_k(d.F, cdiv(d.D, kTN) * ct * d.E);
    L.sgu = d.Fs ? split_k(d.D, cdiv(d.Fs, kTN) * rt) : Split{0, 0};
    L.sdn = d.Fs ? split_k(d.Fs, cdiv(d.D, kTN) * rt) : Split{0, 0};
  }
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t at = off;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  const size_t f = sizeof(float);
  const size_t slots = (size_t)d.E * d.cap;
  L.o = take((size_t)d.B * d.H * d.Da * tsize);
  L.attn = take(paged::scratch_bytes(d.B, d.H, d.Da, d.bs, d.max_blk));
  L.p1 = take(L.proj.S * (size_t)d.B * d.D * f);
  L.lg = take(L.rt.S * (size_t)d.B * d.E_log * f);
  if (tcore) {
    L.g = take(slots * d.F * tsize);
  } else {
    L.g = take(L.gu.S * slots * d.F * f);
    L.u = take(L.gu.S * slots * d.F * f);
  }
  L.gs = take(L.sgu.S * (size_t)d.B * d.Fs * f);
  L.us = take(L.sgu.S * (size_t)d.B * d.Fs * f);
  if (tcore) L.hs = take((size_t)d.B * d.Fs * tsize);
  L.od = take(L.dn.S * slots * d.D * f);
  L.os = take(L.sdn.S * (size_t)d.B * d.D * f);
  L.total = off;
  return L;
}

struct Ptrs {
  const void *q, *k_pool, *v_pool, *x, *w_post, *ln2, *router, *gate, *up,
      *down, *sgate, *sup, *sdown;
  const int *tables, *seq_lens, *start_lens, *l2p, *rcnt, *offset;
  const uint8_t* mask;
  void *y, *h2;
  int *sel, *tok_idx, *slot_of;
  float *wsel, *wgt;
  unsigned char* ws;
};

#define CHECK(call)                       \
  do {                                    \
    cudaError_t e_ = (call);              \
    if (e_ != cudaSuccess) return e_;     \
  } while (0)

// The side stream of this device (made on first use, kept for the
// process) and the events that fork it from the caller's stream and join
// it back: the call stays one ordered unit on the caller's stream.
struct Side {
  cudaStream_t stream;
  cudaEvent_t fork, join;
};

cudaError_t side_stream(Side* out) {
  constexpr int kMaxDevices = 64;
  static Side sides[kMaxDevices];
  static bool made[kMaxDevices];
  int dev = 0;
  CHECK(cudaGetDevice(&dev));
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Side& s = sides[dev];
  if (!made[dev]) {
    CHECK(cudaStreamCreateWithFlags(&s.stream, cudaStreamNonBlocking));
    CHECK(cudaEventCreateWithFlags(&s.fork, cudaEventDisableTiming));
    CHECK(cudaEventCreateWithFlags(&s.join, cudaEventDisableTiming));
    made[dev] = true;
  }
  *out = s;
  return cudaSuccess;
}

// One bf16 product on the tensor-core tile loop (ffn_mma.cuh).
template <int NA>
cudaError_t tc_product(const void* a0, const void* a1, const void* b,
                       const int* rows, const float* wgt, void* out0,
                       void* out1, int E, int N, int M, int K, Split sp,
                       int epi, cudaStream_t st) {
  tc::Ffn f{};
  f.a0 = static_cast<const tc::bf16*>(a0);
  f.a1 = static_cast<const tc::bf16*>(a1);
  f.b = static_cast<const tc::bf16*>(b);
  f.rows = rows, f.wgt = wgt, f.out0 = out0, f.out1 = out1;
  f.E = E, f.N = N, f.M = M, f.K = K, f.kc = sp.kc, f.epi = epi;
  f.vec = tc::aligned16(a0, a1, b, M, K);
  return tc::dispatch<NA>(f, st);
}

template <typename T>
cudaError_t chain(const Ptrs& P, const Dims& d, float eps, cudaStream_t st) {
  constexpr bool kTc = std::is_same_v<T, __nv_bfloat16>;
  const Layout L = layout(d, sizeof(T));
  auto at = [&P](size_t off) {
    return reinterpret_cast<float*>(P.ws + off);
  };
  void* o = P.ws + L.o;

  // 1. attention -> o (B, H * Da) in T
  CHECK(paged::launch<T>(P.q, P.k_pool, P.v_pool, P.tables, P.seq_lens,
                         P.start_lens, o, P.ws + L.attn, d.B, d.H, d.Hkv,
                         d.Da, d.bs, d.max_blk, st));
  // 2. o @ w_post
  Gemm g{};
  if constexpr (kTc) {
    CHECK(tc_product<1>(P.w_post, nullptr, o, nullptr, nullptr, at(L.p1),
                        nullptr, 1, d.B, d.D, d.H * d.Da, L.proj,
                        tc::kEpiPart, st));
  } else {
    g.a = o;
    g.w0 = P.w_post;
    g.out0 = at(L.p1);
    g.M = d.B, g.K = d.H * d.Da, g.N = d.D, g.n_mat = 1;
    CHECK((gemm<T, false, false>(g, L.proj, st)));
  }
  // 3. residual and norm
  const size_t smem_n = norm_smem(d.D);
  CHECK(allow_smem(norm_kernel<T>, smem_n));
  norm_kernel<T><<<d.B, kThreads, smem_n, st>>>(
      static_cast<const T*>(P.x), at(L.p1), L.proj.S,
      static_cast<const T*>(P.ln2), static_cast<T*>(P.y),
      static_cast<T*>(P.h2), d.B, d.D, eps);
  CHECK(cudaGetLastError());
  // the shared experts (7, 9) need only h2: they run on a side stream
  // beside 4-6 and 8, forked here and joined before the combine
  cudaStream_t side = st;
  Side sd{};
  if (d.Fs) {
    CHECK(side_stream(&sd));
    side = sd.stream;
    CHECK(cudaEventRecord(sd.fork, st));
    CHECK(cudaStreamWaitEvent(side, sd.fork, 0));
  }
  if constexpr (kTc) {
    void* hs = P.ws + L.hs;   // the shared h (B, Fs) in T
    // 7. shared gate/up over every row, then their h; 9. shared down
    if (d.Fs) {
      CHECK(tc_product<2>(P.sgate, P.sup, P.h2, nullptr, nullptr, at(L.gs),
                          at(L.us), 1, d.B, d.Fs, d.D, L.sgu, tc::kEpiPart,
                          side));
      const long long n = (long long)d.B * d.Fs;
      swiglu_kernel<T><<<cdiv(n, kThreads), kThreads, 0, side>>>(
          at(L.gs), at(L.us), L.sgu.S, n, static_cast<T*>(hs));
      CHECK(cudaGetLastError());
      CHECK(tc_product<1>(P.sdown, nullptr, hs, nullptr, nullptr, at(L.os),
                          nullptr, 1, d.B, d.D, d.Fs, L.sdn, tc::kEpiPart,
                          side));
    }
  } else if (d.Fs) {
    // 7. shared gate/up over every row; 9. shared down over SwiGLU(g, u)
    g = Gemm{};
    g.a = P.h2;
    g.w0 = P.sgate, g.w1 = P.sup;
    g.out0 = at(L.gs), g.out1 = at(L.us);
    g.M = d.B, g.K = d.D, g.N = d.Fs, g.n_mat = 1;
    CHECK((gemm<T, false, true>(g, L.sgu, side)));
    g = Gemm{};
    g.g = at(L.gs), g.u = at(L.us), g.a_splits = L.sgu.S;
    g.w0 = P.sdown;
    g.out0 = at(L.os);
    g.M = d.B, g.K = d.Fs, g.N = d.D, g.n_mat = 1;
    CHECK((gemm<T, true, false>(g, L.sdn, side)));
  }
  if (d.Fs) CHECK(cudaEventRecord(sd.join, side));
  // 4. router logits
  g = Gemm{};
  g.a = P.h2;
  g.w0 = P.router;
  g.out0 = at(L.lg);
  g.M = d.B, g.K = d.D, g.N = d.E_log, g.n_mat = 1;
  CHECK((gemm<T, false, false>(g, L.rt, st)));
  // 5. top-k, replica select and slot tables
  const size_t smem_r = route_slots_smem(d.B, d.k, d.E_log);
  CHECK(allow_smem(route_slots_kernel, smem_r));
  route_slots_kernel<<<1, kThreads, smem_r, st>>>(
      at(L.lg), L.rt.S, P.mask, P.l2p, P.rcnt, P.offset, P.sel, P.wsel,
      P.tok_idx, P.wgt, P.slot_of, d.B, d.E_log, d.k, d.E, d.cap,
      d.max_rep);
  CHECK(cudaGetLastError());
  if constexpr (kTc) {
    void* hr = P.ws + L.g;    // the routed h (E, cap, F) in T
    // 6. routed gate/up over each expert's live slots -> h
    CHECK(tc_product<2>(P.gate, P.up, P.h2, P.tok_idx, P.wgt, hr, nullptr,
                        d.E, d.cap, d.F, d.D, L.gu, tc::kEpiH, st));
    // 8. routed down -> f32 per-slot outputs
    CHECK(tc_product<1>(P.down, nullptr, hr, nullptr, P.wgt, at(L.od),
                        nullptr, d.E, d.cap, d.D, d.F, L.dn, tc::kEpiF32,
                        st));
  } else {
    // 6. routed gate/up over each expert's live slots
    g = Gemm{};
    g.a = P.h2;
    g.a_rows = P.tok_idx;
    g.live = P.wgt;
    g.w0 = P.gate, g.w1 = P.up;
    g.out0 = at(L.g), g.out1 = at(L.u);
    g.M = d.cap, g.K = d.D, g.N = d.F, g.n_mat = d.E;
    CHECK((gemm<T, false, true>(g, L.gu, st)));
    // 8. routed down over SwiGLU(g, u)
    g = Gemm{};
    g.g = at(L.g), g.u = at(L.u), g.a_splits = L.gu.S;
    g.live = P.wgt;
    g.w0 = P.down;
    g.out0 = at(L.od);
    g.M = d.cap, g.K = d.F, g.N = d.D, g.n_mat = d.E;
    CHECK((gemm<T, true, false>(g, L.dn, st)));
  }
  if (d.Fs) CHECK(cudaStreamWaitEvent(st, sd.join, 0));
  // 10. combine into y
  combine_kernel<T><<<dim3(d.B, cdiv(d.D, kThreads)), kThreads, 0, st>>>(
      at(L.od), L.dn.S, (long long)d.E * d.cap, d.Fs ? at(L.os) : nullptr,
      d.Fs ? L.sdn.S : 0, P.wgt, P.slot_of, static_cast<T*>(P.y), d.B, d.k,
      d.D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Device workspace one call needs (the wrapper allocates it).
long long decode_megastep_workspace_bytes(int B, int H, int Hkv, int Da,
                                          int bs, int max_blk, int D,
                                          int E_log, int E, int F, int Fs,
                                          int cap, int dtype) {
  Dims d{};
  d.B = B, d.H = H, d.Hkv = Hkv, d.Da = Da, d.bs = bs, d.max_blk = max_blk;
  d.D = D, d.E_log = E_log, d.E = E, d.F = F, d.Fs = Fs, d.cap = cap;
  return (long long)layout(d, dtype == 1 ? 2 : 4).total;
}

// The most shared memory any kernel of the chain asks for (the wrapper
// checks it against the card).
long long decode_megastep_smem_bytes(int B, int D, int E_log, int k,
                                     int cap) {
  const size_t sizes[] = {norm_smem(D), route_slots_smem(B, k, E_log),
                          gemm_smem(kMaxKc), tc::smem_for(B),
                          tc::smem_for(cap)};
  return (long long)*std::max_element(sizes, sizes + 5);
}

// Shapes: q (B, H, Da); k_pool / v_pool (nb, bs, Hkv, Da); tables
// (B, max_blk), seq_lens / start_lens (B,) i32; x (B, D); w_post (H*Da, D);
// ln2 (D,); router (D, E_log); l2p (E_log, max_rep), rcnt (E_log,) i32;
// mask (E_log,) bool bytes; gate / up (E, D, F); down (E, F, D); offset (1,)
// i32; sgate / sup (D, Fs), sdown (Fs, D) or null with Fs = 0.  Outputs y,
// h2 (B, D); the route (sel (B, k) i32, wsel (B, k) f32) and slot tables
// (tok_idx (E, cap) i32, wgt (E, cap) f32, slot_of (B, k) i32) are kept for
// inspection.  ws: decode_megastep_workspace_bytes.  dtype 0 = f32,
// 1 = bf16 for every floating input and output.  Returns the first
// cudaError_t of the chain (0 = all launched).
int decode_megastep(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* seq_lens,
                    const void* start_lens, const void* x,
                    const void* w_post, const void* ln2, const void* router,
                    const void* l2p, const void* rcnt, const void* mask,
                    const void* gate, const void* up, const void* down,
                    const void* offset, const void* sgate, const void* sup,
                    const void* sdown, void* y, void* h2, void* sel,
                    void* wsel, void* tok_idx, void* wgt, void* slot_of,
                    void* ws, int B, int H, int Hkv, int Da, int bs,
                    int max_blk, int D, int E_log, int max_rep, int E, int F,
                    int Fs, int cap, int k, float eps, int dtype,
                    void* stream) {
  Ptrs P{};
  P.q = q, P.k_pool = k_pool, P.v_pool = v_pool, P.x = x, P.w_post = w_post;
  P.ln2 = ln2, P.router = router, P.gate = gate, P.up = up, P.down = down;
  P.sgate = sgate, P.sup = sup, P.sdown = sdown;
  P.tables = static_cast<const int*>(tables);
  P.seq_lens = static_cast<const int*>(seq_lens);
  P.start_lens = static_cast<const int*>(start_lens);
  P.l2p = static_cast<const int*>(l2p);
  P.rcnt = static_cast<const int*>(rcnt);
  P.offset = static_cast<const int*>(offset);
  P.mask = static_cast<const uint8_t*>(mask);
  P.y = y, P.h2 = h2;
  P.sel = static_cast<int*>(sel);
  P.wsel = static_cast<float*>(wsel);
  P.tok_idx = static_cast<int*>(tok_idx);
  P.wgt = static_cast<float*>(wgt);
  P.slot_of = static_cast<int*>(slot_of);
  P.ws = static_cast<unsigned char*>(ws);
  const Dims d{B, H, Hkv, Da, bs, max_blk, D, E_log, max_rep, E, F,
               sgate != nullptr ? Fs : 0, cap, k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? chain<__nv_bfloat16>(P, d, eps, st)
                               : chain<float>(P, d, eps, st);
  return (int)err;
}

}  // extern "C"
