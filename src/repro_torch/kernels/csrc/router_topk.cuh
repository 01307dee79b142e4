// Fused router top-k for one row, computed by one warp: shared by
// router_topk.cu (the standalone op) and decode_megastep.cu (its route
// stage).
//
// Replaces the TPU kernel src/repro/kernels/router_topk.py
// (router_topk_pallas / _router_topk_kernel) and computes what it computes:
// mask -> softmax -> k argmax passes -> renormalise.
//   * A masked logit becomes -1e30 (not -inf) and its probability 0, and
//     the denominator is at least 1e-30, so a fully masked row gives
//     weights 0 and indices 0..k-1 instead of NaN.
//   * Each pass takes the largest remaining probability; among equal
//     values the lowest expert index wins (the Pallas kernel's min over
//     the columns that reach the max, and jax.lax.top_k's order); the
//     winner is knocked out with -1e30.
//   * The k weights are divided by max(their sum, 1e-9).
//
// Bound: reading the (T, E) logits once; ~10 operations per logit per pass.
//
// Design.  The TPU kernel holds a (Tb, E) tile in VMEM and reduces across
// the 128 lanes.  Here one warp owns a row: lanes stride over E, and every
// reduction (max, sum, the (value, index) argmax) is a butterfly shuffle
// over the warp in a fixed pattern, so results are bitwise equal from run
// to run and need no shared memory beyond the row's E floats of scratch.
#pragma once
#include "common.cuh"

namespace route {

constexpr float kMasked = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Called by all 32 lanes of one warp.  logits: the row's E f32 logits;
// mask: E bytes, nonzero = routable; work: E floats of scratch private to
// this warp (may not alias logits); w_out / idx_out: the row's k outputs.
__device__ void router_topk_row(const float* __restrict__ logits,
                                const uint8_t* __restrict__ mask, int E,
                                int k, float* __restrict__ work,
                                float* __restrict__ w_out,
                                int* __restrict__ idx_out) {
  const int lane = threadIdx.x & 31;
  float mx = kMasked;
  for (int e = lane; e < E; e += 32) {
    const float v = mask[e] ? logits[e] : kMasked;
    work[e] = v;
    mx = fmaxf(mx, v);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int e = lane; e < E; e += 32) {
    const float ex = mask[e] ? expf(work[e] - mx) : 0.f;
    work[e] = ex;
    sum += ex;
  }
  const float denom = fmaxf(warp_sum(sum), 1e-30f);
  for (int e = lane; e < E; e += 32) work[e] = work[e] / denom;
  __syncwarp();

  float wsum = 0.f;
  for (int j = 0; j < k; ++j) {
    float best = -INFINITY;
    int arg = E;
    for (int e = lane; e < E; e += 32) {   // ascending e: first max kept
      const float v = work[e];
      if (v > best) {
        best = v;
        arg = e;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, arg, o);
      if (ov > best || (ov == best && oi < arg)) {
        best = ov;
        arg = oi;
      }
    }
    if (lane == 0) {
      w_out[j] = best;
      idx_out[j] = arg;
    }
    wsum += best;
    if ((arg & 31) == lane) work[arg] = kMasked;
    __syncwarp();
  }
  const float inv = fmaxf(wsum, 1e-9f);
  if (lane == 0) {
    for (int j = 0; j < k; ++j) w_out[j] = w_out[j] / inv;
  }
  __syncwarp();
}

}  // namespace route
