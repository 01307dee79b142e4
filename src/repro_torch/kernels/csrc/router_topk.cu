// Router top-k for Hopper (sm_90a): the standalone op.  What it replaces
// and how a row is computed are in router_topk.cuh, which the megastep's
// route stage shares.  Here each warp of a 4-warp CTA owns one row.
#include "router_topk.cuh"

namespace {

constexpr int kWarpsPerCta = 4;

__global__ void __launch_bounds__(kWarpsPerCta * 32) router_topk_kernel(
    const float* __restrict__ logits, const uint8_t* __restrict__ mask,
    float* __restrict__ w, int* __restrict__ idx, int T, int E, int k) {
  extern __shared__ float work_s[];  // kWarpsPerCta * E
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarpsPerCta + warp;
  if (row >= T) return;   // whole warps leave; no block barrier follows
  route::router_topk_row(logits + row * E, mask, E, k, work_s + warp * E,
                         w + row * k, idx + row * k);
}

}  // namespace

extern "C" {

long long router_topk_smem_bytes(int E) {
  return (long long)kWarpsPerCta * E * sizeof(float);
}

// logits (T, E) f32; mask (E,) bool bytes; w (T, k) f32; idx (T, k) i32.
// Returns the launch's cudaError_t (0 = launched).
int router_topk(const void* logits, const void* mask, void* w, void* idx,
                int T, int E, int k, void* stream) {
  const size_t smem = (size_t)router_topk_smem_bytes(E);
  cudaError_t err = allow_smem(router_topk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (T + kWarpsPerCta - 1) / kWarpsPerCta;
  router_topk_kernel<<<grid, kWarpsPerCta * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const uint8_t*>(mask),
      static_cast<float*>(w), static_cast<int*>(idx), T, E, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
