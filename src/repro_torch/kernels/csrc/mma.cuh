// Tensor-core and asynchronous-copy building blocks for the bf16 kernels
// (sm_90a): 16-byte cp.async into shared memory, ldmatrix, and the
// mma.sync.m16n8k16 bf16 product with f32 accumulation.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"): lane l
// of a warp is in group g = l / 4 and holds column pair 2 * (l % 4).
//   A (16 x 16, row-major): a[0] rows 0-7 / k 0-7, a[1] rows 8-15 / k 0-7,
//     a[2] rows 0-7 / k 8-15, a[3] rows 8-15 / k 8-15;
//   B (16 x 8, "col": stored n-major, k contiguous): b[0] k 0-7, b[1] k 8-15;
//   C (16 x 8, f32): c[0], c[1] row g, cols 2(l%4) + {0,1}; c[2], c[3] row
//     g + 8, same cols.
// Shared tiles are rows of 16-byte chunks, stored with the chunk index
// XOR-ed by the row's low three bits, so the eight row addresses of one
// ldmatrix phase fall in eight different bank groups.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
// whose rows hold `chunks` chunks (a multiple of 8) of bf16.
__device__ __forceinline__ int swz(int row, int chunk, int chunks) {
  return (row * chunks + (chunk ^ (row & 7))) * 8;
}

// 16 bytes global -> shared, bypassing L1; `bytes` < 16 zero-fills the
// rest (0: the whole chunk is zeros and nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a @ b on the tensor cores: bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 and packed (lo in the low half), as one
// register of an A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
