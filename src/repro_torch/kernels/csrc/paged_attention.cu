// Paged GQA decode attention for Hopper (sm_90a): the standalone op's C
// entry points.  The kernel, what it replaces and its design are in
// paged_attention.cuh, which decode_megastep.cu shares.
#include "paged_attention.cuh"

extern "C" {

// Shared memory one CTA needs (the wrapper checks it against the card).
long long paged_attention_smem_bytes(int G, int Dh) {
  return (long long)paged::smem_bytes(G, Dh);
}

// q (B, H, Dh); k_pool / v_pool (nb, bs, Hkv, Dh); tables (B, max_blk) i32;
// seq_lens (B,) i32; start_lens (B,) i32 or null; out (B, H, Dh).
// dtype: 0 = f32, 1 = bf16 (q, pools and out share it).
// Returns the launch's cudaError_t (0 = launched).
int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* seq_lens,
                    const void* start_lens, void* out, int B, int H, int Hkv,
                    int Dh, int bs, int max_blk, int dtype, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* sl = static_cast<const int*>(seq_lens);
  const int* st = static_cast<const int*>(start_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1
          ? paged::launch<__nv_bfloat16>(q, k_pool, v_pool, tb, sl, st, out,
                                         B, H, Hkv, Dh, bs, max_blk, s)
          : paged::launch<float>(q, k_pool, v_pool, tb, sl, st, out, B, H,
                                 Hkv, Dh, bs, max_blk, s);
  return (int)err;
}

}  // extern "C"
