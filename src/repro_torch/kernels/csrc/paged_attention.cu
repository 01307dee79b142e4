// Paged GQA decode attention for Hopper (sm_90a): the standalone op's C
// entry points.  The kernels, what they replace and their design are in
// paged_attention.cuh, which decode_megastep.cu shares.
#include "paged_attention.cuh"

extern "C" {

// Bytes of f32 scratch one call needs for its split partials (0 when a row
// fits one split; the wrapper allocates it).
long long paged_attention_scratch_bytes(int B, int H, int Dh, int bs,
                                        int max_blk) {
  return (long long)paged::scratch_bytes(B, H, Dh, bs, max_blk);
}

// q (B, H, Dh); k_pool / v_pool (nb, bs, Hkv, Dh); tables (B, max_blk) i32;
// seq_lens (B,) i32; start_lens (B,) i32 or null; out (B, H, Dh); scratch:
// paged_attention_scratch_bytes, or null where that is 0.
// dtype: 0 = f32, 1 = bf16 (q, pools and out share it).
// Returns the first launch's cudaError_t (0 = launched).
int paged_attention(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* seq_lens,
                    const void* start_lens, void* out, void* scratch, int B,
                    int H, int Hkv, int Dh, int bs, int max_blk, int dtype,
                    void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* sl = static_cast<const int*>(seq_lens);
  const int* st = static_cast<const int*>(start_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1
          ? paged::launch<__nv_bfloat16>(q, k_pool, v_pool, tb, sl, st, out,
                                         scratch, B, H, Hkv, Dh, bs, max_blk,
                                         s)
          : paged::launch<float>(q, k_pool, v_pool, tb, sl, st, out, scratch,
                                 B, H, Hkv, Dh, bs, max_blk, s);
  return (int)err;
}

}  // extern "C"
