// GQA flash-decode over a paged KV cache: a shared block pool indexed
// through per-slot block tables.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:338
// decode_attention_paged (pallas_call at :378; body
// _paged_decode_attn_kernel :297; wrapper repro/kernels/ops.py:323).  For
// slot b and query head h = kv * G + g:
//   out[b, h] = softmax(q[b, h] . K_b[:len, kv] / sqrt(dh)) . V_b[:len, kv]
// where logical position t of slot b lives in pool block
// tables[b, t / page] at row t % page, and len = lengths[b] clamped to
// max_blocks x page.  Only logical blocks below ceil(len / page) are read,
// and only their rows below len: the table cells past the length hold the
// trash block 0 and are never touched, nor are the padded rows of a
// prompt's last page.  An idle slot (length 1, table row all trash) reads
// row 0 of block 0, which is inside the pool.  A table cell outside the
// pool reads as zeros instead of faulting.  A length-0 row gives exact
// zeros, as the TPU kernel's masked-tile guard does (decode_attention.py:44).
//
// What bounds it on an H100: bytes.  Each (b, kv) reads len x dh x 2 bf16
// of K and V once, plus ceil(len / page) table cells, for 4 x G flops per
// element pair: far below the card's ~295 flops per byte.
//
// Design.  One block per (b, kv head) with one warp per query head, as in
// the dense kernel (decode_attention.cu), whose tile loop it shares
// (flash_decode.cuh).  The TPU grid walks one page per step; here a
// 64-position tile gathers 64 / page pages at once, each row resolving its
// physical block through the table, so the page size is a runtime argument
// and a small page costs no extra tile passes.

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

struct PagedRow {
  const int* table;  // the slot's row of the block table
  int n_pool, page, Kv, kvh;
  __device__ long long operator()(int t) const {
    const int phys = table[t / page];
    if (phys < 0 || phys >= n_pool) return -1;
    return (((long long)phys * page + t % page) * Kv + kvh) * DH;
  }
};

__global__ void decode_attention_paged_kernel(
    const __nv_bfloat16* __restrict__ q,   // (B, H, DH)
    const __nv_bfloat16* __restrict__ pk,  // (n_pool, page, Kv, DH)
    const __nv_bfloat16* __restrict__ pv,  // (n_pool, page, Kv, DH)
    const int* __restrict__ tables,        // (B, max_blocks)
    const int* __restrict__ lengths,       // (B,)
    __nv_bfloat16* __restrict__ out,       // (B, H, DH)
    int n_pool, int page, int Kv, int G, int max_blocks, float scale) {
  __shared__ Smem sm;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int len = max(0, min(lengths[b], max_blocks * page));
  const size_t head0 = (size_t)b * Kv * G + kvh * G;
  load_q(sm, q + head0 * DH);
  State st;
  const PagedRow row{tables + (size_t)b * max_blocks, n_pool, page, Kv, kvh};
  attend(st, sm, pk, pv, row, 0, len, scale);
  store_bf16(out + (head0 + warp) * DH, normalised(st));
}

}  // namespace

// Launches on `stream`; allocates nothing; returns cudaGetLastError().
// Caller guarantees: bf16 contiguous q (B, H, dh) and pools (n_pool, page,
// Kv, dh) with dh == 128, H == Kv * G with G <= 16, int32 contiguous
// tables (B, max_blocks) and lengths (B,).
extern "C" int decode_attention_paged(const void* q, const void* pool_k, const void* pool_v,
                                      const int* tables, const int* lengths, void* out, int B,
                                      int n_pool, int page, int Kv, int G, int dh,
                                      int max_blocks, float scale, void* stream) {
  if (dh != DH || G < 1 || G > GMAX || page < 1 || max_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Kv == 0) return (int)cudaGetLastError();
  decode_attention_paged_kernel<<<dim3(B, Kv), 32 * G, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), tables, lengths,
      static_cast<__nv_bfloat16*>(out), n_pool, page, Kv, G, max_blocks, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
