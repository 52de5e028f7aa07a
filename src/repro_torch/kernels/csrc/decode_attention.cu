// GQA flash-decode over a dense per-slot KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:193
// decode_attention, its n_splits=1 branch (pallas_call at :233; wrapper
// repro/kernels/ops.py:299).  For each sequence b and query head
// h = kv * G + g:
//   out[b, h] = softmax(q[b, h] . K[b, :len, kv] / sqrt(dh)) . V[b, :len, kv]
// with len = lengths[b] (clamped to T), computed by online softmax in
// float32.  A length-0 row gives exact zeros, as the TPU kernel's
// masked-tile guard does (decode_attention.py:44).
//
// What bounds it on an H100: bytes.  Each (b, kv) reads len x dh x 2 bf16
// of K and V once for 4 x G flops per element pair; the work is far below
// the card's ~295 flops per byte.
//
// Design.  One block per (b, kv head) with one warp per query head of the
// group, so the G heads share each K/V tile staged in shared memory.  The
// TPU grid walks T tiles in order and skips tiles past the length; here
// the block loops over 64-position tiles up to the length only, and loads
// only positions below it (the ragged tail is never read, masked scores
// get p = 0).  The tile loop (flash_decode.cuh) is shared with the
// split-KV and paged kernels.

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

__global__ void decode_attention_kernel(const __nv_bfloat16* __restrict__ q,   // (B, H, DH)
                                        const __nv_bfloat16* __restrict__ ck,  // (B, T, Kv, DH)
                                        const __nv_bfloat16* __restrict__ cv,  // (B, T, Kv, DH)
                                        const int* __restrict__ lengths,       // (B,)
                                        __nv_bfloat16* __restrict__ out,       // (B, H, DH)
                                        int T, int Kv, int G, float scale) {
  __shared__ Smem sm;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int len = max(0, min(lengths[b], T));
  const size_t head0 = (size_t)b * Kv * G + kvh * G;
  load_q(sm, q + head0 * DH);
  State st;
  attend(st, sm, ck, cv, DenseRow{b, T, Kv, kvh}, 0, len, scale);
  store_bf16(out + (head0 + warp) * DH, normalised(st));
}

}  // namespace

// Launches on `stream`; allocates nothing; returns cudaGetLastError().
// Caller guarantees: bf16 contiguous q (B, H, dh), caches (B, T, Kv, dh)
// with dh == 128, H == Kv * G with G <= 16, int32 lengths.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, void* out, int B, int T,
                                int Kv, int G, int dh, float scale, void* stream) {
  if (dh != DH || G < 1 || G > GMAX) return (int)cudaErrorInvalidValue;
  if (B == 0 || Kv == 0) return (int)cudaGetLastError();
  decode_attention_kernel<<<dim3(B, Kv), 32 * G, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, static_cast<__nv_bfloat16*>(out),
      T, Kv, G, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
