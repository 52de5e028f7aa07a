// Split-KV GQA flash-decode over a dense per-slot KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:193
// decode_attention, its n_splits>1 branch (pallas_call at :274; body
// _decode_attn_split_kernel :132; combine _combine_splits :178; wrapper
// repro/kernels/ops.py:299).  The KV axis is cut into S contiguous ranges
// of `span` positions (whole 64-position tiles, the last range ragged or
// empty).  Pass 1, one block per (b, kv head, split): the normalised
// float32 partial o_s = softmax_s(q . K_s / sqrt(dh)) . V_s over the
// split's positions below the length, and its log-sum-exp lse_s = m + log l
// (NEG_INF for a split with no live position, whose partial is zero).
// Pass 2, one block per (b, query head): o = sum_s o_s w_s / sum_s w_s with
// w_s = exp(lse_s - max lse), w_s = 0 for an empty split, summed in split
// order (deterministic, no atomics), cast to bf16.  A length-0 row gives
// exact zeros, as the TPU combine does.
//
// What bounds it on an H100: bytes, as for the dense kernel: each (b, kv)
// reads len x dh x 2 bf16 of K and V once for 4 x G flops per element
// pair; the partials add B x H x S x (dh + 1) float32 written and read.
//
// Design.  The dense kernel runs one block per (b, kv head): 32 blocks at
// batch 8 and 4 kv heads, on 132 SMs, each walking the whole length.  The
// split grid multiplies the blocks by S, so each walks 1/S of the length.
// The tile loop is the dense kernel's (flash_decode.cuh).

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

__global__ void split_partial_kernel(const __nv_bfloat16* __restrict__ q,   // (B, H, DH)
                                     const __nv_bfloat16* __restrict__ ck,  // (B, T, Kv, DH)
                                     const __nv_bfloat16* __restrict__ cv,  // (B, T, Kv, DH)
                                     const int* __restrict__ lengths,       // (B,)
                                     float* __restrict__ part,              // (B, Kv, S, G, DH)
                                     float* __restrict__ lse,               // (B, Kv, S, G)
                                     int T, int Kv, int G, int S, int span, float scale) {
  __shared__ Smem sm;
  const int b = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(0, min(lengths[b], T));
  load_q(sm, q + ((size_t)b * Kv * G + kvh * G) * DH);
  State st;
  const int t_begin = s * span;
  attend(st, sm, ck, cv, DenseRow{b, T, Kv, kvh}, t_begin, min(t_begin + span, len), scale);
  const size_t row = (((size_t)b * Kv + kvh) * S + s) * G + warp;
  *reinterpret_cast<float4*>(part + row * DH + lane * 4) = normalised(st);
  if (lane == 0) lse[row] = st.l > 0.0f ? st.m + logf(st.l) : NEG_INF;
}

__global__ void split_combine_kernel(const float* __restrict__ part, const float* __restrict__ lse,
                                     __nv_bfloat16* __restrict__ out,  // (B, H, DH)
                                     int Kv, int G, int S) {
  const int H = Kv * G;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / G, g = h % G;
  const int d = threadIdx.x;
  const size_t base = ((size_t)b * Kv + kvh) * S;  // row (b, kvh, s=0) before the G axis
  float mx = NEG_INF;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, lse[(base + s) * G + g]);
  float den = 0.0f, acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float l = lse[(base + s) * G + g];
    const float w = l > NEG_INF * 0.5f ? expf(l - mx) : 0.0f;
    den += w;
    acc += part[((base + s) * G + g) * DH + d] * w;
  }
  out[((size_t)b * H + h) * DH + d] = __float2bfloat16(acc / fmaxf(den, 1e-30f));
}

}  // namespace

// Launches both passes on `stream`; allocates nothing (`part` and `lse` are
// the caller's float32 scratch); returns cudaGetLastError().
// Caller guarantees: bf16 contiguous q (B, H, dh), caches (B, T, Kv, dh)
// with dh == 128, H == Kv * G with G <= 16, int32 lengths, S >= 1 splits
// of `span` positions covering T.
extern "C" int decode_attention_split(const void* q, const void* k, const void* v,
                                      const int* lengths, float* part, float* lse, void* out,
                                      int B, int T, int Kv, int G, int dh, int S, int span,
                                      float scale, void* stream) {
  if (dh != DH || G < 1 || G > GMAX || S < 1 || span < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || Kv == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  split_partial_kernel<<<dim3(B, Kv, S), 32 * G, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, part, lse, T, Kv, G, S, span, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_combine_kernel<<<B * Kv * G, DH, 0, st>>>(part, lse, static_cast<__nv_bfloat16*>(out),
                                                  Kv, G, S);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
