// GQA flash-decode over a dense per-slot KV cache, split over each
// sequence's live length.
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
// What bounds it on an H100: bytes in principle (each (b, kv) reads
// len x dh x 2 bf16 of K and V once for 4 x G flops per element pair), but
// at decode the bytes are few: batch 8 at lengths 145-387 reads 4.3 MB at
// qwen3-30b's dh 128 and 4 kv heads, 1.3 us at 3.35 TB/s.  So a launch is bound by latency: how many SMs
// hold live work, and how many dependent trips to memory each makes.
//
// Design: the split over each live length of decode_split.cuh (grid
// (B * Kv * NG, S), S = min(32, ceil(T / 64)), NG = ceil(G / 16) head
// groups; a two-chunk cp.async ring; scores and P . V on mma.sync; the
// splits combined in the same launch through per-row tickets), with rows
// addressed in the dense cache.  The instance for the head dim (64, 112 or
// 128) is picked at launch.  (One thread per (head, position) on the CUDA
// cores took longer than the loads; one chunk per split made the combine
// cost more than it saved.)
//
// Tolerance: bf16 (rtol = atol = 2e-2, tests/test_fused_swiglu.py:50)
// against the plain float32 version, for the bf16 probabilities and the
// other summation order.

#include "decode_split.cuh"

namespace {

using namespace decode_split;

template <int DH>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,   // (B, H, DH)
                        const __nv_bfloat16* __restrict__ ck,  // (B, T, Kv, DH)
                        const __nv_bfloat16* __restrict__ cv,  // (B, T, Kv, DH)
                        const int* __restrict__ lengths,       // (B,)
                        float* __restrict__ part,              // (B * Kv * NG, S, Gs, DH)
                        float* __restrict__ lse,               // (B * Kv * NG, S, Gs)
                        int* __restrict__ tickets,             // (B * Kv * NG,), zero between launches
                        __nv_bfloat16* __restrict__ out,       // (B, H, DH)
                        int T, int Kv, int G, float scale) {
  __shared__ Smem<DH> sm;
  const int NG = head_groups(G), hg = blockIdx.x % NG, bk = blockIdx.x / NG;
  const int b = bk / Kv, kvh = bk % Kv, g0 = hg * GMAX;
  const int len = max(0, min(lengths[b], T));
  const size_t head0 = ((size_t)bk * G + g0) * DH;  // query head kv * G + g0 of sequence b
  attend_split<DH>(sm, q + head0, ck, cv, DenseRows<DH>{b, T, Kv, kvh},
                   split_of(len, blockIdx.y, gridDim.y), part, lse, tickets, out + head0,
                   min(GMAX, G - g0), head_stride(G), scale);
}

}  // namespace

// Splits per row for a cache of T positions: the partials' second axis.
extern "C" int decode_attention_splits(int T) { return splits_for(T); }

// Launches on `stream`; allocates nothing (`part`, `lse` are the caller's
// float32 scratch of decode_attention_splits(T) splits and
// B * Kv * ceil(G / 16) rows of min(G, 16) heads, `tickets` its int32
// counters, one per row, zero before the launch and left at zero);
// returns cudaGetLastError().  Caller guarantees: bf16 contiguous q (B, H,
// dh), caches (B, T, Kv, dh) with dh in {64, 112, 128}, H == Kv * G,
// int32 lengths.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* lengths, float* part, float* lse, int* tickets,
                                void* out, int B, int T, int Kv, int G, int dh, float scale,
                                void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  return with_head_dim(dh, [&](auto c) {
    constexpr int DH = decltype(c)::value;
    if (B == 0 || Kv == 0) return (int)cudaGetLastError();
    decode_attention_kernel<DH><<<dim3(B * Kv * head_groups(G), splits_for(T)), NT, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), lengths, part, lse, tickets,
        static_cast<__nv_bfloat16*>(out), T, Kv, G, scale);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
