// Split-KV GQA flash-decode over a dense per-slot KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:193
// decode_attention, its n_splits>1 branch (pallas_call at :274; body
// _decode_attn_split_kernel :132; combine _combine_splits :178; wrapper
// repro/kernels/ops.py:299).  For each sequence b and query head
// h = kv * G + g:
//   out[b, h] = softmax(q[b, h] . K[b, :len, kv] / sqrt(dh)) . V[b, :len, kv]
// with len = lengths[b] (clamped to T), computed by online softmax in
// float32.  A length-0 row gives exact zeros, as the TPU combine does.
// The function does not depend on n_splits: on the TPU, whose grid runs
// in order on one core, n_splits buys parallelism over the KV axis, as
// partials and log-sum-exps over contiguous whole-tile ranges of T,
// combined afterwards.
//
// What bounds it on an H100: bytes in principle (each (b, kv) reads
// len x dh x 2 bf16 of K and V once for 4 x G flops per element pair), but
// at decode the bytes are few (4.3 MB at batch 8, lengths 145-387: 1.3 us
// at 3.35 TB/s), so a launch is bound by latency: how many SMs hold live
// work, and how many dependent trips to memory each makes.
//
// Design: the split over each live length of decode_split.cuh, the loop
// the dense kernel runs (grid (B * Kv * NG, S), S = min(32, ceil(T / 64)),
// NG = ceil(G / 16) head groups; each split a run of two or more of the
// sequence's own live 32-position chunks; a two-chunk cp.async ring; scores
// and P . V on mma.sync; the splits combined in the same launch by the
// block that takes the last ticket of its row, which leaves the counter at
// zero), at the instance of the head dim (64, 112 or 128).  On the card
// the number of splits follows each live length, not the caller's
// n_splits: the live-length split already gives the parallelism that
// n_splits buys on the TPU, and splits over T (the TPU's partition) leave
// the splits past the length with nothing to do while the live ones walk
// their ranges in series.  The plain version keeps the TPU's partition,
// so the two agree within the bf16 tolerance, not bit for bit.
//
// Tolerance: bf16 (rtol = atol = 2e-2, tests/test_fused_swiglu.py:50)
// against the plain float32 version, for the bf16 probabilities and the
// other summation order.

#include "decode_split.cuh"

namespace {

using namespace decode_split;

template <int DH>
__global__ void __launch_bounds__(NT)
decode_attention_split_kernel(const __nv_bfloat16* __restrict__ q,   // (B, H, DH)
                              const __nv_bfloat16* __restrict__ ck,  // (B, T, Kv, DH)
                              const __nv_bfloat16* __restrict__ cv,  // (B, T, Kv, DH)
                              const int* __restrict__ lengths,       // (B,)
                              float* __restrict__ part,              // (B * Kv * NG, S, Gs, DH)
                              float* __restrict__ lse,               // (B * Kv * NG, S, Gs)
                              int* __restrict__ tickets,  // (B * Kv * NG,), zero between launches
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
extern "C" int decode_attention_split(const void* q, const void* k, const void* v,
                                      const int* lengths, float* part, float* lse, int* tickets,
                                      void* out, int B, int T, int Kv, int G, int dh, float scale,
                                      void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  return with_head_dim(dh, [&](auto c) {
    constexpr int DH = decltype(c)::value;
    if (B == 0 || Kv == 0) return (int)cudaGetLastError();
    decode_attention_split_kernel<DH><<<dim3(B * Kv * head_groups(G), splits_for(T)), NT, 0,
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
