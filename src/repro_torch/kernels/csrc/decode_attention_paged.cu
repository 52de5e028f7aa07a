// GQA flash-decode over a paged KV cache: a shared block pool indexed
// through per-slot block tables, split over each slot's live length.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:338
// decode_attention_paged (pallas_call at :378; body
// _paged_decode_attn_kernel :297; wrapper repro/kernels/ops.py:323).  For
// slot b and query head h = kv * G + g:
//   out[b, h] = softmax(q[b, h] . K_b[:len, kv] / sqrt(dh)) . V_b[:len, kv]
// where logical position t of slot b lives in pool block
// tables[b, t / page] at row t % page, and len = lengths[b] clamped to
// max_blocks x page.  Only blocks and rows below len are read: the table
// cells past the length hold the trash block 0 and are never touched, nor
// are the padded rows of a prompt's last page.  An idle slot (length 1,
// table row all trash) reads row 0 of block 0, which is inside the pool.
// A table cell outside the pool reads as zeros instead of faulting.  A
// length-0 row gives exact zeros, as the TPU kernel's masked-tile guard
// does (decode_attention.py:44).
//
// What bounds it on an H100: bytes in principle (each (b, kv) reads
// len x dh x 2 bf16 of K and V once, plus ceil(len / page) table cells, for
// 4 x G flops per element pair), but at decode the bytes are few (4.3 MB
// at batch 8, lengths 145-387: 1.3 us at 3.35 TB/s), so a launch is bound
// by latency, as the dense kernel is.
//
// Design: the dense kernel's split over each live length
// (decode_split.cuh), with rows addressed through the block table, at the
// instance of the head dim (64, 112 or 128).  The grid is (B * Kv * NG, S)
// with S = min(32, ceil(max_blocks x page / 64)) and NG = ceil(G / 16) head
// groups; split s of a slot takes a run of its own live 32-position chunks.  Before its
// first load each split stages the table cells its positions span (a
// 32-position chunk spans 32 / page pages for a page below 32, and lies in
// one page otherwise) in shared memory, so the table costs one round trip
// per split; each 16-byte vector of a K/V row is then addressed through
// the staged cell.  The TPU grid walks one page per step; here the page
// size is a runtime argument and a small page costs no extra passes.
//
// Tolerance: bf16 (rtol = atol = 2e-2, tests/test_fused_swiglu.py:50)
// against the plain float32 version, for the bf16 probabilities and the
// other summation order.

#include "decode_split.cuh"

namespace {

using namespace decode_split;

constexpr int TAB = 64;  // table cells a split stages (beyond: read from the table)

// Position t of kv head kvh of one slot: its block from the staged cells
// [p0, p0 + n_tab) or the slot's table row, -1 outside the pool.
template <int DH>
struct PagedRows {
  const int* table;  // the slot's row of the block table
  const int* tab;    // staged cells, from cell p0
  int p0, n_tab, n_pool, page, Kv, kvh;
  __device__ long long operator()(int t) const {
    const int cell = t / page, i = cell - p0;
    const int phys = i < n_tab ? tab[i] : table[cell];
    if (phys < 0 || phys >= n_pool) return -1;
    return (((long long)phys * page + t % page) * Kv + kvh) * DH;
  }
};

template <int DH>
__global__ void __launch_bounds__(NT)
decode_attention_paged_kernel(const __nv_bfloat16* __restrict__ q,   // (B, H, DH)
                              const __nv_bfloat16* __restrict__ pk,  // (n_pool, page, Kv, DH)
                              const __nv_bfloat16* __restrict__ pv,  // (n_pool, page, Kv, DH)
                              const int* __restrict__ tables,        // (B, max_blocks)
                              const int* __restrict__ lengths,       // (B,)
                              float* __restrict__ part,              // (B * Kv * NG, S, Gs, DH)
                              float* __restrict__ lse,               // (B * Kv * NG, S, Gs)
                              int* __restrict__ tickets,  // (B * Kv * NG,), zero between launches
                              __nv_bfloat16* __restrict__ out,       // (B, H, DH)
                              int n_pool, int page, int Kv, int G, int max_blocks, float scale) {
  __shared__ Smem<DH> sm;
  __shared__ int tab[TAB];
  const int NG = head_groups(G), hg = blockIdx.x % NG, bk = blockIdx.x / NG;
  const int b = bk / Kv, kvh = bk % Kv, g0 = hg * GMAX;
  const int len = max(0, min(lengths[b], max_blocks * page));
  const Split sp = split_of(len, blockIdx.y, gridDim.y);
  const int* trow = tables + (size_t)b * max_blocks;
  int p0 = 0, n_tab = 0;
  if (sp.nc > 0) {  // the cells of the split's positions [t0, t1)
    const int t0 = sp.c_begin * CHUNK, t1 = min(len, (sp.c_begin + sp.nc) * CHUNK);
    p0 = t0 / page;
    n_tab = min(TAB, (t1 - 1) / page + 1 - p0);
    for (int i = threadIdx.x; i < n_tab; i += NT) tab[i] = trow[p0 + i];
    __syncthreads();
  }
  const size_t head0 = ((size_t)bk * G + g0) * DH;  // query head kv * G + g0 of slot b
  attend_split<DH>(sm, q + head0, pk, pv,
                   PagedRows<DH>{trow, tab, p0, n_tab, n_pool, page, Kv, kvh}, sp, part, lse,
                   tickets, out + head0, min(GMAX, G - g0), head_stride(G), scale);
}

}  // namespace

// Splits per row for a table of T = max_blocks x page positions: the
// partials' second axis.
extern "C" int decode_attention_splits(int T) { return splits_for(T); }

// Launches on `stream`; allocates nothing (`part`, `lse` are the caller's
// float32 scratch of decode_attention_splits(max_blocks * page) splits and
// B * Kv * ceil(G / 16) rows of min(G, 16) heads, `tickets` its int32
// counters, one per row, zero before the launch and left at zero); returns
// cudaGetLastError().  Caller guarantees: bf16 contiguous q (B, H, dh) and
// pools (n_pool, page, Kv, dh) with dh in {64, 112, 128}, H == Kv * G,
// int32 contiguous tables (B, max_blocks) and lengths (B,).
extern "C" int decode_attention_paged(const void* q, const void* pool_k, const void* pool_v,
                                      const int* tables, const int* lengths, float* part,
                                      float* lse, int* tickets, void* out, int B, int n_pool,
                                      int page, int Kv, int G, int dh, int max_blocks, float scale,
                                      void* stream) {
  if (G < 1 || page < 1 || max_blocks < 0) return (int)cudaErrorInvalidValue;
  return with_head_dim(dh, [&](auto c) {
    constexpr int DH = decltype(c)::value;
    if (B == 0 || Kv == 0) return (int)cudaGetLastError();
    decode_attention_paged_kernel<DH><<<dim3(B * Kv * head_groups(G), splits_for(max_blocks * page)),
                                        NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool_k),
        static_cast<const __nv_bfloat16*>(pool_v), tables, lengths, part, lse, tickets,
        static_cast<__nv_bfloat16*>(out), n_pool, page, Kv, G, max_blocks, scale);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
