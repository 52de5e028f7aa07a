// Head path of the sieve dual path: grouped SwiGLU over the capacity slab.
//
// Replaces the TPU kernel repro/kernels/fused_swiglu.py:133
// fused_swiglu_gmm (pallas_call at :205; wrapper repro/kernels/ops.py:197).
// Per group g with expert e = rhs_of_group[g] (identity when null):
//   out[g, r] = (silu(x[g, r] . wg[e]) * (x[g, r] . wu[e])) . wd[e]
// for rows r < group_sizes[g], and 0 for the other rows.  Accumulation is
// float32; the SiLU product is rounded to bf16 before the down product, as
// the TPU kernel casts it to the input dtype (fused_swiglu.py:117).
//
// What bounds it on an H100: bytes.  A live tile of a few rows needs its
// expert's 3 x K x F bf16 weights (9.4 MB at qwen3-30b widths) for 2 flops
// per weight and row; even a full 40-row prefill group stays below the
// card's ~295 flops per byte.
//
// Design.  The TPU grid runs in order and parks a (bm, F) float32 SiLU
// product in VMEM across grid steps.  Here blocks run in parallel, and one
// expert's weight stream read by one SM is far too slow (13 live experts
// at a decode step would use 13 SMs).  So the work of one (group, 16-row)
// tile is split over F / 64 blocks: block (tile, s) computes the 64 SiLU
// columns [64 s, 64 s + 64) from its slices of wg and wu, keeps them in
// shared memory as bf16 (the product never reaches device memory), and
// multiplies them by the matching 64 rows of wd into a float32 partial of
// the tile's output.  A second pass sums the F / 64 partials of each row
// in a fixed order (deterministic, no atomics), casts to bf16 and writes
// zeros for rows at or past the group's size.  Each block reads its
// group's size itself and leaves at once on a tile with no live row.
// Products run on the tensor cores through WMMA (bf16 in, float32
// accumulate); weight tiles are staged through shared memory by 16-byte
// loads, all of a stage's loads in flight at once.  No TMA, no wgmma and
// no multi-stage pipeline yet.
//
// Tolerance: tensor-core tiles and the split sum in another order than the
// plain version's float32 einsum, and the SiLU product is rounded to bf16
// on both sides, so a product that lands on a rounding boundary may round
// the other way; the kernel agrees with its plain version within the
// repo's bf16 tolerance (rtol = atol = 2e-2, tests/test_fused_swiglu.py:50).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 16;    // rows per tile (one WMMA row tile)
constexpr int BF = 64;    // SiLU columns per block (the F split)
constexpr int BK = 128;   // contraction depth per staged wg/wu tile
constexpr int BN = 128;   // output columns per staged wd tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;    // bf16 elements of row padding (bank spread)

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

struct Smem {
  size_t xs, hs, w, stage, total;
  __host__ __device__ explicit Smem(int K) {
    size_t o = 0;
    xs = o;  o += align128(sizeof(__nv_bfloat16) * BM * (K + PAD));
    hs = o;  o += align128(sizeof(__nv_bfloat16) * BM * (BF + PAD));
    size_t w1 = sizeof(__nv_bfloat16) * 2 * BK * (BF + PAD);
    size_t w2 = sizeof(__nv_bfloat16) * BF * (BN + PAD);
    w = o;   o += align128(w1 > w2 ? w1 : w2);
    size_t s1 = sizeof(float) * 2 * BM * BF;
    size_t s2 = sizeof(float) * BM * BN;
    stage = o; o += align128(s1 > s2 ? s1 : s2);
    total = o;
  }
};

__device__ inline float silu(float g) { return g / (1.0f + expf(-g)); }

__global__ void __launch_bounds__(NTHREADS)
swiglu_gmm_partial(const __nv_bfloat16* __restrict__ x,   // (G, C, K)
                   const __nv_bfloat16* __restrict__ wg,  // (E, K, F)
                   const __nv_bfloat16* __restrict__ wu,  // (E, K, F)
                   const __nv_bfloat16* __restrict__ wd,  // (E, F, N)
                   const int* __restrict__ group_sizes,   // (G,)
                   const int* __restrict__ rhs_of_group,  // (G,) or null
                   float* __restrict__ partial,           // (F / BF, G, C, N)
                   int G, int C, int K, int F, int N, int tiles_per_group) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem L(K);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.xs);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.hs);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.w);
  float* stage = reinterpret_cast<float*>(smem_raw + L.stage);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = blockIdx.x / tiles_per_group;
  const int row0 = (blockIdx.x % tiles_per_group) * BM;
  const int s = blockIdx.y;
  const int f0 = s * BF;
  const int size = min(group_sizes[g], C);
  if (row0 >= size) return;  // dead tile: no weight traffic, the reduce writes its zeros
  const int e = rhs_of_group ? rhs_of_group[g] : g;
  const int live = min(BM, size - row0);

  // ---- activations: live rows to shared memory, other rows zero ----
  const int ldx = K + PAD;
  const int kv = K / 8;  // 16-byte vectors per row
  for (int i = tid; i < BM * kv; i += NTHREADS) {
    const int r = i / kv, c = i % kv;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < live)
      v = *reinterpret_cast<const uint4*>(x + ((size_t)g * C + row0 + r) * K + c * 8);
    *reinterpret_cast<uint4*>(xs + r * ldx + c * 8) = v;
  }

  // ---- phase 1: h = silu(x wg[:, f0:f0+64]) * (x wu[:, f0:f0+64]) ----
  // warps 0-3 own the gate fragments, warps 4-7 the up fragments
  const __nv_bfloat16* wge = wg + (size_t)e * K * F + f0;
  const __nv_bfloat16* wue = wu + (size_t)e * K * F + f0;
  const int ldw = BF + PAD;
  __nv_bfloat16* wgs = ws;
  __nv_bfloat16* wus = ws + BK * ldw;
  const int frag_n = (warp % 4) * 16;
  const __nv_bfloat16* wtile = warp < 4 ? wgs : wus;
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    constexpr int vpr = BF / 8;
    constexpr int per = BK * vpr / NTHREADS;
    for (int k0 = 0; k0 < K; k0 += BK) {
      // all of a thread's loads are issued before its first store, so a
      // stage costs one memory latency rather than one per vector
      uint4 ra[per], rb[per];
#pragma unroll
      for (int j = 0; j < per; ++j) {
        const int i = tid + j * NTHREADS, r = i / vpr, c = i % vpr;
        const size_t src = (size_t)(k0 + r) * F + c * 8;
        ra[j] = *reinterpret_cast<const uint4*>(wge + src);
        rb[j] = *reinterpret_cast<const uint4*>(wue + src);
      }
      __syncthreads();  // previous tile consumed (and xs ready)
#pragma unroll
      for (int j = 0; j < per; ++j) {
        const int i = tid + j * NTHREADS, r = i / vpr, c = i % vpr;
        *reinterpret_cast<uint4*>(wgs + r * ldw + c * 8) = ra[j];
        *reinterpret_cast<uint4*>(wus + r * ldw + c * 8) = rb[j];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, xs + k0 + kk, ldx);
        wmma::load_matrix_sync(b, wtile + kk * ldw + frag_n, ldw);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    wmma::store_matrix_sync(stage + (warp < 4 ? 0 : BM * BF) + frag_n, acc, BF,
                            wmma::mem_row_major);
  }
  __syncthreads();
  const int ldh = BF + PAD;
  for (int i = tid; i < BM * BF; i += NTHREADS) {
    const int r = i / BF, c = i % BF;
    hs[r * ldh + c] = __float2bfloat16(silu(stage[i]) * stage[BM * BF + i]);
  }

  // ---- phase 2: partial = h wd[f0:f0+64, :], 128 columns at a time ----
  const __nv_bfloat16* wde = wd + ((size_t)e * F + f0) * N;
  float* prow = partial + (((size_t)s * G + g) * C + row0) * N;
  const int ldd = BN + PAD;
  constexpr int vpr2 = BN / 8;
  constexpr int per2 = BF * vpr2 / NTHREADS;
  for (int n0 = 0; n0 < N; n0 += BN) {
    uint4 rd[per2];
#pragma unroll
    for (int j = 0; j < per2; ++j) {
      const int i = tid + j * NTHREADS, r = i / vpr2, c = i % vpr2;
      rd[j] = *reinterpret_cast<const uint4*>(wde + (size_t)r * N + n0 + c * 8);
    }
    __syncthreads();  // hs complete / previous wd tile and stage consumed
#pragma unroll
    for (int j = 0; j < per2; ++j) {
      const int i = tid + j * NTHREADS, r = i / vpr2, c = i % vpr2;
      *reinterpret_cast<uint4*>(ws + r * ldd + c * 8) = rd[j];
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < BF; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, hs + kk, ldh);
      wmma::load_matrix_sync(b, ws + kk * ldd + warp * 16, ldd);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(stage + warp * 16, acc, BN, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < live * BN; i += NTHREADS) {
      const int r = i / BN, c = i % BN;
      prow[(size_t)r * N + n0 + c] = stage[r * BN + c];
    }
  }
}

// out[g, r] = bf16(sum_s partial[s, g, r]) for live rows, 0 for the others.
__global__ void __launch_bounds__(NTHREADS)
swiglu_gmm_reduce(const float* __restrict__ partial, const int* __restrict__ group_sizes,
                  __nv_bfloat16* __restrict__ out, int G, int C, int N, int n_splits) {
  const int row = blockIdx.x;  // flat (g, r) over G * C
  const int g = row / C, r = row % C;
  const bool live = r < min(group_sizes[g], C);
  __nv_bfloat16* orow = out + (size_t)row * N;
  for (int n = threadIdx.x; n < N; n += NTHREADS) {
    float acc = 0.0f;
    if (live)
      for (int s = 0; s < n_splits; ++s) acc += partial[((size_t)s * G * C + row) * N + n];
    orow[n] = __float2bfloat16(acc);
  }
}

}  // namespace

extern "C" int fused_swiglu_gmm_smem_bytes(int K) { return (int)Smem(K).total; }

// Launches both passes on `stream`; allocates nothing (`partial` is the
// caller's (F / 64, G, C, N) float32 scratch); returns cudaGetLastError().
// Caller guarantees: bf16 contiguous tensors, K % 128 == 0, F % 64 == 0,
// N % 128 == 0, 16-byte aligned bases, int32 group tables.
extern "C" int fused_swiglu_gmm(const void* x, const void* wg, const void* wu,
                                const void* wd, const int* group_sizes,
                                const int* rhs_of_group, float* partial, void* out,
                                int G, int C, int K, int F, int N, void* stream) {
  const int tiles_per_group = (C + BM - 1) / BM;
  if (G == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = (int)Smem(K).total;
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_gmm_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_splits = F / BF;
  swiglu_gmm_partial<<<dim3(G * tiles_per_group, n_splits), NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wg),
      static_cast<const __nv_bfloat16*>(wu), static_cast<const __nv_bfloat16*>(wd),
      group_sizes, rhs_of_group, partial, G, C, K, F, N, tiles_per_group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  swiglu_gmm_reduce<<<G * C, NTHREADS, 0, st>>>(
      partial, group_sizes, static_cast<__nv_bfloat16*>(out), G, C, N, n_splits);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
