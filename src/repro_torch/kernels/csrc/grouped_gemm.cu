// Ragged grouped matmul over the capacity slab: one call of the three-call
// (unfused) head path of the sieve dual path.
//
// Replaces the TPU kernel repro/kernels/grouped_gemm.py:85 grouped_gemm
// (pallas_call at :120; wrapper repro/kernels/ops.py:96 gmm_capacity).
// Per group g with weight row e = rhs_of_group[g] (identity when null):
//   out[g, r] = x[g, r] . rhs[e]   for rows r < group_sizes[g]
//   out[g, r] = 0                  for the other rows
// accumulated in float32 and rounded to bf16.
//
// What bounds it on an H100: bytes.  A live (group, 16-row) tile needs its
// expert's K x N bf16 weights (3.1 MB for a qwen3-30b gate/up/down matrix)
// for 2 flops per weight and live row; a capacity of 8 (decode) or 40
// (prefill) rows stays far below the card's ~295 flops per byte.
//
// Design.  The TPU grid walks (m-tile, n-tile, k-tile) in order with a
// (bm, bn) float32 accumulator in VMEM and skips the MXU work of dead
// tiles.  Here one block computes one (16-row, 64-column) output tile of
// one group over the whole K, so a live expert's weights are spread over
// N / 64 blocks (12 for gate/up, 32 for down at qwen3-30b widths).  A block
// reads its group's size itself: on a tile with no live row it writes the
// tile's zeros and leaves without reading a weight.  The capacity C need
// not be a multiple of 16: rows at or past the group's size are loaded as
// zeros and written as zeros, rows at or past C are neither read nor
// written (no padded copy of the slab).  (x, w) chunks of 64 along K flow
// through a 4-stage ring in shared memory by cp.async, so three chunks are
// in flight while the tensor cores (WMMA, bf16 in, float32 accumulate)
// multiply the fourth; each of the 4 warps owns one 16 x 16 output
// fragment.  No TMA and no wgmma yet.
//
// Tolerance: tensor-core tiles sum in another order than the plain
// version's float32 einsum; after the bf16 rounding of the output the
// kernel agrees with it within the repo's bf16 tolerance (rtol = atol =
// 2e-2, tests/test_fused_swiglu.py:50).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int BM = 16;      // rows per tile (one WMMA row tile)
constexpr int BN = 64;      // output columns per block
constexpr int BK = 64;      // contraction depth per stage
constexpr int NSTAGE = 4;   // ring depth
constexpr int NWARPS = BN / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;      // bf16 elements of row padding (keeps 32-byte fragment alignment)
constexpr int LDX = BK + PAD;
constexpr int LDW = BN + PAD;

struct __align__(128) Smem {
  unsigned short xs[NSTAGE][BM * LDX];  // bf16
  unsigned short ws[NSTAGE][BK * LDW];  // bf16
};
static_assert(sizeof(Smem) <= 48 * 1024, "static shared memory");
static_assert(BM * BN * sizeof(float) <= sizeof(Smem), "output staging reuses the ring");

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__global__ void __launch_bounds__(NTHREADS)
grouped_gemm_kernel(const __nv_bfloat16* __restrict__ x,    // (G, C, K)
                    const __nv_bfloat16* __restrict__ rhs,  // (E, K, N)
                    const int* __restrict__ group_sizes,    // (G,)
                    const int* __restrict__ rhs_of_group,   // (G,) or null
                    __nv_bfloat16* __restrict__ out,        // (G, C, N)
                    int C, int K, int N, int tiles_per_group) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = blockIdx.x / tiles_per_group;
  const int row0 = (blockIdx.x % tiles_per_group) * BM;
  const int n0 = blockIdx.y * BN;
  const int size = max(0, min(group_sizes[g], C));
  const int rows = min(BM, C - row0);  // rows of this tile inside the slab
  const int live = max(0, min(BM, size - row0));
  __nv_bfloat16* otile = out + ((size_t)g * C + row0) * N + n0;
  constexpr int VPR = BN / 8;  // 16-byte vectors per output row

  if (live == 0) {  // dead tile: zeros, no weight traffic
    for (int i = tid; i < rows * VPR; i += NTHREADS)
      *reinterpret_cast<uint4*>(otile + (size_t)(i / VPR) * N + (i % VPR) * 8) =
          make_uint4(0, 0, 0, 0);
    return;
  }
  const int e = rhs_of_group ? rhs_of_group[g] : g;
  const __nv_bfloat16* xg = x + ((size_t)g * C + row0) * K;
  const __nv_bfloat16* we = rhs + (size_t)e * K * N + n0;

  // rows past the live count stay zero in every stage: only live rows are
  // ever copied in
  for (int i = tid; i < NSTAGE * BM * LDX; i += NTHREADS) (&sm.xs[0][0])[i] = 0;
  __syncthreads();

  const int nk = K / BK;
  auto load_stage = [&](int stage, int kc) {
    const int k0 = kc * BK;
    for (int i = tid; i < BK * (BN / 8); i += NTHREADS) {
      const int r = i / (BN / 8), c = i % (BN / 8);
      cp_async16(&sm.ws[stage][r * LDW + c * 8], we + (size_t)(k0 + r) * N + c * 8);
    }
    for (int i = tid; i < live * (BK / 8); i += NTHREADS) {
      const int r = i / (BK / 8), c = i % (BK / 8);
      cp_async16(&sm.xs[stage][r * LDX + c * 8], xg + (size_t)r * K + k0 + c * 8);
    }
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<NSTAGE - 2>();  // chunk kc has landed (for this thread)
    __syncthreads();              // ... for every thread; chunk kc - 1 consumed
    if (kc + NSTAGE - 1 < nk) load_stage((kc + NSTAGE - 1) % NSTAGE, kc + NSTAGE - 1);
    cp_async_commit();
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(sm.xs[kc % NSTAGE]);
    const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(sm.ws[kc % NSTAGE]);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, xs + kk, LDX);
      wmma::load_matrix_sync(b, ws + kk * LDW + warp * 16, LDW);
      wmma::mma_sync(acc, a, b, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp done with the ring: reuse it for the output
  float* stage = reinterpret_cast<float*>(&sm);
  wmma::store_matrix_sync(stage + warp * 16, acc, BN, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < rows * VPR; i += NTHREADS) {
    const int r = i / VPR, c = i % VPR;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < live) {
      const float* src = stage + r * BN + c * 8;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(src[2 * j], src[2 * j + 1]);
    }
    *reinterpret_cast<uint4*>(otile + (size_t)r * N + c * 8) = v;
  }
}

}  // namespace

// Launches on `stream`; allocates nothing; returns cudaGetLastError().
// Caller guarantees: bf16 contiguous x (G, C, K), rhs (E, K, N) and out
// (G, C, N) with 16-byte aligned bases, K % 64 == 0, N % 64 == 0, int32
// group tables.
extern "C" int grouped_gemm(const void* x, const void* rhs, const int* group_sizes,
                            const int* rhs_of_group, void* out, int G, int C, int K, int N,
                            void* stream) {
  if (K % BK != 0 || N % BN != 0) return (int)cudaErrorInvalidValue;
  if (G == 0 || C == 0 || N == 0) return (int)cudaGetLastError();
  const int tiles_per_group = (C + BM - 1) / BM;
  grouped_gemm_kernel<<<dim3(G * tiles_per_group, N / BN), NTHREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(rhs), group_sizes,
      rhs_of_group, static_cast<__nv_bfloat16*>(out), C, K, N, tiles_per_group);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
