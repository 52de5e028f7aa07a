// Tail path of the sieve dual path: one SwiGLU per row, each with its own
// expert (the paper's PIM-side streaming GEMV).
//
// Replaces the TPU kernel repro/kernels/fused_swiglu.py:289
// fused_swiglu_gemv (pallas_call at :331; wrapper repro/kernels/ops.py:266).
// Per row i with expert e = expert_ids[i]:
//   out[i] = (silu(tok[i] . wg[e]) * (tok[i] . wu[e])) . wd[e]  if valid[i]
//   out[i] = 0                                                   otherwise
// Accumulation is float32; the SiLU product is rounded to bf16 before the
// down product, as the TPU kernel casts it (fused_swiglu.py:274-276).
//
// What bounds it on an H100: bytes.  A live row reads its expert's
// 3 x K x F bf16 weights once (9.4 MB at qwen3-30b widths, 2.8 us at
// 3.35 TB/s) for 2 flops per weight; a dead row reads nothing.
//
// Design.  With one token per tail expert no two rows share weights, and
// one block per row would stream 9.4 MB through a single SM.  So each
// row's stream is split over F / 64 blocks: block (i, s) computes the 64
// SiLU columns [64 s, 64 s + 64) from its slices of wg and wu, then their
// contribution to all N outputs through the matching 64 rows of wd, and
// writes that float32 partial.  A second pass sums the partials of a row
// in a fixed order (deterministic, no atomics), casts to bf16 and writes
// zeros for dead rows.  Dead rows leave the first pass at once.
//
// Tolerance: the split sums the down product in another order than one
// float32 dot product would, a few float32 ulps; after the bf16 rounding
// of the output the kernel agrees with its plain version within the
// repo's bf16 tolerance (rtol = atol = 2e-2, tests/test_fused_swiglu.py:50),
// the bound chip_smoke.py holds it to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FC = 64;          // SiLU columns per block
constexpr int NTHREADS = 256;
constexpr int KSLICES = NTHREADS / (FC / 8);  // 32 threads share a column vector

__device__ inline float silu(float g) { return g / (1.0f + expf(-g)); }

__device__ inline void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__global__ void __launch_bounds__(NTHREADS)
swiglu_gemv_partial(const __nv_bfloat16* __restrict__ tok, long long tok_stride,
                    const __nv_bfloat16* __restrict__ wg,  // (E, K, F)
                    const __nv_bfloat16* __restrict__ wu,  // (E, K, F)
                    const __nv_bfloat16* __restrict__ wd,  // (E, F, N)
                    const int* __restrict__ expert_ids, const int* __restrict__ valid,
                    float* __restrict__ partial,  // (F / FC, S, N)
                    int S, int K, int F, int N) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                       // K
  float* red_g = xs + K;                  // KSLICES x FC
  float* red_u = red_g + KSLICES * FC;    // KSLICES x FC
  float* hs = red_u + KSLICES * FC;       // FC

  const int i = blockIdx.x;
  const int s = blockIdx.y;
  if (valid[i] <= 0) return;  // dead row: no weight traffic
  const int e = expert_ids[i];
  const int tid = threadIdx.x;
  const int f0 = s * FC;

  for (int k = tid; k < K; k += NTHREADS)
    xs[k] = __bfloat162float(tok[(size_t)i * tok_stride + k]);
  __syncthreads();

  // gate/up: thread owns 8 columns (cv) over the k-slice ks, ks + 32, ...
  const int cv = tid % (FC / 8);
  const int ks = tid / (FC / 8);
  float g[8], u[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) g[j] = u[j] = 0.0f;
  const __nv_bfloat16* wge = wg + (size_t)e * K * F + f0 + cv * 8;
  const __nv_bfloat16* wue = wu + (size_t)e * K * F + f0 + cv * 8;
#pragma unroll 4
  for (int k = ks; k < K; k += KSLICES) {
    const uint4 a = *reinterpret_cast<const uint4*>(wge + (size_t)k * F);
    const uint4 b = *reinterpret_cast<const uint4*>(wue + (size_t)k * F);
    float fa[8], fb[8];
    unpack8(a, fa);
    unpack8(b, fb);
    const float xv = xs[k];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      g[j] += xv * fa[j];
      u[j] += xv * fb[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red_g[ks * FC + cv * 8 + j] = g[j];
    red_u[ks * FC + cv * 8 + j] = u[j];
  }
  __syncthreads();
  if (tid < FC) {
    float gs = 0.0f, us = 0.0f;
    for (int r = 0; r < KSLICES; ++r) {
      gs += red_g[r * FC + tid];
      us += red_u[r * FC + tid];
    }
    hs[tid] = __bfloat162float(__float2bfloat16(silu(gs) * us));
  }
  __syncthreads();

  // down: partial[s, i, n] = sum_c hs[c] * wd[e, f0 + c, n], 8 n per thread
  const __nv_bfloat16* wde = wd + ((size_t)e * F + f0) * N;
  float* prow = partial + ((size_t)s * S + i) * N;
  for (int n8 = tid; n8 < N / 8; n8 += NTHREADS) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < FC; ++c) {
      const uint4 w = *reinterpret_cast<const uint4*>(wde + (size_t)c * N + n8 * 8);
      float fw[8];
      unpack8(w, fw);
      const float h = hs[c];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += h * fw[j];
    }
    float4* dst = reinterpret_cast<float4*>(prow + n8 * 8);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

__global__ void __launch_bounds__(NTHREADS)
swiglu_gemv_reduce(const float* __restrict__ partial, const int* __restrict__ valid,
                   __nv_bfloat16* __restrict__ out, int S, int N, int n_splits) {
  const int i = blockIdx.x;
  __nv_bfloat16* orow = out + (size_t)i * N;
  const bool live = valid[i] > 0;
  for (int n = threadIdx.x; n < N; n += NTHREADS) {
    float acc = 0.0f;
    if (live)
      for (int s = 0; s < n_splits; ++s) acc += partial[((size_t)s * S + i) * N + n];
    orow[n] = __float2bfloat16(acc);
  }
}

}  // namespace

// Once per device, before the first launch: raises the first pass's
// dynamic shared-memory limit to the most a block may opt into (it has no
// static shared memory) and returns that limit.  Kept out of the launch,
// which a CUDA graph may capture.
extern "C" int fused_swiglu_gemv_init(int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(swiglu_gemv_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   *max_smem);
}

// Launches both passes on `stream`; allocates nothing (`partial` is the
// caller's (F / 64, S, N) float32 scratch); returns cudaGetLastError().
// Caller guarantees: bf16 weights and tokens, unit stride along K,
// F % 64 == 0, N % 8 == 0, 16-byte aligned weight bases, int32 tables,
// and a prior fused_swiglu_gemv_init on this device (a K whose shared
// memory passes its limit fails to launch).
extern "C" int fused_swiglu_gemv(const void* tok, long long tok_stride,
                                 const void* wg, const void* wu, const void* wd,
                                 const int* expert_ids, const int* valid,
                                 float* partial, void* out, int S, int K, int F,
                                 int N, void* stream) {
  if (S == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_splits = F / FC;
  const size_t smem = sizeof(float) * (K + 2 * KSLICES * FC + FC);
  swiglu_gemv_partial<<<dim3(S, n_splits), NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(tok), tok_stride,
      static_cast<const __nv_bfloat16*>(wg), static_cast<const __nv_bfloat16*>(wu),
      static_cast<const __nv_bfloat16*>(wd), expert_ids, valid, partial, S, K, F, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  swiglu_gemv_reduce<<<S, NTHREADS, 0, st>>>(
      partial, valid, static_cast<__nv_bfloat16*>(out), S, N, n_splits);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
