// Per-row expert GEMV: one call of the three-call (unfused) tail path of
// the sieve dual path (the paper's PIM-side streaming GEMV).
//
// Replaces the TPU kernel repro/kernels/expert_gemv.py:64 expert_gemv
// (pallas_call at :91; wrapper repro/kernels/ops.py:243).  Per row i with
// expert e = expert_ids[i]:
//   out[i] = tok[i] . w[e]   if valid[i]
//   out[i] = 0               otherwise
// accumulated in float32 and rounded to bf16.
//
// What bounds it on an H100: bytes.  A live row reads its expert's K x N
// bf16 matrix once (3.1 MB for a qwen3-30b gate/up/down matrix, 0.94 us at
// 3.35 TB/s) for 2 flops per weight; a dead row reads nothing.
//
// Design.  No two tail rows share an expert, and one block per row would
// stream a whole matrix through one SM.  So a row's matrix is split over
// N / 64 blocks (12 for gate/up, 32 for down at qwen3-30b widths), as the
// fused tail kernel splits F: block (i, j) reads the K x 64 column slice
// [64 j, 64 j + 64) of w[e] and writes those 64 outputs.  Within the block
// each thread owns 8 columns (one 16-byte vector) of a K-slice, four
// vectors in flight per thread, and the 32 K-slices are summed in shared
// memory in a fixed order (deterministic, no atomics).  Dead rows write
// their zeros and leave without reading a weight.  The token row is read
// through a row stride, so the tail can pass rows of the capacity slab
// without a copy.
//
// Tolerance: the K-slices sum in another order than one float32 dot
// product, a few float32 ulps; after the bf16 rounding of the output the
// kernel agrees with its plain version within the repo's bf16 tolerance
// (rtol = atol = 2e-2, tests/test_fused_swiglu.py:50).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;                       // output columns per block
constexpr int NTHREADS = 256;
constexpr int KSLICES = NTHREADS / (BN / 8);  // 32 threads share a column vector

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
expert_gemv_kernel(const __nv_bfloat16* __restrict__ tok, long long tok_stride,
                   const __nv_bfloat16* __restrict__ w,  // (E, K, N)
                   const int* __restrict__ expert_ids, const int* __restrict__ valid,
                   __nv_bfloat16* __restrict__ out,  // (S, N)
                   int K, int N) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;       // K
  float* red = xs + K;    // KSLICES x BN

  const int i = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  __nv_bfloat16* orow = out + (size_t)i * N + n0;
  if (valid[i] <= 0) {  // dead row: zeros, no weight traffic
    if (tid < BN / 8) reinterpret_cast<uint4*>(orow)[tid] = make_uint4(0, 0, 0, 0);
    return;
  }
  const int e = expert_ids[i];
  for (int k = tid; k < K; k += NTHREADS) xs[k] = __bfloat162float(tok[(size_t)i * tok_stride + k]);
  __syncthreads();

  const int cv = tid % (BN / 8);
  const int ks = tid / (BN / 8);
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  const __nv_bfloat16* we = w + (size_t)e * K * N + n0 + cv * 8;
#pragma unroll 4
  for (int k = ks; k < K; k += KSLICES) {
    const uint4 a = *reinterpret_cast<const uint4*>(we + (size_t)k * N);
    float fa[8];
    unpack8(a, fa);
    const float xv = xs[k];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += xv * fa[j];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[ks * BN + cv * 8 + j] = acc[j];
  __syncthreads();
  if (tid < BN) {
    float sum = 0.0f;
    for (int r = 0; r < KSLICES; ++r) sum += red[r * BN + tid];
    orow[tid] = __float2bfloat16(sum);
  }
}

}  // namespace

// Once per device, before the first launch: raises the kernel's dynamic
// shared-memory limit to the most a block may opt into (the kernel has no
// static shared memory) and returns that limit.  Kept out of the launch,
// which a CUDA graph may capture.
extern "C" int expert_gemv_init(int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(expert_gemv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   *max_smem);
}

// Launches on `stream`; allocates nothing; returns cudaGetLastError().
// Caller guarantees: bf16 weights (E, K, N) contiguous with a 16-byte
// aligned base, bf16 tokens with unit stride along K, N % 64 == 0, int32
// expert ids and valid flags, and a prior expert_gemv_init on this device
// (a K whose shared memory passes its limit fails to launch).
extern "C" int expert_gemv(const void* tok, long long tok_stride, const void* w,
                           const int* expert_ids, const int* valid, void* out, int S, int K,
                           int N, void* stream) {
  if (N % BN != 0) return (int)cudaErrorInvalidValue;
  if (S == 0 || N == 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * (K + KSLICES * BN);
  expert_gemv_kernel<<<dim3(S, N / BN), NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(tok), tok_stride, static_cast<const __nv_bfloat16*>(w),
      expert_ids, valid, static_cast<__nv_bfloat16*>(out), K, N);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
