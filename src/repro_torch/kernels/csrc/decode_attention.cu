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
// get p = 0).  Each lane scores two positions of a tile; the running max,
// sum and the lane's 4 output dims stay in registers across tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int DH = 128;      // head dim (the wrapper checks)
constexpr int BT = 64;       // positions per tile
constexpr int GMAX = 16;     // query heads per kv head (warps per block)
constexpr int KW = DH / 2 + 1;  // K row stride in 32-bit words (padded)

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // (B, H, DH)
                                        const __nv_bfloat16* __restrict__ ck,  // (B, T, Kv, DH)
                                        const __nv_bfloat16* __restrict__ cv,  // (B, T, Kv, DH)
                                        const int* __restrict__ lengths,       // (B,)
                                        __nv_bfloat16* __restrict__ out,       // (B, H, DH)
                                        int T, int Kv, int G, float scale) {
  __shared__ float2 qs[GMAX][DH / 2];
  // raw storage: shared arrays of the bf16 class types would need their
  // (trivial) constructors to be accepted by every toolkit version
  __shared__ unsigned int ks[BT * KW];                 // bf16 pairs
  __shared__ __align__(16) unsigned short vs[BT * DH];  // bf16
  __shared__ float ps[GMAX][BT];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nthreads = blockDim.x;
  const int H = Kv * G;
  const int len = max(0, min(lengths[b], T));

  const __nv_bfloat16* qrow = q + ((size_t)b * H + kvh * G + warp) * DH;
  for (int d2 = lane; d2 < DH / 2; d2 += 32)
    qs[warp][d2] = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(qrow)[d2]);

  float m = -INFINITY, l = 0.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dims lane*4 .. lane*4+3

  constexpr int VPR = DH / 8;  // 16-byte vectors per row
  for (int t0 = 0; t0 < len; t0 += BT) {
    const int n = min(BT, len - t0);
    __syncthreads();  // previous tile consumed (and qs written)
    for (int i = tid; i < BT * VPR; i += nthreads) {
      const int r = i / VPR, c = i % VPR;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (r < n) {
        const size_t off = (((size_t)b * T + t0 + r) * Kv + kvh) * DH + c * 8;
        kv4 = *reinterpret_cast<const uint4*>(ck + off);
        vv4 = *reinterpret_cast<const uint4*>(cv + off);
      }
      ks[r * KW + c * 4 + 0] = kv4.x;
      ks[r * KW + c * 4 + 1] = kv4.y;
      ks[r * KW + c * 4 + 2] = kv4.z;
      ks[r * KW + c * 4 + 3] = kv4.w;
      *reinterpret_cast<uint4*>(vs + r * DH + c * 8) = vv4;
    }
    __syncthreads();

    float s[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = lane + 32 * j;
      float dot = 0.0f;
#pragma unroll 8
      for (int d2 = 0; d2 < DH / 2; ++d2) {
        const float2 kf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ks[t * KW + d2]));
        const float2 qf = qs[warp][d2];
        dot += qf.x * kf.x + qf.y * kf.y;
      }
      s[j] = t < n ? dot * scale : -INFINITY;
    }
    const float m_new = fmaxf(m, warp_max(fmaxf(s[0], s[1])));  // finite: n >= 1
    const float p0 = lane < n ? expf(s[0] - m_new) : 0.0f;
    const float p1 = lane + 32 < n ? expf(s[1] - m_new) : 0.0f;
    const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
    l = l * corr + warp_sum(p0 + p1);
    ps[warp][lane] = p0;
    ps[warp][lane + 32] = p1;
    __syncwarp();
#pragma unroll
    for (int d = 0; d < 4; ++d) acc[d] *= corr;
    for (int t = 0; t < n; ++t) {
      const float p = ps[warp][t];
      const __nv_bfloat162* vp = reinterpret_cast<const __nv_bfloat162*>(vs + t * DH + lane * 4);
      const float2 v01 = __bfloat1622float2(vp[0]);
      const float2 v23 = __bfloat1622float2(vp[1]);
      acc[0] += p * v01.x;
      acc[1] += p * v01.y;
      acc[2] += p * v23.x;
      acc[3] += p * v23.y;
    }
    __syncwarp();
    m = m_new;
  }

  // length 0: acc == 0 and l == 0, so the row is exactly zero
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(
      out + ((size_t)b * H + kvh * G + warp) * DH + lane * 4);
  orow[0] = __floats2bfloat162_rn(acc[0] * inv, acc[1] * inv);
  orow[1] = __floats2bfloat162_rn(acc[2] * inv, acc[3] * inv);
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
