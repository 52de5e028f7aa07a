// Online-softmax GQA decode over a range of KV positions, for one block per
// (sequence, kv head) with one warp per query head of the group.  Shared by
// the dense, split-KV and paged decode kernels.
//
// The block stages 64-position tiles of K and V in shared memory, so the G
// query heads of a kv head share each tile.  Only positions inside the
// range are loaded; a row the caller maps to -1 is read as zeros.  Each
// lane scores two positions of a tile; the running max, sum and the lane's
// 4 output dims stay in registers across tiles.  All threads of the block
// must call attend() with the same range (it synchronises the block).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace flash_decode {

constexpr int DH = 128;         // head dim (the wrappers check)
constexpr int BT = 64;          // positions per tile
constexpr int GMAX = 16;        // query heads per kv head (warps per block)
constexpr int KW = DH / 2 + 1;  // K row stride in 32-bit words (padded)
constexpr float NEG_INF = -1e30f;

// raw storage: shared arrays of the bf16 class types would need their
// (trivial) constructors to be accepted by every toolkit version
struct Smem {
  float2 qs[GMAX][DH / 2];
  unsigned int ks[BT * KW];                 // bf16 pairs
  __align__(16) unsigned short vs[BT * DH];  // bf16
  float ps[GMAX][BT];
};

struct State {
  float m = -INFINITY, l = 0.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dims lane*4 .. lane*4+3
};

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

// Warp w stages query head w of the group (`qrow` points at head 0).
__device__ inline void load_q(Smem& sm, const __nv_bfloat16* qrow) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(qrow + warp * DH);
  for (int d2 = lane; d2 < DH / 2; d2 += 32) sm.qs[warp][d2] = __bfloat1622float2(src[d2]);
}

// Online softmax of each warp's query head over positions [t_begin, t_end).
// `row_off(t)` is the element offset of position t's K/V row (its kv head,
// dim 0) in `ck`/`cv`, or -1 for a row read as zeros.
template <class RowOff>
__device__ inline void attend(State& st, Smem& sm, const __nv_bfloat16* __restrict__ ck,
                              const __nv_bfloat16* __restrict__ cv, const RowOff& row_off,
                              int t_begin, int t_end, float scale) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nthreads = blockDim.x;
  constexpr int VPR = DH / 8;  // 16-byte vectors per row
  for (int t0 = t_begin; t0 < t_end; t0 += BT) {
    const int n = min(BT, t_end - t0);
    __syncthreads();  // previous tile consumed (and qs written)
    for (int i = tid; i < BT * VPR; i += nthreads) {
      const int r = i / VPR, c = i % VPR;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (r < n) {
        const long long off = row_off(t0 + r);
        if (off >= 0) {
          kv4 = *reinterpret_cast<const uint4*>(ck + off + c * 8);
          vv4 = *reinterpret_cast<const uint4*>(cv + off + c * 8);
        }
      }
      sm.ks[r * KW + c * 4 + 0] = kv4.x;
      sm.ks[r * KW + c * 4 + 1] = kv4.y;
      sm.ks[r * KW + c * 4 + 2] = kv4.z;
      sm.ks[r * KW + c * 4 + 3] = kv4.w;
      *reinterpret_cast<uint4*>(sm.vs + r * DH + c * 8) = vv4;
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
            *reinterpret_cast<const __nv_bfloat162*>(&sm.ks[t * KW + d2]));
        const float2 qf = sm.qs[warp][d2];
        dot += qf.x * kf.x + qf.y * kf.y;
      }
      s[j] = t < n ? dot * scale : -INFINITY;
    }
    const float m_new = fmaxf(st.m, warp_max(fmaxf(s[0], s[1])));  // finite: n >= 1
    const float p0 = lane < n ? expf(s[0] - m_new) : 0.0f;
    const float p1 = lane + 32 < n ? expf(s[1] - m_new) : 0.0f;
    const float corr = expf(st.m - m_new);  // 0 on the first tile (m = -inf)
    st.l = st.l * corr + warp_sum(p0 + p1);
    sm.ps[warp][lane] = p0;
    sm.ps[warp][lane + 32] = p1;
    __syncwarp();
#pragma unroll
    for (int d = 0; d < 4; ++d) st.acc[d] *= corr;
    for (int t = 0; t < n; ++t) {
      const float p = sm.ps[warp][t];
      const __nv_bfloat162* vp =
          reinterpret_cast<const __nv_bfloat162*>(sm.vs + t * DH + lane * 4);
      const float2 v01 = __bfloat1622float2(vp[0]);
      const float2 v23 = __bfloat1622float2(vp[1]);
      st.acc[0] += p * v01.x;
      st.acc[1] += p * v01.y;
      st.acc[2] += p * v23.x;
      st.acc[3] += p * v23.y;
    }
    __syncwarp();
    st.m = m_new;
  }
}

// Position t of kv head kvh in a dense (B, T, Kv, DH) cache, sequence b.
struct DenseRow {
  int b, T, Kv, kvh;
  __device__ long long operator()(int t) const {
    return (((long long)b * T + t) * Kv + kvh) * DH;
  }
};

// The lane's 4 dims of the normalised output; an empty range (l == 0,
// acc == 0) gives exact zeros.
__device__ inline float4 normalised(const State& st) {
  const float inv = 1.0f / fmaxf(st.l, 1e-30f);
  return make_float4(st.acc[0] * inv, st.acc[1] * inv, st.acc[2] * inv, st.acc[3] * inv);
}

__device__ inline void store_bf16(__nv_bfloat16* row, const float4& o) {
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(row + (threadIdx.x % 32) * 4);
  dst[0] = __floats2bfloat162_rn(o.x, o.y);
  dst[1] = __floats2bfloat162_rn(o.z, o.w);
}

}  // namespace flash_decode
