// GQA flash-decode of one query per sequence, split over each sequence's
// live length, for a KV cache whose rows a map addresses.  Shared by the
// dense decode kernel (decode_attention.cu) and the split-KV one
// (decode_attention_split.cu), both on rows of a (B, T, Kv, DH) cache, and
// the paged one (decode_attention_paged.cu: rows of a block pool through
// a block table).
//
// For sequence b and query head h = kv * G + g:
//   out[b, h] = softmax(q[b, h] . K[b, :len, kv] / sqrt(dh)) . V[b, :len, kv]
// computed by online softmax in float32.  A length-0 row gives exact
// zeros, as the TPU kernel's masked-tile guard does (decode_attention.py:44).
//
// The loop is a template on the head dim DH, with an instance for each of
// 64, 112 and 128 (HEAD_DIMS; the entry points pick it at launch).  Each
// instance keeps K, V and q rows at a stride of DH + 8 bf16 in shared
// memory (144, 240 and 272 bytes: an odd number of 16-byte units, so the
// eight rows an ldmatrix reads fall in eight distinct bank groups), and
// splits P . V over the four warps by 16-dim tiles: one each at 64, two
// each at 128, and two, two, two and one at 112 (7 tiles).  The scores
// walk DH / 16 k-steps two at a time, the odd last one of 112 alone.
//
// A block serves at most GMAX = 16 query heads of one kv head (two n = 8
// tiles).  A larger group size G runs ceil(G / 16) head groups, a further
// grid axis: each such block reads the same K/V chunks, the later ones
// from L2.  Row r of the grid is (b, kv, head group): r = (b * Kv + kv) *
// NG + hg.  The grid is (B * Kv * NG, S) with S = min(32, ceil(T / 64))
// splits, T the most positions a sequence can hold.  Split s of a row takes a
// contiguous run of that sequence's own live 32-position chunks, counted
// on the device from its length: two chunks per split, more once a
// sequence holds over 64 chunks, so the parallelism follows the live
// length and never T.  A split past the last live chunk exits at once;
// split 0 of a length-0 sequence writes its zeros.  K and V come by
// cp.async into a ring of two chunks, the next chunk in flight while this
// one is used; each 16-byte vector of a row is addressed through the row
// map, and a row the map sends to -1 is read as zeros.  The products run
// on the tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulate):
// the scores K q^T with positions on the M side and the block's query
// heads on n = 8 (one or two head tiles), P . V as V^T P^T with the head
// dims on M and the heads on n.  The probabilities
// are rounded to bf16 for P . V (the TPU kernel multiplies in float32; the
// rounding stays within the bf16 tolerance).  The online softmax takes one
// warp per head, one lane per position.  A sequence with one live split
// writes its output at once.  Otherwise each split writes a float32
// partial and its log-sum-exp, then takes a ticket on its row's counter;
// the block with the last ticket sums the splits in split order (the same
// bits whichever block finishes last) and resets the counter, so the next
// launch finds it at zero.  Nothing is allocated on the card: partials and
// counters come from the wrapper.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

namespace decode_split {

constexpr int GMAX = 16;           // query heads per block: two n = 8 tiles at most (ops.ATTENTION_HEAD_BLOCK)
constexpr int CHUNK = 32;          // positions per chunk: one lane each in the softmax
constexpr int SMAX = 32;           // most splits per row
constexpr int MIN_CPS = 2;         // fewest chunks per split
constexpr int NT = 128;            // threads per block
constexpr int NWARP = NT / 32;
constexpr int PLD = CHUNK + 8;     // probability row stride in bf16: 80 B, conflict-free ldmatrix
static_assert(CHUNK == 32, "the softmax gives each position of a chunk one lane");
static_assert(SMAX <= 32, "the combine gives each split one lane");

// The shapes of the instance for head dim DH.
template <int DH>
struct Dims {
  static constexpr int VPR = DH / 8;            // 16-byte vectors per row
  static constexpr int LD = DH + 8;             // q, K and V row stride in bf16
  static constexpr int KSTEPS = DH / 16;        // k-steps of the scores, 16 dims each
  static constexpr int MTILES = DH / 16;        // 16-dim tiles of P . V
  static constexpr int MTW = (MTILES + NWARP - 1) / NWARP;  // tiles per warp
  static constexpr bool EVEN_M = MTILES == MTW * NWARP;       // every warp's tiles exist
  static constexpr int TASKS = (GMAX * VPR + NT - 1) / NT;    // (head, 8 dims) combine tasks per thread
  static_assert(DH % 16 == 0, "whole 16-dim tiles");
  static_assert(LD * 2 / 16 % 2 == 1, "an odd row stride in 16-byte units: conflict-free ldmatrix");
};

// Calls f(std::integral_constant<int, DH>{}) for the instance of head dim
// dh; cudaErrorInvalidValue for a head dim without one.
template <class F>
inline int with_head_dim(int dh, F&& f) {
  switch (dh) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Head groups of GMAX query heads per kv head, and the partials' head stride.
__host__ __device__ inline int head_groups(int G) { return (G + GMAX - 1) / GMAX; }
__host__ __device__ inline int head_stride(int G) { return G < GMAX ? G : GMAX; }

// Splits per (b, kv) for sequences of at most T positions: the partials'
// second axis and the grid's.
__host__ __device__ inline int splits_for(int T) {
  const int splits = ((T + CHUNK - 1) / CHUNK + MIN_CPS - 1) / MIN_CPS;
  return splits < 1 ? 1 : splits < SMAX ? splits : SMAX;
}

// raw bf16 storage (unsigned short): shared arrays of the bf16 class type
// would need its (trivial) constructor to be accepted by every toolkit
template <int DH>
struct Smem {
  static constexpr int LD = Dims<DH>::LD;
  __align__(16) unsigned short qs[GMAX * LD];         // heads past the block's are zeros
  __align__(16) unsigned short ks[2][CHUNK * LD];     // ring of two chunks
  __align__(16) unsigned short vs[2][CHUNK * LD];
  __align__(16) unsigned short pb[GMAX * PLD];        // probabilities for P . V
  float ps[GMAX][CHUNK];     // scores, then probabilities; split weights in the combine
  float m[GMAX], l[GMAX];    // running max and sum per head
  float corr[GMAX];          // rescale of the running output for this chunk
  int ticket;
};

// Split s of a sequence of `len` live positions: its first chunk and
// chunk count (nc = 0: an empty split), and the sequence's live splits.
struct Split {
  int len, n_splits, c_begin, nc;
};

__device__ inline Split split_of(int len, int s, int S) {
  Split sp;
  sp.len = len;
  const int n_chunks = (len + CHUNK - 1) / CHUNK;
  const int cps = max(MIN_CPS, (n_chunks + S - 1) / S);  // chunks per split, from the live length
  sp.n_splits = cps ? (n_chunks + cps - 1) / cps : 0;
  sp.c_begin = s * cps;
  sp.nc = s < sp.n_splits ? min(cps, n_chunks - sp.c_begin) : 0;
  return sp;
}

// Position t of kv head kvh of sequence b in a (B, T, Kv, DH) cache.
template <int DH>
struct DenseRows {
  int b, T, Kv, kvh;
  __device__ long long operator()(int t) const { return (((long long)b * T + t) * Kv + kvh) * DH; }
};

__device__ inline void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 16 : 0));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 tiles: fragments of mma.sync m16n8k16 from row-major rows
__device__ inline void ldmatrix_x4(unsigned* r, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// two 8x8 bf16 tiles (lanes 0-15 address them): b0, b1 of one k-step
__device__ inline void ldmatrix_x2(unsigned* r, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(smem)));
}

// the same, transposed: the A fragment from a row-major K x M tile
__device__ inline void ldmatrix_x4_trans(unsigned* r, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// c += a . b, bf16 in, float32 accumulate (a pure register operation)
__device__ inline void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ inline void store8_bf16(__nv_bfloat16* dst, const float* v) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// Split blockIdx.y of grid row blockIdx.x (the partials' and tickets'
// row).  `rows(t)` is the element offset of live position t's K/V row (its
// kv head, dim 0) in `ck`/`cv`, or -1 for a row read as zeros; `qrow` and
// `orow` point at the block's first query head of sequence b; G is the
// block's query heads (at most GMAX), Gs the partials' head stride; `sp`
// is split_of(len, s, S).  Every thread of the block calls it (it
// synchronises the block).
template <int DH, class Rows>
__device__ inline void attend_split(Smem<DH>& sm, const __nv_bfloat16* __restrict__ qrow,
                                    const __nv_bfloat16* __restrict__ ck,
                                    const __nv_bfloat16* __restrict__ cv, const Rows& rows,
                                    const Split& sp, float* __restrict__ part,
                                    float* __restrict__ lse, int* __restrict__ tickets,
                                    __nv_bfloat16* __restrict__ orow, int G, int Gs, float scale) {
  using D = Dims<DH>;
  constexpr int VPR = D::VPR, LD = D::LD, KSTEPS = D::KSTEPS, MTW = D::MTW;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, t4 = lane % 4;  // a fragment's row and column pair
  const int bk = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int len = sp.len, n_splits = sp.n_splits;
  if (sp.nc == 0) {
    if (s == 0)  // length 0: exact zeros
      for (int i = tid; i < G * VPR; i += NT)
        reinterpret_cast<uint4*>(orow)[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  const int c_begin = sp.c_begin, nc = sp.nc;
  const int ntn = (G + 7) / 8;  // n = 8 tiles of query heads

  // chunk c of the split into ring slot c % 2, one copy group, always
  // committed (empty past the split) to keep the group count
  auto load_chunk = [&](int c) {
    if (c < nc) {
      const int t0 = (c_begin + c) * CHUNK, slot = c % 2;
      for (int i = tid; i < CHUNK * VPR; i += NT) {
        const int r = i / VPR, v = i % VPR;
        // rows past the length, and rows the map drops: zeros, no read
        const long long off = t0 + r < len ? rows(t0 + r) : -1;
        const bool full = off >= 0;
        const size_t o = (full ? (size_t)off : 0) + v * 8;
        cp_async16(&sm.ks[slot][r * LD + v * 8], ck + o, full);
        cp_async16(&sm.vs[slot][r * LD + v * 8], cv + o, full);
      }
    }
    cp_async_commit();
  };
  for (int i = tid; i < ntn * 8 * VPR; i += NT) {  // q rows of whole head tiles
    const int g = i / VPR, v = i % VPR;
    cp_async16(&sm.qs[g * LD + v * 8], qrow + (size_t)(g < G ? g : 0) * DH + v * 8, g < G);
  }
  load_chunk(0);  // q rides in the first group
  load_chunk(1);
  for (int g = tid; g < GMAX; g += NT) {
    sm.m[g] = -INFINITY;
    sm.l[g] = 0.0f;
    sm.corr[g] = 0.0f;
  }
  for (int i = tid; i < GMAX * PLD; i += NT) sm.pb[i] = 0;  // heads past G stay zero

  // P . V accumulators: this warp's 16-dim tiles MTW * warp + mt by head
  // tiles.  Element i of a fragment is dim m0 + gid + 8 (i / 2), head
  // n0 + 2 t4 + i % 2.
  float o[MTW][2][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][nt][i] = 0.0f;

  for (int c = 0; c < nc; ++c) {
    const int slot = c % 2;
    const int n = min(CHUNK, len - (c_begin + c) * CHUNK);  // >= 1
    cp_async_wait<1>();  // chunk c (and q) landed; chunk c + 1 may be in flight
    __syncthreads();
    if (warp < 2 * ntn) {  // scores K q^T: position tile warp % 2, head tile warp / 2
      const int tb = (warp % 2) * 16, nb = (warp / 2) * 8;
      const unsigned short* ka =
          &sm.ks[slot][(tb + lane % 8 + (lane / 8 % 2) * 8) * LD + (lane / 16) * 8];
      const unsigned short* qb = &sm.qs[(nb + lane % 8) * LD + (lane / 8) * 8];
      float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk + 1 < KSTEPS; kk += 2) {
        unsigned a0[4], a1[4], bq[4];  // bq: b0, b1 of k-step kk, then of kk + 1
        ldmatrix_x4(a0, ka + kk * 16);
        ldmatrix_x4(a1, ka + (kk + 1) * 16);
        ldmatrix_x4(bq, qb + kk * 16);
        mma_bf16(sc, a0, bq[0], bq[1]);
        mma_bf16(sc, a1, bq[2], bq[3]);
      }
      if (KSTEPS % 2) {  // the odd last k-step (DH = 112)
        unsigned a0[4], bq[2];
        ldmatrix_x4(a0, ka + (KSTEPS - 1) * 16);
        ldmatrix_x2(bq, qb + (KSTEPS - 1) * 16);
        mma_bf16(sc, a0, bq[0], bq[1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // element i: position tb + gid + 8 (i / 2),
                                     // head nb + 2 t4 + i % 2
        const int t = tb + gid + 8 * (i / 2), g = nb + 2 * t4 + i % 2;
        sm.ps[g][t] = t < n ? sc[i] * scale : -INFINITY;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += NWARP) {  // online softmax, one lane per position
      const float v = sm.ps[g][lane];
      const float m_old = sm.m[g];
      const float m_new = fmaxf(m_old, warp_max(v));  // finite: position 0 is live
      const float p = lane < n ? expf(v - m_new) : 0.0f;
      const float corr = expf(m_old - m_new);  // 0 on the first chunk (m = -inf)
      const float l = warp_sum(p);
      sm.pb[g * PLD + lane] = __bfloat16_as_ushort(__float2bfloat16(p));
      __syncwarp();
      if (lane == 0) {
        sm.l[g] = sm.l[g] * corr + l;
        sm.m[g] = m_new;
        sm.corr[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {  // O^T += V^T P^T over the chunk's two 16-position steps
      const int mtile = MTW * warp + mt;
      if (!D::EVEN_M && mtile >= D::MTILES) continue;  // warp-uniform
      const int m0 = mtile * 16;
      unsigned va[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldmatrix_x4_trans(va[ks], &sm.vs[slot][(ks * 16 + (lane / 16) * 8 + lane % 8) * LD + m0 +
                                               (lane / 8 % 2) * 8]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (nt < ntn) {
          unsigned pbf[4];  // b0, b1 of positions 0-15, then of 16-31
          ldmatrix_x4(pbf, &sm.pb[(nt * 8 + lane % 8) * PLD + (lane / 8) * 8]);
#pragma unroll
          for (int i = 0; i < 4; ++i) o[mt][nt][i] *= sm.corr[nt * 8 + 2 * t4 + i % 2];
          mma_bf16(o[mt][nt], va[0], pbf[0], pbf[1]);
          mma_bf16(o[mt][nt], va[1], pbf[2], pbf[3]);
        }
      }
    }
    __syncthreads();  // ring slot, scores and probabilities consumed
    load_chunk(c + 2);
  }
  cp_async_wait<0>();

  const bool single = n_splits == 1;
  const size_t prow = (size_t)bk * S + s;  // (row, s) of the partials
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
    const int mtile = MTW * warp + mt;
    if (!D::EVEN_M && mtile >= D::MTILES) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = mtile * 16 + gid + 8 * (i / 2), g = nt * 8 + 2 * t4 + i % 2;
        if (nt < ntn && g < G) {
          const float v = o[mt][nt][i] / sm.l[g];  // l > 0: every split holds a live position
          if (single) orow[g * DH + d] = __float2bfloat16(v);
          else part[(prow * Gs + g) * DH + d] = v;
        }
      }
    }
  }
  if (!single && tid < G) lse[prow * Gs + tid] = sm.m[tid] + logf(sm.l[tid]);
  if (single) return;

  // the last split of the row to finish combines them all
  __syncthreads();  // every thread's partial is written ...
  if (tid == 0) {
    __threadfence();  // ... and visible (the fence is cumulative over the barrier)
    sm.ticket = atomicAdd(&tickets[bk], 1);
  }
  __syncthreads();
  if (sm.ticket != n_splits - 1) return;
  __threadfence();
  for (int g = warp; g < G; g += NWARP) {  // split weights: one lane per split
    const float l = lane < n_splits ? __ldcg(lse + ((size_t)bk * S + lane) * Gs + g) : -INFINITY;
    const float mx = warp_max(l);  // every lane shuffles: finite, split 0 is live
    const float w = lane < n_splits ? expf(l - mx) : 0.0f;
    const float den = warp_sum(w);  // a fixed butterfly: the same bits every launch
    sm.ps[g][lane] = w;
    if (lane == 0) sm.l[g] = den;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < D::TASKS; ++k) {
    const int task = tid + k * NT;
    if (task < G * VPR) {
      const int g = task / VPR, v = task % VPR;
      float o[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
      for (int j = 0; j < n_splits; ++j) {  // split order: deterministic
        const float w = sm.ps[g][j];
        const float4* src =
            reinterpret_cast<const float4*>(part + (((size_t)bk * S + j) * Gs + g) * DH + v * 8);
        const float4 x = __ldcg(src), y = __ldcg(src + 1);
        o[0] = fmaf(w, x.x, o[0]);
        o[1] = fmaf(w, x.y, o[1]);
        o[2] = fmaf(w, x.z, o[2]);
        o[3] = fmaf(w, x.w, o[3]);
        o[4] = fmaf(w, y.x, o[4]);
        o[5] = fmaf(w, y.y, o[5]);
        o[6] = fmaf(w, y.z, o[6]);
        o[7] = fmaf(w, y.w, o[7]);
      }
      const float inv = 1.0f / sm.l[g];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] *= inv;
      store8_bf16(orow + g * DH + v * 8, o);
    }
  }
  if (tid == 0) tickets[bk] = 0;  // every split of this launch has taken its ticket
}

}  // namespace decode_split
