// Tail path of the sieve dual path: one SwiGLU per row, each row with its
// own expert (the paper's PIM-side streaming GEMV).
//
// Replaces the TPU kernel repro/kernels/fused_swiglu.py:289
// fused_swiglu_gemv (pallas_call at :331; wrapper repro/kernels/ops.py:266).
// Per row i with expert e = expert_ids[i]:
//   out[i] = (silu(tok[i] . wg[e]) * (tok[i] . wu[e])) . wd[e]  if valid[i]
//   out[i] = 0                                                   otherwise
// Accumulation is float32; the SiLU product is rounded to bf16 before the
// down product, as the TPU kernel casts it (fused_swiglu.py:274-276).
//
// What bounds it on an H100: bytes.  Each distinct live expert's 3 x K x F
// bf16 weights (9.4 MB at qwen3-30b widths) are needed once, for 2 flops
// per weight and live row of that expert; a dead row reads nothing.  At
// the decode step's 36 live rows of 36 experts that is 340 MB (101 us at
// 3.35 TB/s); at the expert-parallel all-to-all layout, 8 live rows of 5
// experts, 47 MB (14 us).
//
// Design: one launch, a persistent grid.
//   - Each block builds the live list in shared memory from expert_ids and
//     valid (no host sync, so a CUDA graph may capture the launch): the live
//     rows grouped by expert (experts ascending, each expert's rows in row
//     order, whatever order the ids come in), cut into row groups of at most
//     32 rows.
//   - The work unit is (row group, 64-column F slice): the slice's columns
//     of wg and wu over the whole K, the bf16 SiLU products of all the
//     group's rows, then the slice's 64 rows of wd against every output
//     column, giving the group's float32 partial over N.  So each weight
//     byte is read once per row group, not once per row.  Block b takes
//     units b, b + grid, ...; neighbouring blocks stream neighbouring slices
//     of one expert at the same time.
//   - Each unit takes a ticket of its row group after its partial is
//     written; the block that takes the last one sums the group's partials
//     in slice order (the same bits whichever block finishes last), writes
//     the bf16 rows and resets the ticket.  Dead rows are zeroed by the same
//     launch: there is no second pass.
//   - A block's stream runs at a rate of its own: one late stage holds its
//     whole ring, so the ring's depth barely matters and independent blocks
//     on one SM do.  So the grid has several blocks per SM, in one of two
//     shapes chosen at launch from an upper bound of the unit count: WIDE,
//     four blocks of four consumer warps per SM, where the units can fill
//     them (qwen3's and deepseek-v2's decode tails), else DEEP, two blocks of
//     eight consumer warps with deeper rings (the all-to-all layout's 60
//     units).  On an H100 both beat one block of eight warps per SM where
//     they are taken; narrower slices, and units split over K between
//     blocks that swap their gate/up sums, were slower at every shape (a
//     32- or 16-column box streams fewer bytes per block than a 64-column
//     one).
//
// Each block is warp-specialised.  One producer warp streams every stage of
// its units, without a break between the gate/up and the down stages or
// between units, into a ring of 16 KB stages: for a gate/up stage one 64 x
// 64 TMA box of wg and one of wu (128-byte swizzled; 2D tensor maps encoded
// once per weight tensor on the host) and the group's 64-deep K slice of its
// rows by cp.async into a row buffer beside the ring; for a down stage two
// boxes of wd, 64 slice rows by 128 output columns.  The consumer warps run
// mma.sync m16n8k16 with the weight columns on the M side (A fragments by
// ldmatrix.trans from the swizzled boxes) and the group's rows on n = 8, one
// fragment per 8 rows.  In a gate/up stage a warp's 16 M rows are 8 columns
// of wg and the same 8 of wu, so a lane holds the gate and the up value of
// one (row, column); in a down stage a warp owns 16-column tiles.  The
// kernel allocates nothing on the card: partials and tickets come from the
// wrapper, and the dynamic shared-memory limits are raised once, by
// fused_swiglu_gemv_init.
//
// Tolerance: tensor-core tiles and the slice partials sum in another order
// than the plain version's float32 einsum, and the SiLU product is rounded
// to bf16 on both sides, so a product on a rounding boundary may round the
// other way; the kernel agrees with its plain version within the repo's
// bf16 tolerance (rtol = atol = 2e-2, tests/test_fused_swiglu.py:50).

#include "sm90.cuh"

namespace {

constexpr int BK = 64;                 // K (or slice) rows per stage
constexpr int FS = 64;                 // SiLU columns per unit: one box wide
constexpr int BN = 128;                // output columns per down stage: two boxes
constexpr int BOX_BYTES = BK * TMA_BOX * 2;
constexpr int W_BYTES = 2 * BOX_BYTES;  // a stage's weights
constexpr int RG = 32;                 // rows per row group at most
constexpr int NFRAG = RG / 8;          // n = 8 fragments per group at most
constexpr int MAX_STAGES = 12;         // ring depth where shared memory allows
constexpr int LDX = BK + 8;            // staged row stride in bf16: 144 B, conflict-free ldmatrix
constexpr int LDH = FS + 8;            // SiLU product row stride in bf16
static_assert(BK == TMA_BOX && FS == TMA_BOX && BN == 2 * TMA_BOX, "boxes of 64 x 64");

// The two launch shapes: DEEP, two blocks of eight consumer warps per SM,
// each with about 110 KB of shared memory (a ring of up to 6 stages);
// WIDE, four blocks of four consumer warps, each with about 56 KB (2 or 3
// stages).  A launch takes WIDE when its units can fill it.
template <int CTAS_, int NCW_>
struct Shape {
  static constexpr int CTAS = CTAS_;     // blocks per SM
  static constexpr int NCW = NCW_;       // consumer warps
  static constexpr int NCT = NCW * 32;   // consumer threads
  static constexpr int NT = NCT + 32;    // and one producer warp
  static constexpr int MTW = FS / 8 / NCW;   // gate/up: column octets per warp
  static constexpr int DMT = BN / 16 / NCW;  // down: 16-column tiles per warp
  static_assert(MTW * NCW * 8 == FS && DMT * NCW * 16 == BN, "whole octets and tiles per warp");
};
using Deep = Shape<2, 8>;
using Wide = Shape<4, 4>;

int g_smem[2] = {0, 0};  // the dynamic shared memory of a DEEP and of a WIDE block

// bytes of the lists at the front of shared memory: a count per expert,
// then each row's expert, the live rows and the groups' expert, first
// position and rows
__host__ __device__ inline int list_bytes(int S, int E) { return (E + 5 * S) * 4; }
// where the ring starts: after the lists, 1024-byte aligned for the swizzle
__host__ __device__ inline int ring_offset(int S, int E) {
  return (list_bytes(S, E) + 1023) / 1024 * 1024;
}
// a stage: its weight boxes in the ring, and `xr` staged rows beside it
__host__ __device__ inline int stage_bytes(int xr) { return W_BYTES + xr * LDX * 2; }
// after the ring and its rows: a full and an empty mbarrier per stage, the
// SiLU products
__host__ __device__ inline int tail_bytes(int xr) { return 2 * MAX_STAGES * 8 + xr * LDH * 2; }
// the least dynamic shared memory a block needs: alignment slack, the
// lists, two stages of the widest row groups and what follows them
__host__ __device__ inline int min_smem(int S, int E) {
  return 1024 + ring_offset(S, E) + 2 * stage_bytes(RG) + tail_bytes(RG);
}

template <int NCT>
__device__ inline void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory"); }

__device__ inline float silu(float g) { return g / (1.0f + expf(-g)); }

template <class Sh>
__global__ void __launch_bounds__(Sh::NT, Sh::CTAS)
fused_swiglu_gemv_kernel(const __grid_constant__ CUtensorMap gmap,  // wg (E, K, F) as (E * K, F)
                         const __grid_constant__ CUtensorMap umap,  // wu (E, K, F) as (E * K, F)
                         const __grid_constant__ CUtensorMap dmap,  // wd (E, F, N) as (E * F, N)
                         const __nv_bfloat16* __restrict__ tok, long long tok_stride,
                         const int* __restrict__ expert_ids, const int* __restrict__ valid,
                         float* __restrict__ part,  // (live row, slice, N) float32 partials
                         int* __restrict__ tickets,  // (row groups,), zero between launches
                         __nv_bfloat16* __restrict__ out, int S, int K, int F, int N, int E,
                         int smem_bytes) {
  constexpr int NCW = Sh::NCW, NCT = Sh::NCT, NT = Sh::NT, MTW = Sh::MTW, DMT = Sh::DMT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the ring's swizzled boxes need 1024-byte alignment: the lists come
  // first, the ring at ring_offset from an aligned base
  unsigned char* base = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  __shared__ int s_ngroups, s_maxrows, s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nblk = gridDim.x, b = blockIdx.x;
  int* s_cnt = reinterpret_cast<int*>(base);  // (E,) rows per expert, then its cursor
  int* s_eid = s_cnt + E;                     // (S,) each row's expert, -1 for a dead row
  int* s_rows = s_eid + S;                    // (S,) live rows, grouped by expert
  int* s_ge = s_rows + S;                     // (S,) row groups: expert,
  int* s_gp = s_ge + S;                       //      first position in s_rows,
  int* s_gn = s_gp + S;                       //      rows

  if (tid == NCT) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&gmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&umap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&dmap)) : "memory");
  }
  // A live row: valid and an expert in range (the caller guarantees the
  // range; a row outside it is taken as dead rather than read out of bounds).
  for (int e = tid; e < E; e += NT) s_cnt[e] = 0;
  for (int i = tid; i < S; i += NT) {
    const int e = valid[i] > 0 ? expert_ids[i] : -1;
    s_eid[i] = e < E ? e : -1;
  }
  __syncthreads();
  for (int i = tid; i < S; i += NT)
    if (s_eid[i] >= 0) atomicAdd(&s_cnt[s_eid[i]], 1);
  __syncthreads();
  if (warp == 0) {
    // experts in order: the first position of each one's rows and its row groups
    int pos = 0, gq = 0, mx = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int c = e < E ? s_cnt[e] : 0, ng = (c + RG - 1) / RG;
      int ic = c, ig = ng;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int vc = __shfl_up_sync(0xffffffffu, ic, o), vg = __shfl_up_sync(0xffffffffu, ig, o);
        if (lane >= o) {
          ic += vc;
          ig += vg;
        }
      }
      const int p = pos + ic - c, g = gq + ig - ng;
      for (int k = 0; k < ng; ++k) {
        s_ge[g + k] = e;
        s_gp[g + k] = p + k * RG;
        s_gn[g + k] = min(RG, c - k * RG);
      }
      if (e < E) s_cnt[e] = p;  // now the cursor of the placement below
      mx = max(mx, min(c, RG));
      pos += __shfl_sync(0xffffffffu, ic, 31);
      gq += __shfl_sync(0xffffffffu, ig, 31);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    __syncwarp();
    // each live row at its expert's cursor, 32 rows at a time in row order:
    // a stable placement, the same every launch
    for (int i0 = 0; i0 < S; i0 += 32) {
      const int i = i0 + lane;
      const int e = i < S ? s_eid[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, e);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (e >= 0) s_rows[s_cnt[e] + rank] = i;
      __syncwarp();
      if (e >= 0 && rank == __popc(peers) - 1) s_cnt[e] += __popc(peers);
      __syncwarp();
    }
    if (lane == 0) {
      s_ngroups = gq;
      s_maxrows = mx;
    }
  }
  __syncthreads();

  // dead rows: zeros, one warp per row
  for (int row = b * (NT / 32) + warp; row < S; row += nblk * (NT / 32)) {
    if (s_eid[row] < 0) {
      uint4* dst = reinterpret_cast<uint4*>(out + (size_t)row * N);
      for (int v = lane; v < N / 8; v += 32) dst[v] = make_uint4(0, 0, 0, 0);
    }
  }
  const int n_groups = s_ngroups;
  if (n_groups == 0) return;

  const int nsl = F / FS, nkg = K / BK, nkd = (N + BN - 1) / BN;
  const int n_units = n_groups * nsl, xr = (s_maxrows + 7) / 8 * 8;
  unsigned char* ring = base + ring_offset(S, E);
  const int sb = stage_bytes(xr);
  const int n_stages = min(MAX_STAGES, (smem_bytes - (int)(base - smem_raw) - ring_offset(S, E) -
                                        tail_bytes(xr)) / sb);
  if (n_stages < 2) __trap();  // the wrapper's size check rules this out
  unsigned char* xring = ring + n_stages * W_BYTES;  // each stage's staged rows, xr x LDX
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(xring + n_stages * xr * LDX * 2);
  const unsigned full0 = smem_addr(bars), empty0 = smem_addr(bars + MAX_STAGES);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(bars + 2 * MAX_STAGES);

  if (tid == 0) {
    for (int st = 0; st < n_stages; ++st) {
      mbar_init(full0 + 8 * st, 33);    // the TMA arrive (with its bytes), one per producer lane
      mbar_init(empty0 + 8 * st, NCW);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last barrier of the whole block: the warps part here

  if (warp == NCW) {  // producer: every stage of this block's units, in order
    int st = 0, ph = 0;
    bool first = true;
    auto next = [&] {
      if (++st == n_stages) {
        st = 0;
        ph ^= 1;
        first = false;
      }
    };
    for (int u = b; u < n_units; u += nblk) {
      const int q = u / nsl, f0 = (u % nsl) * FS;
      const int e = s_ge[q], p0 = s_gp[q], n = s_gn[q];
      const int xrq = (n + 7) / 8 * 8;
      for (int kc = 0; kc < nkg; ++kc) {
        if (!first) mbar_wait(empty0 + 8 * st, ph ^ 1);  // the slot's last fill consumed
        const unsigned full = full0 + 8 * st, ws = smem_addr(ring + st * W_BYTES);
        if (lane == 0) {
          mbar_arrive_expect_tx(full, W_BYTES);
          tma_load_2d(ws, &gmap, f0, e * K + kc * BK, full);
          tma_load_2d(ws + BOX_BYTES, &umap, f0, e * K + kc * BK, full);
        }
        // the group's rows, K slice kc; fragment rows past its count are
        // zero-filled, not read
        const unsigned xs = smem_addr(xring + st * xr * LDX * 2);
        for (int i = lane; i < xrq * (BK / 8); i += 32) {
          const int r = i / (BK / 8), cc = i % (BK / 8);
          const bool live = r < n;
          const __nv_bfloat16* src =
              tok + (size_t)s_rows[p0 + (live ? r : 0)] * tok_stride + kc * BK + cc * 8;
          cp_async16(xs + (r * LDX + cc * 8) * 2, src, live);
        }
        cp_async_arrive(full);
        next();
      }
      for (int j = 0; j < nkd; ++j) {
        if (!first) mbar_wait(empty0 + 8 * st, ph ^ 1);
        const unsigned full = full0 + 8 * st, ws = smem_addr(ring + st * W_BYTES);
        if (lane == 0) {
          const int boxes = min(BN, N - j * BN) / TMA_BOX;
          mbar_arrive_expect_tx(full, boxes * BOX_BYTES);
          for (int i = 0; i < boxes; ++i)
            tma_load_2d(ws + i * BOX_BYTES, &dmap, j * BN + i * TMA_BOX, e * F + f0, full);
        }
        cp_async_arrive(full);  // no copies: an arrive once this lane's earlier ones landed
        next();
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers
  const int gid = lane / 4, t4 = lane % 4;
  int st = 0, ph = 0;
  auto next = [&] {
    if (++st == n_stages) {
      st = 0;
      ph ^= 1;
    }
  };
  // ldmatrix rows: lanes 8i..8i+7 address 8x8 tile i = (k half i / 2, M half
  // i % 2); in a 128-byte swizzled box the 16-byte chunk c of row k sits at
  // c ^ (k % 8), and k % 8 = lane % 8 here
  const int krow = (lane / 16) * 8 + lane % 8, mh = lane / 8 % 2;
  float acc[MTW][NFRAG][4];
  for (int u = b; u < n_units; u += nblk) {
    const int q = u / nsl, s = u % nsl;
    const int p0 = s_gp[q], n = s_gn[q];
    const int nfrag = (n + 7) / 8;
#pragma unroll
    for (int t = 0; t < MTW; ++t)
#pragma unroll
      for (int f = 0; f < NFRAG; ++f) acc[t][f][0] = acc[t][f][1] = acc[t][f][2] = acc[t][f][3] = 0.0f;

    // gate/up: octet c = warp + NCW t of the slice; M half 0 is its 8
    // columns of the wg box, M half 1 the same columns of the wu box
    for (int kc = 0; kc < nkg; ++kc) {
      mbar_wait(full0 + 8 * st, ph);  // the stage has landed
      const unsigned char* ws = ring + st * W_BYTES;
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(xring + st * xr * LDX * 2);
#pragma unroll
      for (int t = 0; t < MTW; ++t) {
        const int c = warp + NCW * t;
        const unsigned char* arow = ws + mh * BOX_BYTES + krow * TMA_BOX * 2 + ((c ^ (lane % 8)) * 16);
        unsigned a[BK / 16][4];  // the stage's A fragments, all loads in flight at once
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) ldmatrix_x4_trans(a[kk], arow + kk * 16 * TMA_BOX * 2);
#pragma unroll
        for (int f = 0; f < NFRAG; ++f) {
          if (f < nfrag) {
            // lanes 8i..8i+7 address rows f*8.. of the 8-column block i of a 32-deep half
            const unsigned short* brow = xs + (f * 8 + lane % 8) * LDX + (lane / 8) * 8;
#pragma unroll
            for (int hh = 0; hh < BK / 32; ++hh) {
              unsigned bf[4];  // b0, b1 of k-step 2hh, then of k-step 2hh + 1
              ldmatrix_x4(bf, brow + hh * 32);
              mma_bf16(acc[t][f], a[2 * hh], bf[0], bf[1]);
              mma_bf16(acc[t][f], a[2 * hh + 1], bf[2], bf[3]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
      next();
    }

    // Fragment element i of acc[t][f] is row f * 8 + 2 t4 + i % 2 and M index
    // gid + 8 (i / 2) of octet c: the gate (i < 2) and the up value (i >= 2)
    // of column 8 c + gid of the slice
#pragma unroll
    for (int t = 0; t < MTW; ++t) {
#pragma unroll
      for (int f = 0; f < NFRAG; ++f) {
        if (f < nfrag) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            hs[(f * 8 + 2 * t4 + i) * LDH + (warp + NCW * t) * 8 + gid] =
                __float2bfloat16(silu(acc[t][f][i]) * acc[t][f][2 + i]);
        }
      }
    }
    consumer_sync<NCT>();  // the slice's SiLU products are in shared memory

    // down: stage j holds wd rows [f0, f0 + 64) for output columns [128 j,
    // 128 j + 128); tile m = warp + NCW t is 16 of them, multiplied over the
    // whole slice into a float32 partial
    float* prow = part + ((size_t)p0 * nsl + s) * N;  // row r of the group at prow + r nsl N
    for (int j = 0; j < nkd; ++j) {
      mbar_wait(full0 + 8 * st, ph);
      const unsigned char* ws = ring + st * W_BYTES;
#pragma unroll
      for (int t = 0; t < DMT; ++t) {
        const int m0 = (warp + NCW * t) * 16;
        if (j * BN + m0 < N) {
          const unsigned char* arow = ws + (m0 / TMA_BOX) * BOX_BYTES + krow * TMA_BOX * 2 +
                                      (((m0 % TMA_BOX) / 8 + mh) ^ (lane % 8)) * 16;
          unsigned a[FS / 16][4];
#pragma unroll
          for (int kk = 0; kk < FS / 16; ++kk) ldmatrix_x4_trans(a[kk], arow + kk * 16 * TMA_BOX * 2);
#pragma unroll
          for (int f = 0; f < NFRAG; ++f) {
            if (f < nfrag) {
              float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              const __nv_bfloat16* brow = hs + (f * 8 + lane % 8) * LDH + (lane / 8) * 8;
#pragma unroll
              for (int hh = 0; hh < FS / 32; ++hh) {
                unsigned bf[4];
                ldmatrix_x4(bf, brow + hh * 32);
                mma_bf16(d, a[2 * hh], bf[0], bf[1]);
                mma_bf16(d, a[2 * hh + 1], bf[2], bf[3]);
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = f * 8 + 2 * t4 + i % 2;
                if (r < n) prow[(size_t)r * nsl * N + j * BN + m0 + gid + 8 * (i / 2)] = d[i];
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
      next();
    }

    // the group's ticket; the last unit's block sums the partials in slice
    // order, writes the bf16 rows and resets the ticket
    consumer_sync<NCT>();  // every consumer's partial is written ...
    if (tid == 0) {
      __threadfence();  // ... and visible (the fence is cumulative over the barrier)
      s_last = atomicAdd(&tickets[q], 1) == nsl - 1;
    }
    consumer_sync<NCT>();
    if (s_last) {
      __threadfence();
      const int n4 = N / 4;
      for (int idx = tid; idx < n * n4; idx += NCT) {
        const int r = idx / n4, c4 = idx % n4;
        const float4* src = reinterpret_cast<const float4*>(part + (size_t)(p0 + r) * nsl * N) + c4;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s0 = 0; s0 < nsl; s0 += 8) {  // eight loads in flight, summed in order
          float4 v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = s0 + k < nsl ? __ldcg(src + (size_t)(s0 + k) * n4) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            sum.x += v[k].x;
            sum.y += v[k].y;
            sum.z += v[k].z;
            sum.w += v[k].w;
          }
        }
        __nv_bfloat162* dst =
            reinterpret_cast<__nv_bfloat162*>(out + (size_t)s_rows[p0 + r] * N + c4 * 4);
        dst[0] = __floats2bfloat162_rn(sum.x, sum.y);
        dst[1] = __floats2bfloat162_rn(sum.z, sum.w);
      }
      if (tid == 0) tickets[q] = 0;  // every unit of this launch has taken its ticket
    }
  }
}

// The dynamic shared memory of one of the CTAS blocks that share an SM:
// an equal share of the SM's, less each block's static shared memory and
// the 1 KB the card reserves per block, within the most a block may opt
// into; the limit is raised to it.
template <class Sh>
cudaError_t init_shape(int per_sm, int optin, int* smem) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fused_swiglu_gemv_kernel<Sh>);
  if (err != cudaSuccess) return err;
  const int share = per_sm / Sh::CTAS - (int)fa.sharedSizeBytes - 1024;
  *smem = share < optin - (int)fa.sharedSizeBytes ? share : optin - (int)fa.sharedSizeBytes;
  return cudaFuncSetAttribute(fused_swiglu_gemv_kernel<Sh>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

template <class Sh>
int launch(const CUtensorMap* gm, const CUtensorMap* um, const CUtensorMap* dm, const void* tok,
           long long tok_stride, const int* expert_ids, const int* valid, float* part,
           int* tickets, void* out, int S, int K, int F, int N, int E, int n_sm, int smem,
           cudaStream_t stream) {
  fused_swiglu_gemv_kernel<Sh><<<n_sm * Sh::CTAS, Sh::NT, smem, stream>>>(
      *gm, *um, *dm, static_cast<const __nv_bfloat16*>(tok), tok_stride, expert_ids, valid, part,
      tickets, static_cast<__nv_bfloat16*>(out), S, K, F, N, E, smem);
  return (int)cudaGetLastError();
}

}  // namespace

// Once per device, before the first launch: raises both launch shapes'
// dynamic shared-memory limits, finds the driver's tensor-map encoder, and
// returns the SM count and the larger (DEEP) block's shared memory.
extern "C" int fused_swiglu_gemv_init(int* n_sm, int* max_smem) {
  int dev = 0, per_sm = 0, optin = 0;
  cudaError_t err = find_tensor_map_encoder();
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = init_shape<Deep>(per_sm, optin, &g_smem[0]);
  if (err == cudaSuccess) err = init_shape<Wide>(per_sm, optin, &g_smem[1]);
  *max_smem = g_smem[0];
  return (int)err;
}

// What a launch over S rows of E experts needs from the caller: float32
// output partials of the live rows' slices (S x F / 64 x N), int32 tickets
// (one per row group, at most one per row) and the dynamic shared memory
// of the lists and two stages of the widest row groups (above the DEEP
// block's, the wrapper refuses S).
extern "C" void fused_swiglu_gemv_scratch(int S, int E, int F, int N, long long* part_floats,
                                          long long* n_tickets, int* smem) {
  *part_floats = (long long)S * (F / FS) * N;
  *n_tickets = S;
  *smem = min_smem(S, E);
}

// Launches on `stream`; allocates nothing on the card; returns
// cudaGetLastError().  The shape is WIDE when the units can number four
// per SM (row groups at most min(S, E + S / 32), each F / 64 units) and
// its blocks hold the lists, else DEEP.  Caller guarantees: bf16 tokens
// (S, K) with unit stride along K and a row stride and base 16-byte
// aligned, contiguous bf16 wg and wu (E, K, F), wd (E, F, N) and out (S,
// N) with 16-byte aligned bases, K, F, N positive multiples of 64, int32
// expert_ids in [0, E) on live rows and valid, scratch as
// fused_swiglu_gemv_scratch says (the tickets zero before the first
// launch; each launch leaves them at zero), n_sm from
// fused_swiglu_gemv_init, and that init on this device.
extern "C" int fused_swiglu_gemv(const void* tok, long long tok_stride, const void* wg,
                                 const void* wu, const void* wd, const int* expert_ids,
                                 const int* valid, float* part, int* tickets, void* out, int S,
                                 int K, int F, int N, int E, int n_sm, void* stream) {
  if (K <= 0 || F <= 0 || N <= 0 || K % BK || F % FS || N % TMA_BOX || E < 1 || n_sm < 1)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  if (min_smem(S, E) > g_smem[0]) return (int)cudaErrorInvalidValue;
  const CUtensorMap* gm = weight_map(wg, (long long)E * K, F);
  const CUtensorMap* um = weight_map(wu, (long long)E * K, F);
  const CUtensorMap* dm = weight_map(wd, (long long)E * F, N);
  if (gm == nullptr || um == nullptr || dm == nullptr) return (int)cudaErrorInvalidValue;
  const long long most_units = (long long)(S < E + S / RG ? S : E + S / RG) * (F / FS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = most_units >= (long long)Wide::CTAS * n_sm && min_smem(S, E) <= g_smem[1];
  return wide ? launch<Wide>(gm, um, dm, tok, tok_stride, expert_ids, valid, part, tickets, out, S,
                             K, F, N, E, n_sm, g_smem[1], st)
              : launch<Deep>(gm, um, dm, tok, tok_stride, expert_ids, valid, part, tickets, out, S,
                             K, F, N, E, n_sm, g_smem[0], st);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
