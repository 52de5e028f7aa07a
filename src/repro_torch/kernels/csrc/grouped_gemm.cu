// Ragged grouped matmul: one call of the three-call (unfused) head path of
// the sieve dual path over the capacity slab (grouped_gemm), and the same
// function over the bm-aligned ragged layout (gmm_ragged), both through one
// main loop.
//
// Replaces the TPU kernel repro/kernels/grouped_gemm.py:85 grouped_gemm
// (pallas_call at :120), through its wrappers repro/kernels/ops.py:96
// gmm_capacity and ops.py:130 gmm_ragged.
//   Capacity slab (G, C, K): per group g with weight row e = rhs_of_group[g]
//   (identity when null),
//     out[g, r] = x[g, r] . rhs[e]   for rows r < group_sizes[g]
//     out[g, r] = 0                  for the other rows.
//   Ragged layout (M, K): group g owns rows [start_g, start_g +
//   round_up(size_g, bm)) of lhs, start_g the sum of the earlier groups'
//   spans; for its rows
//     out[r] = lhs[r] . rhs[g]       for the first size_g rows of the span
//     out[r] = 0                     for the span's padding rows.
//   As on the TPU, bm-row tile i belongs to the first group whose
//   cumulative tile count passes i (clamped to the last group), so rows past
//   the spans' sum are zeros; sizes below zero count as zero.
// Both accumulate in float32 and round to bf16.
//
// What bounds it on an H100: bytes.  A live group needs its expert's K x N
// bf16 weights (3.1 MB for a qwen3-30b gate/up/down matrix) for 2 flops
// per weight and live row; a capacity of 8 (decode) or 40 (prefill) rows
// stays far below the card's ~295 flops per byte.  The decode gate call
// streams 40.9 MB (13 live groups): 12.2 us at 3.35 TB/s.
//
// The two layouts differ only in where a group's rows live and which
// weight row it takes (the kernel's RAGGED template parameter): capacity
// group g starts at slab row g C and takes rhs_of_group[g]; ragged group g
// starts at its span's first row, found on the device from the bm-tile
// prefix sum of the sizes (no host sync, so a caller may capture either in
// a graph), and takes weight row g.  Everything below is shared but the
// launch shape (Shape): the capacity layout runs one block per SM with
// 64-row tiles, the ragged layout two blocks per SM with 16- or 32-row
// tiles, which stream more bytes per SM at a decode step's gate call.
//
// Design.  A persistent grid.  Each block reads the group sizes and builds
// the list of live groups in shared memory.  The work is a sequence of
// (output tile, 64-deep K-chunk) pairs, a tile being (live group, row
// block of at most RB rows, 128-column tile).  With fewer tiles than
// twice the blocks (a decode step: 78 tiles at the gate call) the blocks
// split it in the stream-K manner: every block takes an equal contiguous
// run, so 13 live groups spread over every SM as evenly as 128 do, and a
// run holds at most two partial tiles (its first and its last).  With more
// (a prefill) block b takes whole tiles b, b + grid, ..., so no tile is
// shared and the blocks' streams interleave over the weights (contiguous
// runs there left the slowest blocks behind the median: 0.232 against
// 0.198 ms at the prefill down call, H100 80GB HBM3 at 700 W).  Dead
// groups and rows at or past a group's size are written as zeros by the
// same blocks and no weight is read for them; rows at or past C are
// neither read nor written.
//
// The block is warp-specialised.  One producer warp streams each chunk
// into a ring of stages in dynamic shared memory (8 for the capacity
// layout, 4 in each of the ragged layout's two blocks): the weights as TMA
// boxes of 64 rows x 64 columns (128-byte swizzled; a 2D tensor map of
// rhs, encoded once per weight tensor on the host), the slab rows of the
// live fragments by cp.async.  The TMA's bytes and the copies' arrivals
// (cp.async.mbarrier.arrive.noinc) complete the stage's "full" mbarrier;
// eight consumer warps release a stage on its "empty" mbarrier once they
// have multiplied it.  So up to 128 KB of weights stay in flight per SM,
// continuously across tiles and through the consumers' epilogues.  (Warps
// that both issued cp.async copies and multiplied them streamed slower
// than the parent's kernel: the issue stalls under back-pressure, and
// nothing was issued while they multiplied.  Split-K over fixed K-slices
// gave each block several partial tiles, and a fence taken mid-stream
// waits behind the whole card's stream.)
//
// The product swaps A and B: the 128 weight columns of a tile are the M
// side of mma.sync m16n8k16 (one 16-column slice per consumer warp, loaded
// from the swizzled K x N boxes by ldmatrix.trans, the stage's four
// k-steps at once) and the slab rows are its n = 8 side, one fragment per
// 8 live rows (1 at decode, 5 at a 40-row prefill); fragment rows past the
// live count are zero-filled and never read from the slab.  A tile that
// one block covers whole is written at once.  A tile shared by several
// blocks gets a float32 partial from each, written at the end of the
// block's run (the first tile's accumulator waits in registers, so no
// fence stalls the consumers mid-stream) under one fence and a ticket per
// tile; the consumer warps of the block that takes a tile's last ticket
// sum its partials in block order, which is K order (the same bits
// whichever block finishes last), write the bf16 tile and reset the ticket
// for the next launch.  The kernel allocates nothing on the card:
// partials and tickets come from the wrapper; the dynamic shared-memory
// limit is raised once, by grouped_gemm_init, never at launch.
//
// Tolerance: tensor-core tiles sum in another order than the plain
// version's float32 einsum; after the bf16 rounding of the output the
// kernel agrees with it within the repo's bf16 tolerance (rtol = atol =
// 2e-2, tests/test_fused_swiglu.py:50).

#include "sm90.cuh"

namespace {

constexpr int BN = 128;          // weight columns per tile: the mma's M side
constexpr int BK = 64;           // contraction depth per stage
// The launch shape of each layout: blocks per SM and ring depth.  The
// capacity layout's is the one it was tuned with (one block, 64-row tiles,
// 8 stages).  The ragged layout runs two blocks per SM, 4 stages each, and
// tiles of 16 rows where its spans are at most 16 rows aligned (a decode
// step's bm 8), else 32: two blocks streamed more bytes per SM at the
// decode gate call than one, and where groups hold a hundred rows or more
// (bm 128) a 16-row tile re-reads a group's weights for every 16 rows.
template <bool RAGGED>
struct Shape {
  static constexpr int CTAS = RAGGED ? 2 : 1, NSTAGE = RAGGED ? 4 : 8;
};
constexpr int CAPACITY_RB = 64;     // slab rows per tile at most: the mma's N side
constexpr int NCW = BN / 16;     // consumer warps, one 16-column slice each
constexpr int NCT = NCW * 32;    // consumer threads
constexpr int NT = NCT + 32;     // and one producer warp
constexpr int HALF = 64;         // weight columns per TMA box: 128 B, the swizzle span
constexpr int W_BYTES = BK * BN * 2;  // a stage's weights: two 64 x 64 boxes, 128-byte swizzled
constexpr int LDX = BK + 8;      // slab row stride in bf16: 144 B, conflict-free fragment loads
static_assert(BK == TMA_BOX && HALF == TMA_BOX, "a stage's weights are two square TMA boxes");

// the ragged layout's rows per tile for bm-aligned spans
inline int ragged_rb(int bm) { return bm <= 16 ? 16 : 32; }

// slab rows a stage holds: C rounded up to whole fragments, at most RB
template <int RB>
__host__ __device__ inline int x_rows(int C) {
  const int rows = (C + 7) / 8 * 8;
  return rows < RB ? rows : RB;
}
// a stage: the weight boxes (1024-byte aligned for the swizzle), then the slab rows
template <int RB>
__host__ __device__ inline int stage_bytes(int C) {
  return (W_BYTES + x_rows<RB>(C) * LDX * 2 + 1023) / 1024 * 1024;
}
// alignment slack, the ring, a full and an empty mbarrier per stage, the
// lists and two tiles' contributors (K / BK each at most), and for the
// ragged layout each group's first row
template <bool RAGGED, int RB>
__host__ __device__ inline int smem_bytes(int G, int C, int K) {
  constexpr int NSTAGE = Shape<RAGGED>::NSTAGE;
  return 1024 + NSTAGE * stage_bytes<RB>(C) + 2 * NSTAGE * 8 +
         (4 * G + 1 + 2 * (K / BK) + (RAGGED ? G : 0)) * 4;
}
// output tiles at most: capacity, G x ceil(C / RB) row blocks; ragged, a
// live group's rows are contiguous, so its row blocks number at most its
// rows / RB + 1, over at most min(G, C) live groups
inline long long max_tiles(int G, int C, int N, bool ragged, int RB) {
  const long long blocks = ragged ? C / RB + 1 + (G < C ? G : C) : (long long)G * ((C + RB - 1) / RB);
  return blocks * ((N + BN - 1) / BN);
}

// a barrier of the consumer warps alone (the producer never waits on it)
__device__ inline void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory"); }

// An output tile: (live group, row block, column tile); its first row is
// row xrow of x and out.
struct Tile {
  int g, e, xrow, live, n0, ncols;
};

struct Lists {
  const int* size;    // (G,) live rows per group
  const int* start;   // (G,) ragged: the first row of each group's span; capacity: null
  const int* live;    // (n_live,) live groups in order
  const int* expert;  // (n_live,) their weight rows
  const int* tstart;  // (n_live + 1,) first tile of each live group
  int n_live, ntn, N, C;
};

template <int RB>
__device__ inline Tile tile_of(int t, const Lists& L) {
  Tile w;
  int lo = 0, hi = L.n_live - 1;  // the live group holding the tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (L.tstart[mid] <= t) lo = mid;
    else hi = mid - 1;
  }
  const int rem = t - L.tstart[lo];
  w.g = L.live[lo];
  w.e = L.expert[lo];
  const int row0 = rem / L.ntn * RB;
  w.xrow = (L.start ? L.start[w.g] : w.g * L.C) + row0;
  w.live = min(RB, L.size[w.g] - row0);
  w.n0 = rem % L.ntn * BN;
  w.ncols = min(BN, L.N - w.n0);
  return w;
}

// The stream-K split of `total` chunks over `nblk` blocks: block b takes
// [first_chunk(b), first_chunk(b + 1)), empty when blocks outnumber chunks.
// total * nblk < 2^32 (the launcher checks), so 32-bit arithmetic serves.
struct Split {
  unsigned total, nblk;
  __device__ int first_chunk(int b) const { return (int)(total * b / nblk); }
  // the block taking chunk c: the last block whose run starts at or before c
  __device__ int owner(int c) const { return (int)(((c + 1) * nblk - 1) / total); }
  // the chunk after block owner(c)'s run: the next contributor's first
  __device__ int next(int c) const { return first_chunk(owner(c) + 1); }
  // the partial slot of block owner(c)'s part of the tile starting at chunk tc0:
  // 2b for the block's first tile, 2b + 1 for its last
  __device__ int slot(int c, int tc0) const {
    const int bb = owner(c);
    return 2 * bb + (first_chunk(bb) < tc0 ? 1 : 0);
  }
};

// The layouts (the kernel's template parameter RAGGED).  Capacity (false):
// G groups of C slab rows, group g at row g C with weight row
// rhs_of_group[g] (g when null), its size clamped to [0, C].  Ragged
// (true): G groups over M = C rows of bm-aligned spans, group g at the
// first row of its span with weight row g, its size clamped to the rows
// below M.
constexpr bool CAPACITY = false, RAGGED_LAYOUT = true;

template <bool RAGGED, int RB>
__global__ void __launch_bounds__(NT, Shape<RAGGED>::CTAS)
grouped_gemm_kernel(const __grid_constant__ CUtensorMap wmap,  // rhs (E, K, N) as (E * K, N)
                    const __nv_bfloat16* __restrict__ x,       // (G, C, K), or ragged (C = M, K)
                    const int* __restrict__ group_sizes,       // (G,)
                    const int* __restrict__ rhs_of_group,   // (G,) or null
                    __nv_bfloat16* __restrict__ out,        // (G, C, N), or ragged (C = M, N)
                    float* __restrict__ part,               // (2 * grid, x_rows(C), BN) shared-tile parts
                    int* __restrict__ tickets,              // (tiles,), zero between launches
                    int G, int C, int K, int N, int bm) {
  constexpr bool ragged = RAGGED;
  constexpr int NFRAG = RB / 8, NSTAGE = Shape<RAGGED>::NSTAGE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzled boxes need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  __shared__ int s_nlive, s_nparts[2], s_last[2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nblk = gridDim.x;
  const int ntn = (N + BN - 1) / BN, nk = K / BK;
  const int xr = x_rows<RB>(C), sb = stage_bytes<RB>(C);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + NSTAGE * sb);
  const unsigned full0 = smem_addr(bars), empty0 = smem_addr(bars + NSTAGE);
  int* s_size = reinterpret_cast<int*>(bars + 2 * NSTAGE);
  int* s_live = s_size + G;
  int* s_exp = s_live + G;
  int* s_tstart = s_exp + G;
  int* s_slot = s_tstart + G + 1;  // partial slots of two tiles' contributors, in K order
  int* s_start = s_slot + 2 * nk;  // ragged: each group's first row

  if (tid == NCT)
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&wmap))
                 : "memory");
  // capacity: the sizes clamped to [0, C]; ragged: the raw sizes, clamped below
  for (int g = tid; g < G; g += NT) s_size[g] = ragged ? group_sizes[g] : max(0, min(group_sizes[g], C));
  if (tid == 0) {
    for (int st = 0; st < NSTAGE; ++st) {
      mbar_init(full0 + 8 * st, 33);     // the TMA arrive (with its bytes), and one per
                                         // producer lane as its slab copies land
      mbar_init(empty0 + 8 * st, NCW);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (ragged) __syncthreads();
  if (ragged && warp == 0) {  // each group's span from the bm-tile prefix sum, 32 groups at a time
    long long tiles = 0;  // bm tiles before the chunk
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      const int sz = g < G ? max(s_size[g], 0) : 0;
      const long long nt = (sz + bm - 1) / bm;
      long long incl = nt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const long long row = (tiles + incl - nt) * bm;
      if (g < G) {
        s_start[g] = (int)min(row, (long long)C);
        s_size[g] = (int)max(0LL, min((long long)sz, (long long)C - row));
      }
      tiles += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();
  if (warp == 0) {  // live groups in order, and the first tile of each
    int base = 0, tbase = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      const int sz = g < G ? s_size[g] : 0;
      const int nt = sz > 0 ? (sz + RB - 1) / RB * ntn : 0;
      const unsigned mask = __ballot_sync(0xffffffffu, sz > 0);
      int incl = nt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (sz > 0) {
        const int pos = base + __popc(mask & ((1u << lane) - 1u));
        s_live[pos] = g;
        s_exp[pos] = !ragged && rhs_of_group ? rhs_of_group[g] : g;
        s_tstart[pos] = tbase + incl - nt;
      }
      base += __popc(mask);
      tbase += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      s_nlive = base;
      s_tstart[base] = tbase;
    }
  }
  __syncthreads();  // the last barrier of the whole block: the warps part here

  Lists L;
  L.size = s_size;
  L.start = ragged ? s_start : nullptr;
  L.live = s_live;
  L.expert = s_exp;
  L.tstart = s_tstart;
  L.n_live = s_nlive;
  L.ntn = ntn;
  L.N = N;
  L.C = C;
  const Split sk{(unsigned)(s_tstart[L.n_live] * nk), (unsigned)nblk};  // (tile, K-chunk) pairs
  const int b = blockIdx.x;
  // Tiles at least twice the blocks (a prefill): whole tiles round-robin,
  // block b taking tiles b, b + grid, ..., so no tile is shared and the
  // blocks' streams interleave over the weights; fewer: the stream-K split.
  const int n_tiles = s_tstart[L.n_live];
  const bool whole_tiles = n_tiles >= 2 * nblk;
  const int c_lo = whole_tiles ? 0 : sk.first_chunk(b);
  const int J = whole_tiles ? (b < n_tiles ? (n_tiles - b + nblk - 1) / nblk : 0) * nk
                            : sk.first_chunk(b + 1) - c_lo;
  // chunk j of this block's run: its tile and K-chunk
  auto chunk_of = [&](int j, int& t, int& kc) {
    if (whole_tiles) {
      t = b + j / nk * nblk;
      kc = j % nk;
    } else {
      t = (c_lo + j) / nk;
      kc = (c_lo + j) % nk;
    }
  };

  if (warp == NCW) {  // producer: chunk j of this block's stream into stage j % NSTAGE
    Tile w;
    for (int j = 0; j < J; ++j) {
      const int st = j % NSTAGE;
      int t, kc;
      chunk_of(j, t, kc);
      if (j >= NSTAGE) mbar_wait(empty0 + 8 * st, (j / NSTAGE - 1) & 1);  // fill j - NSTAGE consumed
      if (j == 0 || kc == 0) w = tile_of<RB>(t, L);
      const int k0 = kc * BK;
      const unsigned full = full0 + 8 * st;
      const unsigned ws = smem_addr(smem + st * sb), xs = ws + W_BYTES;
      if (lane == 0) {  // the weights: one box of 64 rows x 64 columns per half tile
        const int halves = w.ncols / HALF;
        mbar_arrive_expect_tx(full, halves * BK * HALF * 2);
        for (int h = 0; h < halves; ++h)
          tma_load_2d(ws + h * BK * HALF * 2, &wmap, w.n0 + h * HALF, w.e * K + k0, full);
      }
      // the slab rows of the live fragments: rows from the live count up are
      // zero-filled, not read
      const __nv_bfloat16* xsrc = x + (size_t)w.xrow * K + k0;
      for (int i = lane; i < (w.live + 7) / 8 * 8 * (BK / 8); i += 32) {
        const int r = i / (BK / 8), cc = i % (BK / 8);
        const bool live = r < w.live;
        cp_async16(xs + (r * LDX + cc * 8) * 2, xsrc + (size_t)(live ? r : 0) * K + cc * 8, live);
      }
      cp_async_arrive(full);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers.  While the first chunks are in flight: zeros on every row
  // outside its group's live rows (dead groups whole; ragged: the spans'
  // padding and the rows past them), one warp per row.
  auto dead_row = [&](int row) {
    if (!ragged) return row % C >= s_size[row / C];
    int lo = 0, hi = G - 1;  // the group whose span holds the row: the last starting at or before it
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (s_start[mid] <= row) lo = mid;
      else hi = mid - 1;
    }
    return row >= s_start[lo] + s_size[lo];
  };
  for (int row = b * NCW + warp; row < (ragged ? C : G * C); row += nblk * NCW) {
    if (dead_row(row)) {
      uint4* dst = reinterpret_cast<uint4*>(out + (size_t)row * N);
      for (int v = lane; v < N / 8; v += 32) dst[v] = make_uint4(0, 0, 0, 0);
    }
  }

  const int m0 = warp * 16, gid = lane / 4, t4 = lane % 4;
  float acc[NFRAG][4], acc_first[NFRAG][4];
#pragma unroll
  for (int f = 0; f < NFRAG; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.0f;
  Tile w_first, tws[2];
  int t_first = -1, tts[2], n_out = 0;

  // At the end of the run: this block's float32 parts of the tiles it
  // shares with other blocks (its last tile, and its first when that was
  // kept), each written to its slot (2b for the block's first tile, 2b + 1
  // for its last), then one fence and a ticket per tile; the block with a
  // tile's last ticket sums the parts in K order, writes the bf16 tile and
  // resets the ticket.
  auto write_part = [&](const float (&a)[NFRAG][4], const Tile& tw, int tt) {
    const int nfr = (tw.live + 7) / 8;
    float* slot = part + (size_t)(2 * b + (tt == c_lo / nk ? 0 : 1)) * xr * BN;
    if (m0 < tw.ncols) {
#pragma unroll
      for (int f = 0; f < NFRAG; ++f) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = f * 8 + 2 * t4 + i % 2;
          if (f < nfr && r < tw.live) slot[r * BN + m0 + gid + 8 * (i / 2)] = a[f][i];
        }
      }
    }
  };
  auto publish = [&](int n_tiles_out, const Tile* tws, const int* tts) {
    consumer_sync();  // every consumer's parts are written ...
    if (tid == 0) {
      __threadfence();  // ... and visible (the fence is cumulative over the barrier)
      for (int q = 0; q < n_tiles_out; ++q) {
        const int tc0 = tts[q] * nk;
        int* slots = s_slot + q * nk;
        int n = 0;  // the blocks whose runs meet the tile, in K order
        for (int cc = tc0; cc < tc0 + nk; cc = sk.next(cc)) slots[n++] = sk.slot(cc, tc0);
        s_nparts[q] = n;
        s_last[q] = atomicAdd(&tickets[tts[q]], 1) == n - 1;
      }
    }
    consumer_sync();
    for (int q = 0; q < n_tiles_out; ++q) {
      if (!s_last[q]) continue;  // another block finishes this tile
      __threadfence();
      const Tile& tw = tws[q];
      const int* slots = s_slot + q * nk;
      const int n_parts = s_nparts[q];
      for (int i = tid; i < tw.live * tw.ncols; i += NCT) {
        const int r = i / tw.ncols, col = i % tw.ncols;
        float sum = 0.0f;
        for (int k0 = 0; k0 < n_parts; k0 += 8) {  // eight loads in flight, summed in order
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = k0 + k < n_parts ? __ldcg(part + ((size_t)slots[k0 + k] * xr + r) * BN + col)
                                    : 0.0f;
#pragma unroll
          for (int k = 0; k < 8; ++k) sum += v[k];
        }
        out[((size_t)tw.xrow + r) * N + tw.n0 + col] = __float2bfloat16(sum);
      }
      if (tid == 0) tickets[tts[q]] = 0;  // every part of this launch has taken its ticket
    }
  };
  Tile w;
  for (int j = 0; j < J; ++j) {
    const int st = j % NSTAGE;
    int t, kc;
    chunk_of(j, t, kc);
    if (j == 0 || kc == 0) w = tile_of<RB>(t, L);
    const int nfrag = (w.live + 7) / 8;
    mbar_wait(full0 + 8 * st, (j / NSTAGE) & 1);  // chunk j has landed
    if (m0 < w.ncols) {
      const unsigned char* ws = smem + st * sb;
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(ws + W_BYTES);
      // ldmatrix rows: lanes 8i..8i+7 address 8x8 tile i = (k half i / 2,
      // column half i % 2); in a 128-byte swizzled box the 16-byte chunk of
      // row k sits at chunk ^ (k % 8), and k % 8 = lane % 8 here
      const unsigned char* arow = ws + (m0 / HALF) * BK * HALF * 2 +
                                  ((lane / 16) * 8 + lane % 8) * HALF * 2 +
                                  ((((m0 % HALF) / 8 + lane / 8 % 2) ^ (lane % 8)) * 16);
      unsigned a[BK / 16][4];  // the stage's A fragments, all loads in flight at once
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) ldmatrix_x4_trans(a[kk], arow + kk * 16 * HALF * 2);
#pragma unroll
      for (int f = 0; f < NFRAG; ++f) {
        if (f < nfrag) {
          // lanes 8i..8i+7 address rows f*8.. of the 8-column block i of a 32-deep half
          const unsigned short* brow = xs + (f * 8 + lane % 8) * LDX + (lane / 8) * 8;
#pragma unroll
          for (int h = 0; h < BK / 32; ++h) {
            unsigned bf[4];  // b0, b1 of k-step 2h, then of k-step 2h + 1
            ldmatrix_x4(bf, brow + h * 32);
            mma_bf16(acc[f], a[2 * h], bf[0], bf[1]);
            mma_bf16(acc[f], a[2 * h + 1], bf[2], bf[3]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
    if (kc != nk - 1 && j != J - 1) continue;

    // End of this block's part of tile t.  Fragment element i of acc[f] is
    // row f * 8 + 2 * t4 + i % 2, column m0 + gid + 8 * (i / 2) of the tile.
    const int tc0 = t * nk;
    if (whole_tiles || (c_lo <= tc0 && c_lo + J >= tc0 + nk)) {  // the whole tile is this block's
      if (m0 < w.ncols) {
#pragma unroll
        for (int f = 0; f < NFRAG; ++f) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = f * 8 + 2 * t4 + i % 2;
            if (f < nfrag && r < w.live)
              out[((size_t)w.xrow + r) * N + w.n0 + m0 + gid + 8 * (i / 2)] =
                  __float2bfloat16(acc[f][i]);
          }
        }
      }
    } else if (j != J - 1) {
      // the block's first tile, shared with the block before: kept until the
      // end of the run, so no fence stalls the consumers mid-stream
#pragma unroll
      for (int f = 0; f < NFRAG; ++f)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc_first[f][i] = acc[f][i];
      w_first = w;
      t_first = t;
    } else {
      write_part(acc, w, t);
      tws[n_out] = w;
      tts[n_out++] = t;
    }
    if (j == J - 1) {
      if (t_first >= 0) {
        write_part(acc_first, w_first, t_first);
        tws[n_out] = w_first;
        tts[n_out++] = t_first;
      }
      if (n_out > 0) publish(n_out, tws, tts);
    }
#pragma unroll
    for (int f = 0; f < NFRAG; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.0f;
  }
}

template <bool RAGGED, int RB>
cudaError_t set_smem_limit(int optin) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, grouped_gemm_kernel<RAGGED, RB>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grouped_gemm_kernel<RAGGED, RB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  return err;
}

}  // namespace

// Once per device, before the first launch: raises each instance's dynamic
// shared-memory limit to the most a block may opt into, finds the driver's
// tensor-map encoder, and returns the SM count and that limit.
extern "C" int grouped_gemm_init(int* n_sm, int* max_smem) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = find_tensor_map_encoder();
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, grouped_gemm_kernel<CAPACITY, CAPACITY_RB>);
  if (err != cudaSuccess) return (int)err;
  *max_smem = optin - (int)fa.sharedSizeBytes;
  err = set_smem_limit<CAPACITY, CAPACITY_RB>(optin);
  if (err == cudaSuccess) err = set_smem_limit<RAGGED_LAYOUT, 16>(optin);
  if (err == cudaSuccess) err = set_smem_limit<RAGGED_LAYOUT, 32>(optin);
  return (int)err;
}

// What a launch over (G, C, K, N) on `n_blocks` blocks needs from the
// caller: float32 partials (of two tiles per block at most), int32
// tickets (one per tile) and dynamic shared memory.
extern "C" void grouped_gemm_scratch(int G, int C, int K, int N, int n_blocks,
                                     long long* part_floats, long long* n_tickets, int* smem) {
  *part_floats = 2LL * n_blocks * x_rows<CAPACITY_RB>(C) * BN;
  *n_tickets = max_tiles(G, C, N, false, CAPACITY_RB);
  *smem = smem_bytes<CAPACITY, CAPACITY_RB>(G, C, K);
}

// The same for the ragged layout over (M, K) rows of E groups in bm-aligned
// spans on n_sm SMs, and its block count.
extern "C" void gmm_ragged_scratch(int M, int K, int N, int E, int bm, int n_sm,
                                   long long* part_floats, long long* n_tickets, int* smem,
                                   int* n_blocks) {
  const int rb = ragged_rb(bm);
  *n_blocks = n_sm * Shape<RAGGED_LAYOUT>::CTAS;
  *part_floats = 2LL * *n_blocks * (rb == 16 ? x_rows<16>(M) : x_rows<32>(M)) * BN;
  *n_tickets = max_tiles(E, M, N, true, rb);
  *smem = rb == 16 ? smem_bytes<RAGGED_LAYOUT, 16>(E, M, K) : smem_bytes<RAGGED_LAYOUT, 32>(E, M, K);
}

namespace {

template <bool RAGGED, int RB>
int launch(const void* x, const void* rhs, const int* group_sizes, const int* rhs_of_group,
           void* out, float* part, int* tickets, int G, int C, int K, int N, int E, int bm,
           int n_blocks, void* stream) {
  if (K % BK != 0 || N % 64 != 0 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const long long most_chunks = max_tiles(G, C, N, RAGGED, RB) * (K / BK);
  if (most_chunks * n_blocks >= (1LL << 32)) return (int)cudaErrorInvalidValue;  // Split's range
  const long long rows = RAGGED ? C : (long long)G * C;
  if (G == 0 || rows == 0 || N == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 0) return (int)cudaMemsetAsync(out, 0, (size_t)rows * N * 2, st);
  const CUtensorMap* wmap = weight_map(rhs, (long long)E * K, N);
  if (wmap == nullptr) return (int)cudaErrorInvalidValue;
  grouped_gemm_kernel<RAGGED, RB><<<n_blocks, NT, smem_bytes<RAGGED, RB>(G, C, K), st>>>(
      *wmap, static_cast<const __nv_bfloat16*>(x), group_sizes, rhs_of_group,
      static_cast<__nv_bfloat16*>(out), part, tickets, G, C, K, N, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; allocates nothing on the card; returns
// cudaGetLastError().  Caller guarantees: bf16 contiguous x (G, C, K), rhs
// (E, K, N) and out (G, C, N) with 16-byte aligned bases, K % 64 == 0,
// N % 64 == 0, int32 group tables, scratch as grouped_gemm_scratch says,
// and a prior grouped_gemm_init on this device.
extern "C" int grouped_gemm(const void* x, const void* rhs, const int* group_sizes,
                            const int* rhs_of_group, void* out, float* part, int* tickets, int G,
                            int C, int K, int N, int E, int n_blocks, void* stream) {
  return launch<CAPACITY, CAPACITY_RB>(x, rhs, group_sizes, rhs_of_group, out, part, tickets, G, C,
                                       K, N, E, 0, n_blocks, stream);
}

// The ragged layout: lhs (M, K) and out (M, N) rows, group g's span
// round_up(group_sizes[g], bm) rows from the sum of the earlier spans.
// Launches on `stream`; allocates nothing on the card; returns
// cudaGetLastError().  Caller guarantees: bf16 contiguous lhs, rhs (E, K,
// N) and out with 16-byte aligned bases, int32 group_sizes (E,), E >= 1, bm
// a positive multiple of 8 dividing M, K % 64 == 0, N % 64 == 0, scratch as
// gmm_ragged_scratch says (the tickets zero before the first launch; each
// launch leaves them at zero), and a prior grouped_gemm_init on this device.
extern "C" int gmm_ragged(const void* lhs, const void* rhs, const int* group_sizes, void* out,
                          float* part, int* tickets, int M, int K, int N, int E, int bm,
                          int n_sm, void* stream) {
  if (bm < 8 || bm % 8 || M % bm || E < 1) return (int)cudaErrorInvalidValue;
  const int n_blocks = n_sm * Shape<RAGGED_LAYOUT>::CTAS;
  return ragged_rb(bm) == 16
             ? launch<RAGGED_LAYOUT, 16>(lhs, rhs, group_sizes, nullptr, out, part, tickets, E, M, K,
                                         N, E, bm, n_blocks, stream)
             : launch<RAGGED_LAYOUT, 32>(lhs, rhs, group_sizes, nullptr, out, part, tickets, E, M, K,
                                         N, E, bm, n_blocks, stream);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
