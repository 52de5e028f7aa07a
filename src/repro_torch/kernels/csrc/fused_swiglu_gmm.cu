// Head path of the sieve dual path: grouped SwiGLU over the capacity slab.
//
// Replaces the TPU kernel repro/kernels/fused_swiglu.py:133
// fused_swiglu_gmm (pallas_call at :205; wrapper repro/kernels/ops.py:197).
// Per group g with expert e = rhs_of_group[g] (identity when null):
//   out[g, r] = bf16(silu(x[g, r] . wg[e]) * (x[g, r] . wu[e])) . wd[e]
// for rows r < min(group_sizes[g], C), and 0 for the other rows.
// Accumulation is float32; the SiLU product is rounded to bf16 before the
// down product, as the TPU kernel casts it to the input dtype
// (fused_swiglu.py:117).  A dead group reads no weights.
//
// What bounds it on an H100: bytes.  A live group needs its expert's
// 3 x K x F bf16 weights (9.4 MB at qwen3-30b widths) for 2 flops per
// weight and live row; even a full 40-row prefill group stays below the
// card's ~295 flops per byte.  A decode step's head (13 live groups)
// streams 122.7 MB: 37.9 us at 3.35 TB/s.
//
// Design: a persistent grid, one block per SM, in one launch.  Each block
// reads the group sizes and builds the list of live items (a live group's
// block of up to 64 rows; one per group while C <= 64) in shared memory.
// The work is two kinds of unit:
//   - gate/up unit (item, 64-column F slice): h[g, rows, slice] =
//     bf16(silu(x wg[e][:, slice]) * (x wu[e][:, slice])) over the whole K,
//     written to a bf16 buffer h (G, C, F) that the wrapper supplies;
//   - down unit (item, 128-column N tile): out[g, rows, tile] =
//     h[g, rows] . wd[e][:, tile] over the whole F, written as bf16: no
//     float32 partial of the output and no second pass.
// The gate/up work goes to teams of F / 64 blocks (11 teams of 12 at
// qwen3-30b widths): a team chunk is an item's 64 K rows, and member m of a
// team takes F slice m of it, so the members stream the same rows of one
// expert at the same time and together read them whole.  The team chunks
// are split over the teams in the stream-K manner: every team takes an
// equal contiguous run, so the gate/up work ends on every SM at about the
// same time, and a run shares at most two units with its neighbours (its
// first and its last).  Then block b takes down units b, b + grid, ...: the
// N tiles of an item are read together too.  A unit split between teams
// is finished by the block that owns its first chunk, for which it is the
// last unit of its run: its part stays in registers, and the later parts,
// each the first unit of its block's run, are published early in those
// runs (a float32 partial of a few KB, a fence, and a count per warp).  At
// the end of its gate/up run a block waits for the later parts of the unit
// it finishes, sums the parts in K order (the same bits every launch),
// writes the unit's SiLU products, and after one fence adds every unit it
// finished to its item's readiness counter.  A down unit waits on its
// item's counter, not on a grid barrier.  Every block runs its gate/up run
// before its down units and every block is resident, so a block waiting
// for an item or a partial waits only on gate/up work, which waits on
// nothing but partials published before any wait.  Each launch leaves its
// counters at zero: a unit's finisher resets the unit's count, the last
// down unit of an item to pass its wait resets the item's.
// (Whole gate/up units dealt round-robin left the decode head slower than
// the parent's kernel: 24 blocks streamed two units, and the down units of
// their groups waited for them.  Stream-K runs over whole units, each
// block alone, balanced the work but scattered the blocks' concurrent
// reads over many experts' rows, and the stream slowed; the teams keep
// the balance and read whole rows.  Tickets taken at the end of every run,
// with the last block combining, put several round trips through memory
// between the gate/up work and the down units; the fixed finisher needs
// one.  A deeper ring, and L2 prefetches of the down weights at the
// handoff, made the kernel slower.)
//
// The block is warp-specialised.  Producer warp A streams the weights, a
// chunk of 64 K (or F) rows at a time, into a ring of up to 8 stages as
// TMA boxes of 64 x 64 (128-byte swizzled; 2D tensor maps of wg, wu and wd,
// encoded once per weight tensor on the host): for a gate/up unit one box
// of wg and one of wu, for a down unit two boxes of wd.  It waits on
// nothing but the ring, so it runs ahead into a down unit's weights while
// h is still being finished.  Producer warp B copies the chunk's live rows
// by cp.async (x for a gate/up unit, h for a down unit, after the item's
// readiness wait); fragment rows past the live count are zero-filled, not
// read.  The TMA's bytes and B's copies complete the stage's "full"
// mbarrier; eight consumer warps release it on its "empty" mbarrier.  The
// consumers run mma.sync m16n8k16 with the weights on the M side (A
// fragments by ldmatrix.trans from the swizzled boxes) and the live rows
// on n = 8, one fragment per 8 rows: rows are not padded to 16.  In a
// gate/up unit each warp's 16 M rows are 8 columns of wg and the same 8
// columns of wu, so a lane holds the gate and the up value of the same
// (row, column) and forms the SiLU product in registers.  In a down unit
// each warp owns 16 of the 128 columns.  The kernel allocates nothing on
// the card; the dynamic shared-memory limit is raised once, by
// fused_swiglu_gmm_init, never at launch.
//
// Tolerance: tensor-core tiles sum in another order than the plain
// version's float32 einsum, and the SiLU product is rounded to bf16 on
// both sides, so a product that lands on a rounding boundary may round
// the other way; the kernel agrees with its plain version within the
// repo's bf16 tolerance (rtol = atol = 2e-2, tests/test_fused_swiglu.py:50).

#include "sm90.cuh"

namespace {

constexpr int BK = 64;                 // contraction rows per stage (of K, or of F)
constexpr int BF = 64;                 // SiLU columns per gate/up unit
constexpr int BN = 128;                // output columns per down unit
constexpr int BOX = TMA_BOX;           // columns per TMA box: 128 B, the swizzle span
constexpr int BOX_BYTES = BK * BOX * 2;
constexpr int W_BYTES = 2 * BOX_BYTES;  // a stage's weights: two boxes
constexpr int RB = 64;                 // rows per item at most
constexpr int NFRAG = RB / 8;          // n = 8 fragments per item at most
constexpr int MAX_STAGES = 8;          // ring depth where shared memory allows
constexpr int NCW = 8;                 // consumer warps
constexpr int NCT = NCW * 32;          // consumer threads
constexpr int NT = NCT + 64;           // and producer warps A (weights) and B (rows)
constexpr int LDX = BK + 8;            // staged row stride in bf16: 144 B, conflict-free ldmatrix
static_assert(BF == NCW * 8 && BN == NCW * 16, "warp w owns columns 8w.. of a slice, 16w.. of a tile");
static_assert(BK == TMA_BOX, "a stage's weights are two square TMA boxes");

int g_max_smem = 0;  // the dynamic shared memory a block may use, from fused_swiglu_gmm_init

// staged rows per stage: C rounded up to whole fragments, at most RB
__host__ __device__ inline int x_rows(int C) {
  const int rows = (C + 7) / 8 * 8;
  return rows < RB ? rows : RB;
}
// a stage: the weight boxes (1024-byte aligned for the swizzle), then the rows
__host__ __device__ inline int stage_bytes(int C) {
  return (W_BYTES + x_rows(C) * LDX * 2 + 1023) / 1024 * 1024;
}
// beside the ring: alignment slack, a full and an empty mbarrier per stage, the lists
__host__ __device__ inline int fixed_bytes(int G) {
  return 1024 + 2 * MAX_STAGES * 8 + (4 * G + 1) * 4;
}
// ring stages that fit in `smem` bytes (0 when not even one does)
inline int stages_for(int G, int C, int smem) {
  const int n = (smem - fixed_bytes(G)) / stage_bytes(C);
  return n < 0 ? 0 : n < MAX_STAGES ? n : MAX_STAGES;
}

__device__ inline int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Until *p >= target (another block's release).  Traps after about 4e9
// cycles, as mbar_wait does.
__device__ inline void wait_at_least(const int* p, int target) {
  if (ld_acquire(p) >= target) return;
  const long long t0 = clock64();
  while (ld_acquire(p) < target) {
    __nanosleep(32);
    if (clock64() - t0 > 4000000000LL) __trap();
  }
}

// a barrier of the consumer warps alone (the producers never wait on it)
__device__ inline void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory"); }

__device__ inline float silu(float g) { return g / (1.0f + expf(-g)); }

// The shape of a launch and the live lists in shared memory.
struct Work {
  const int* size;    // (G,) rows per group, clamped to [0, C]
  const int* live;    // (n_live,) live groups in order
  const int* expert;  // (n_live,) their weight rows
  const int* istart;  // (n_live + 1,) first item of each live group
  int n_live, N;
  int nf, ntn;        // gate/up units and down units per item
};

// A unit of work: its kind, item and weight columns.
struct Unit {
  bool down;
  int item, g, e, row0, live, c0, ncols;
};

__device__ inline Unit unit_of(bool down, int u, const Work& W) {
  Unit w;
  w.down = down;
  const int per = down ? W.ntn : W.nf;
  w.item = u / per;
  int lo = 0, hi = W.n_live - 1;  // the live group holding the item
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (W.istart[mid] <= w.item) lo = mid;
    else hi = mid - 1;
  }
  w.g = W.live[lo];
  w.e = W.expert[lo];
  w.row0 = (w.item - W.istart[lo]) * RB;
  w.live = min(RB, W.size[w.g] - w.row0);
  w.c0 = u % per * (down ? BN : BF);
  w.ncols = down ? min(BN, W.N - w.c0) : BF;
  return w;
}

// The stream-K split of `total` team chunks over `nblk` teams: team b
// takes [first_chunk(b), first_chunk(b + 1)), empty when teams outnumber
// chunks.  total * nblk < 2^32 (the launcher checks), so 32-bit arithmetic
// serves.
struct Split {
  unsigned total, nblk;
  __device__ int first_chunk(int b) const { return (int)(total * b / nblk); }
  // the team taking chunk c: the last team whose run starts at or before c
  __device__ int owner(int c) const { return (int)(((c + 1) * nblk - 1) / total); }
  // the chunk after team owner(c)'s run: the next contributor's first
  __device__ int next(int c) const { return first_chunk(owner(c) + 1); }
};

__global__ void __launch_bounds__(NT, 1)
fused_swiglu_gmm_kernel(const __grid_constant__ CUtensorMap gmap,  // wg (E, K, F) as (E * K, F)
                        const __grid_constant__ CUtensorMap umap,  // wu (E, K, F) as (E * K, F)
                        const __grid_constant__ CUtensorMap dmap,  // wd (E, F, N) as (E * F, N)
                        const __nv_bfloat16* __restrict__ x,       // (G, C, K)
                        const int* __restrict__ group_sizes,       // (G,)
                        const int* __restrict__ rhs_of_group,      // (G,) or null
                        __nv_bfloat16* __restrict__ h,             // (G, C, F) SiLU products
                        float* __restrict__ part,  // (grid, x_rows(C), 2 * BF) shared units' sums
                        __nv_bfloat16* __restrict__ out,           // (G, C, N)
                        int* __restrict__ counters,  // n_counters(G, C, F), zero between launches
                        int G, int C, int K, int F, int N, int n_stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzled boxes need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  __shared__ int s_nlive;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nblk = gridDim.x, b = blockIdx.x;
  const int sb = stage_bytes(C), xr = x_rows(C);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + n_stages * sb);
  const unsigned full0 = smem_addr(bars), empty0 = smem_addr(bars + MAX_STAGES);
  int* s_size = reinterpret_cast<int*>(bars + 2 * MAX_STAGES);
  int* s_live = s_size + G;
  int* s_exp = s_live + G;
  int* s_istart = s_exp + G;
  const int items_max = G * ((C + RB - 1) / RB);
  int* ready = counters;                 // gate/up units finished, per item
  int* passed = ready + items_max;       // down units past their wait, per item
  int* published = passed + items_max;   // warps' partials published, per gate/up unit

  if (tid == NCT) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&gmap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&umap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<unsigned long long>(&dmap))
                 : "memory");
  }
  for (int g = tid; g < G; g += NT) s_size[g] = max(0, min(group_sizes[g], C));
  if (tid == 0) {
    for (int st = 0; st < n_stages; ++st) {
      mbar_init(full0 + 8 * st, 33);     // warp A's arrive (with its bytes), and one per
                                         // warp B lane as its row copies land
      mbar_init(empty0 + 8 * st, NCW);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {  // live groups in order, and the first item of each
    int base = 0, ibase = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      const int sz = g < G ? s_size[g] : 0;
      const int ni = (sz + RB - 1) / RB;
      const unsigned mask = __ballot_sync(0xffffffffu, sz > 0);
      int incl = ni;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (sz > 0) {
        const int pos = base + __popc(mask & ((1u << lane) - 1u));
        s_live[pos] = g;
        s_exp[pos] = rhs_of_group ? rhs_of_group[g] : g;
        s_istart[pos] = ibase + incl - ni;
      }
      base += __popc(mask);
      ibase += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      s_nlive = base;
      s_istart[base] = ibase;
    }
  }
  __syncthreads();  // the last barrier of the whole block: the warps part here

  Work W;
  W.size = s_size;
  W.live = s_live;
  W.expert = s_exp;
  W.istart = s_istart;
  W.n_live = s_nlive;
  W.N = N;
  W.nf = F / BF;
  W.ntn = (N + BN - 1) / BN;
  const int n_items = s_istart[W.n_live];
  const int nkg = K / BK, nkd = F / BK;  // stages per gate/up unit, per down unit
  // Teams of tw blocks, member m taking F slices m, m + tw, ... (one each
  // while F / 64 <= grid).  A team chunk is (item, slice round, 64-row K
  // chunk); team t takes the stream-K run [c_lo, c_hi) of them, and its
  // members stream the same K rows of one expert at the same time, each its
  // own slice.  Then block b takes down units b, b + grid, ..., so the N
  // tiles of an item are read together too.
  const int tw = min(W.nf, nblk), spm = (W.nf + tw - 1) / tw;
  const int team = b / tw, member = b % tw, n_teams = nblk / tw;
  const Split sk{(unsigned)(n_items * spm * nkg), (unsigned)n_teams};
  const int c_lo = team < n_teams ? sk.first_chunk(team) : 0;
  const int c_hi = team < n_teams ? sk.first_chunk(team + 1) : 0;
  const int n_down = n_items * W.ntn;
  const int ready_target = W.nf;
  // the gate/up unit of team unit tu for this block (-1: none, a ragged last round)
  auto gu_unit = [&](int tu) {
    const int fs = tu % spm * tw + member;
    return fs < W.nf ? tu / spm * W.nf + fs : -1;
  };

  // Walks this block's stream in order, the same for every role: each
  // stage as on_stage(unit, kc, ring slot, its parity, whether it is the
  // slot's first fill); after each unit, or this block's part of it,
  // on_end(unit, u, team unit, kc0, kc1); and on_gu_done() between the
  // gate/up run and the down units.
  auto walk = [&](auto&& on_stage, auto&& on_end, auto&& on_gu_done) {
    int st = 0, ph = 0;
    bool first = true;
    auto step = [&](const Unit& w, int kc) {
      on_stage(w, kc, st, ph, first);
      if (++st == n_stages) {
        st = 0;
        ph ^= 1;
        first = false;
      }
    };
    for (int c = c_lo; c < c_hi;) {
      const int tu = c / nkg, kc0 = c - tu * nkg, kc1 = min(nkg, kc0 + (c_hi - c));
      const int u = gu_unit(tu);
      if (u >= 0) {
        const Unit w = unit_of(false, u, W);
        for (int kc = kc0; kc < kc1; ++kc) step(w, kc);
        on_end(w, u, tu, kc0, kc1);
      }
      c += kc1 - kc0;
    }
    on_gu_done();
    for (int v = b; v < n_down; v += nblk) {
      const Unit w = unit_of(true, v, W);
      for (int kc = 0; kc < nkd; ++kc) step(w, kc);
      on_end(w, v, 0, 0, nkd);
    }
  };
  auto no_end = [](const Unit&, int, int, int, int) {};
  auto nothing = [] {};

  if (warp == NCW) {  // producer A: the weights of each stage
    if (lane == 0)
      walk(
          [&](const Unit& w, int kc, int st, int ph, bool first) {
            if (!first) mbar_wait(empty0 + 8 * st, ph ^ 1);  // the slot's last fill consumed
            const unsigned full = full0 + 8 * st, ws = smem_addr(smem + st * sb);
            if (!w.down) {
              mbar_arrive_expect_tx(full, W_BYTES);
              tma_load_2d(ws, &gmap, w.c0, w.e * K + kc * BK, full);
              tma_load_2d(ws + BOX_BYTES, &umap, w.c0, w.e * K + kc * BK, full);
            } else {
              const int boxes = w.ncols / BOX;
              mbar_arrive_expect_tx(full, boxes * BOX_BYTES);
              for (int i = 0; i < boxes; ++i)
                tma_load_2d(ws + i * BOX_BYTES, &dmap, w.c0 + i * BOX, w.e * F + kc * BK, full);
            }
          },
          no_end, nothing);
    return;
  }

  if (warp == NCW + 1) {  // producer B: the live rows of each stage (x, or h once ready)
    walk(
        [&](const Unit& w, int kc, int st, int ph, bool first) {
          if (!first) mbar_wait(empty0 + 8 * st, ph ^ 1);
          if (w.down && kc == 0) {  // every gate/up unit of the item has written its h columns
            if (lane == 0) {
              wait_at_least(ready + w.item, ready_target);
              // the item's last down unit past its wait leaves both counters at zero
              if (atomicAdd(passed + w.item, 1) == W.ntn - 1) {
                ready[w.item] = 0;
                passed[w.item] = 0;
              }
            }
            __syncwarp();
          }
          const unsigned xs = smem_addr(smem + st * sb) + W_BYTES;
          const int ld = w.down ? F : K;
          const __nv_bfloat16* src = (w.down ? h : x) + ((size_t)w.g * C + w.row0) * ld + kc * BK;
          for (int i = lane; i < (w.live + 7) / 8 * 8 * (BK / 8); i += 32) {
            const int r = i / (BK / 8), cc = i % (BK / 8);
            const bool live = r < w.live;
            cp_async16(xs + (r * LDX + cc * 8) * 2, src + (size_t)(live ? r : 0) * ld + cc * 8, live);
          }
          cp_async_arrive(full0 + 8 * st);
        },
        no_end, nothing);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers.  While the first stages are in flight: zeros on every row at
  // or past its group's size (dead groups whole), one warp per row.
  for (int row = b * NCW + warp; row < G * C; row += nblk * NCW) {
    if (row % C >= s_size[row / C]) {
      uint4* dst = reinterpret_cast<uint4*>(out + (size_t)row * N);
      for (int v = lane; v < N / 8; v += 32) dst[v] = make_uint4(0, 0, 0, 0);
    }
  }

  const int gid = lane / 4, t4 = lane % 4;
  const int m0 = warp * 16;
  float acc[NFRAG][4];
#pragma unroll
  for (int f = 0; f < NFRAG; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.0f;

  // Fragment element i of acc[f] is row f * 8 + 2 * t4 + i % 2 and M index
  // m0 + gid + 8 (i / 2): in a gate/up unit the gate (i < 2) and the up value
  // (i >= 2) of column 8 warp + gid of the slice.  A block's partial slot
  // keeps it at [row][M index].
  auto slot_of = [&](int blk) { return part + (size_t)blk * xr * (2 * BF); };
  // A shared unit is finished by the block that owns its first chunk: that
  // is the block's last unit, its part stays in acc until the end of the run.
  Unit comb;
  int comb_u = -1, comb_uc0 = 0;
  auto silu_to_h = [&](const Unit& w, const float (&a)[NFRAG][4]) {
    __nv_bfloat16* hrow = h + ((size_t)w.g * C + w.row0) * F + w.c0 + warp * 8 + gid;
    const int nfrag = (w.live + 7) / 8;
#pragma unroll
    for (int f = 0; f < NFRAG; ++f) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = f * 8 + 2 * t4 + i;
        if (f < nfrag && r < w.live)
          hrow[(size_t)r * F] = __float2bfloat16(silu(a[f][i]) * a[f][2 + i]);
      }
    }
  };

  walk(
      [&](const Unit& w, int kc, int st, int ph, bool) {
        // ldmatrix rows: lanes 8i..8i+7 address 8x8 tile i = (k half i / 2, M
        // half i % 2); in a 128-byte swizzled box the 16-byte chunk c of row k
        // sits at c ^ (k % 8), and k % 8 = lane % 8 here.  Gate/up: M half 0
        // is columns 8 warp.. of the wg box, M half 1 the same columns of the
        // wu box.  Down: this warp's 16 columns of the 128-column tile.
        const int krow = (lane / 16) * 8 + lane % 8, mh = lane / 8 % 2;
        const int box = w.down ? m0 / BOX : mh;
        const int chunk = w.down ? (m0 % BOX) / 8 + mh : warp;
        const int nfrag = (w.live + 7) / 8;
        mbar_wait(full0 + 8 * st, ph);  // the stage has landed
        if (!w.down || m0 < w.ncols) {
          const unsigned char* ws = smem + st * sb;
          const unsigned short* xs = reinterpret_cast<const unsigned short*>(ws + W_BYTES);
          const unsigned char* arow =
              ws + box * BOX_BYTES + krow * BOX * 2 + ((chunk ^ (lane % 8)) * 16);
          unsigned a[BK / 16][4];  // the stage's A fragments, all loads in flight at once
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) ldmatrix_x4_trans(a[kk], arow + kk * 16 * BOX * 2);
#pragma unroll
          for (int f = 0; f < NFRAG; ++f) {
            if (f < nfrag) {
              // lanes 8i..8i+7 address rows f*8.. of the 8-column block i of a 32-deep half
              const unsigned short* brow = xs + (f * 8 + lane % 8) * LDX + (lane / 8) * 8;
#pragma unroll
              for (int hh = 0; hh < BK / 32; ++hh) {
                unsigned bf[4];  // b0, b1 of k-step 2hh, then of k-step 2hh + 1
                ldmatrix_x4(bf, brow + hh * 32);
                mma_bf16(acc[f], a[2 * hh], bf[0], bf[1]);
                mma_bf16(acc[f], a[2 * hh + 1], bf[2], bf[3]);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
      },
      [&](const Unit& w, int u, int tu, int kc0, int kc1) {
        const int nfrag = (w.live + 7) / 8;
        if (w.down) {  // the whole F: the output tile, as bf16
          if (m0 < w.ncols) {
#pragma unroll
            for (int f = 0; f < NFRAG; ++f) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = f * 8 + 2 * t4 + i % 2;
                if (f < nfrag && r < w.live)
                  out[((size_t)w.g * C + w.row0 + r) * N + w.c0 + m0 + gid + 8 * (i / 2)] =
                      __float2bfloat16(acc[f][i]);
              }
            }
          }
        } else if (kc0 == 0 && kc1 == nkg) {  // a whole gate/up unit: its SiLU products
          silu_to_h(w, acc);
        } else if (kc0 == 0) {  // the first part of a shared unit: this block finishes it
          comb = w;
          comb_u = u;
          comb_uc0 = tu * nkg;
          return;  // acc is kept for on_gu_done
        } else {  // a later part: published now, early in this block's run
          float* slot = slot_of(b);
#pragma unroll
          for (int f = 0; f < NFRAG; ++f) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = f * 8 + 2 * t4 + i % 2;
              if (f < nfrag && r < w.live) slot[r * 2 * BF + m0 + gid + 8 * (i / 2)] = acc[f][i];
            }
          }
          __threadfence();  // this lane's partial is visible before the warp's count
          __syncwarp();
          if (lane == 0) atomicAdd(published + u, 1);
        }
#pragma unroll
        for (int f = 0; f < NFRAG; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.0f;
      },
      [&] {
        // The end of this block's gate/up run.  If its last unit is shared,
        // the later parts' blocks published their partials early in their
        // runs: wait for them, sum the parts in K order (this block's
        // first; the same bits every launch), write the unit's SiLU
        // products and reset its count.  Then one fence for every h column
        // this block wrote, and the readiness counts of the units it
        // finished.
        if (comb_u >= 0) {
          const int uc1 = comb_uc0 + nkg;
          int n = 0;  // the later parts, one per team whose run meets the unit
          for (int cc = sk.next(comb_uc0); cc < uc1; cc = sk.next(cc)) ++n;
          if (tid == 0) {
            wait_at_least(published + comb_u, n * NCW);
            published[comb_u] = 0;  // every part of this launch is published
          }
          consumer_sync();
          const int nfrag = (comb.live + 7) / 8;
          for (int cc = sk.next(comb_uc0); cc < uc1; cc = sk.next(cc)) {  // in K order
            const float* slot = slot_of(sk.owner(cc) * tw + member);
#pragma unroll
            for (int f = 0; f < NFRAG; ++f) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = f * 8 + 2 * t4 + i % 2;
                if (f < nfrag && r < comb.live)
                  acc[f][i] += __ldcg(slot + r * 2 * BF + m0 + gid + 8 * (i / 2));
              }
            }
          }
          silu_to_h(comb, acc);
#pragma unroll
          for (int f = 0; f < NFRAG; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.0f;
        }
        consumer_sync();  // every consumer's h columns are written ...
        if (tid == 0) {
          __threadfence();  // ... and visible (the fence is cumulative over the barrier)
          for (int c = c_lo; c < c_hi;) {
            const int tu = c / nkg, kc0 = c - tu * nkg, kc1 = min(nkg, kc0 + (c_hi - c));
            const int u = gu_unit(tu);
            if (u >= 0 && kc0 == 0) atomicAdd(ready + u / W.nf, 1);  // whole, or finished here
            c += kc1 - kc0;
          }
        }
      });
}

}  // namespace

// Once per device, before the first launch: raises the kernel's dynamic
// shared-memory limit to the most a block may opt into, finds the
// driver's tensor-map encoder, and returns the SM count (the persistent
// grid) and that limit.
extern "C" int fused_swiglu_gmm_init(int* n_sm, int* max_smem) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = find_tensor_map_encoder();
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fused_swiglu_gmm_kernel);
  if (err != cudaSuccess) return (int)err;
  *max_smem = optin - (int)fa.sharedSizeBytes;
  g_max_smem = *max_smem;
  return (int)cudaFuncSetAttribute(fused_swiglu_gmm_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, *max_smem);
}

// What a launch over (G, C, F) on `n_blocks` blocks needs from the
// caller: float32 partials of one shared gate/up unit per block, int32
// counters (two per item, one per gate/up unit), and the ring stages that
// fit (the wrapper refuses fewer than 2).
extern "C" void fused_swiglu_gmm_scratch(int G, int C, int F, int n_blocks,
                                         long long* part_floats, long long* n_counters,
                                         int* stages) {
  const long long items = (long long)G * ((C + RB - 1) / RB);
  *part_floats = (long long)n_blocks * x_rows(C) * 2 * BF;
  *n_counters = items * (2 + F / BF);
  *stages = stages_for(G, C, g_max_smem);
}

// Launches on `stream`; allocates nothing on the card; returns
// cudaGetLastError().  Caller guarantees: bf16 contiguous x (G, C, K), wg
// and wu (E, K, F), wd (E, F, N), h (G, C, F) and out (G, C, N) with
// 16-byte aligned bases, K, F and N positive multiples of 64, int32 group
// tables, scratch as fused_swiglu_gmm_scratch says (the counters zero
// before the first launch; each launch leaves them at zero), and a prior
// fused_swiglu_gmm_init on this device.
extern "C" int fused_swiglu_gmm(const void* x, const void* wg, const void* wu, const void* wd,
                                const int* group_sizes, const int* rhs_of_group, void* h,
                                float* part, void* out, int* counters, int G, int C, int K, int F,
                                int N, int E, int n_blocks, void* stream) {
  if (K <= 0 || F <= 0 || N <= 0 || K % BK != 0 || F % BK != 0 || N % BOX != 0 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const long long most_chunks = (long long)G * ((C + RB - 1) / RB) * (F / BF) * (K / BK);
  if (most_chunks * n_blocks >= (1LL << 32)) return (int)cudaErrorInvalidValue;  // Split's range
  if (G == 0 || C == 0) return (int)cudaGetLastError();
  const int n_stages = stages_for(G, C, g_max_smem);
  if (n_stages < 2) return (int)cudaErrorInvalidValue;
  const CUtensorMap* gm = weight_map(wg, (long long)E * K, F);
  const CUtensorMap* um = weight_map(wu, (long long)E * K, F);
  const CUtensorMap* dm = weight_map(wd, (long long)E * F, N);
  if (gm == nullptr || um == nullptr || dm == nullptr) return (int)cudaErrorInvalidValue;
  fused_swiglu_gmm_kernel<<<n_blocks, NT, fixed_bytes(G) + n_stages * stage_bytes(C),
                            static_cast<cudaStream_t>(stream)>>>(
      *gm, *um, *dm, static_cast<const __nv_bfloat16*>(x), group_sizes, rhs_of_group,
      static_cast<__nv_bfloat16*>(h), part, static_cast<__nv_bfloat16*>(out), counters, G, C, K,
      F, N, n_stages);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
