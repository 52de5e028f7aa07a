// Building blocks of the warp-specialised TMA pipelines (grouped_gemm.cu,
// fused_swiglu_gmm.cu): mbarriers, TMA and cp.async copies that complete on
// them, ldmatrix and mma.sync for bf16, and the host-side tensor maps of
// bf16 weight matrices.  Each including library keeps its own copies (the
// anonymous namespace), its own encoder pointer and map cache among them.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the driver entry point comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <tuple>

namespace {

constexpr int TMA_BOX = 64;  // rows and columns of a weight box: 128 B wide, the swizzle span

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ inline void mbar_arrive(unsigned bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// whether the barrier's phase of this parity has completed (may suspend briefly)
__device__ inline bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Until the barrier's phase of this parity has completed.  A wait of more
// than about 4e9 cycles (seconds; a chunk takes microseconds) can only be
// a fault of the pipeline: it traps, so the launch fails instead of
// hanging the card.
__device__ inline void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 4000000000LL) __trap();
}

__device__ inline void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// TMA: the box at (x, y) of a 2D tensor map into shared memory, completing
// on mbarrier `bar`
__device__ inline void tma_load_2d(unsigned dst, const CUtensorMap* map, int x, int y,
                                   unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ inline void cp_async16(unsigned dst, const void* src, bool full) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing; .cg reads
  // through L2, where another block's writes are visible
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

// an arrive on `bar` once every cp.async this thread issued so far has landed
__device__ inline void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// four 8x8 bf16 tiles: with the slab's rows as rows, the B fragments
// (b0, b1) of m16n8k16 for two 16-deep k-steps
__device__ inline void ldmatrix_x4(unsigned* r, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// four 8x8 bf16 tiles, transposed: the A fragment of m16n8k16 from a
// row-major K x N weight tile
__device__ inline void ldmatrix_x4_trans(unsigned* r, const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// a pure register operation: not volatile, so the compiler may schedule it
__device__ inline void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled = nullptr;

// Finds the driver's tensor-map encoder, once per library.
inline cudaError_t find_tensor_map_encoder() {
  if (encode_tiled != nullptr) return cudaSuccess;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  const cudaError_t e =
      cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
  if (e != cudaSuccess) return e;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
  encode_tiled = reinterpret_cast<EncodeTiled>(fn);
  return cudaSuccess;
}

// The TMA map of a bf16 weight tensor seen as `rows` rows of `cols`:
// TMA_BOX x TMA_BOX boxes, 128-byte swizzled.  Encoded on the host once per
// (address, shape) and kept: a weight tensor is launched on many times.
const CUtensorMap* weight_map(const void* w, long long rows, int cols) {
  static std::map<std::tuple<const void*, long long, int>, CUtensorMap> maps;
  const auto key = std::make_tuple(w, rows, cols);
  auto it = maps.find(key);
  if (it != maps.end()) return &it->second;
  CUtensorMap m;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {TMA_BOX, TMA_BOX}, unit[2] = {1, 1};
  if (encode_tiled == nullptr ||
      encode_tiled(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides,
                   box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return nullptr;
  return &maps.emplace(key, m).first->second;
}

}  // namespace
