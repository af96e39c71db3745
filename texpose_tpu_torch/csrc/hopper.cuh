// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels: the
// grouped dW GEMM (dw_gemm.cu) and the field forwards (field_fwd.cuh).
//
// mbarriers (init, expected bytes, arrive, a parity wait that traps instead
// of hanging), TMA tile loads and stores through CUtensorMaps encoded on the
// host (cuTensorMapEncodeTiled through the runtime's driver entry point, so
// no library needs -lcuda), bulk-group waits, the proxy fence between
// generic shared-memory writes and the async proxy (TMA, wgmma), named
// barriers, the ReLU-and-round conversion and stmatrix of the forwards'
// epilogues, and wgmma m64n256k16 / m64n8k16 (bf16 in, f32 accumulate) on
// shared-memory descriptors.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// The arrive, expect and copy helpers take a predicate: a thread whose `on`
// is false executes them as no-ops, without a branch (a branch on the
// thread index between a warpgroup's wgmma and its wait makes ptxas
// serialize the wgmma).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes,
                                               bool on = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool on = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((int)on)
      : "memory");
}

// Waits for the phase of parity `parity` to complete.  A stage that never
// arrives (a copy the TMA refused) traps after ~10 s instead of hanging the
// card: the launch then fails with an error the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  }
}

// TMA: the box at (col, row, plane) of `map` into shared `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, int plane,
                                         uint64_t* bar, bool on = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n}\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(plane),
      "r"(smem_u32(bar)), "r"((int)on)
      : "memory");
}

// TMA: shared `src` to the box at (col, row, plane) of `map`; elements past
// the map's bounds are not written.  Tracked by the issuing thread's bulk
// groups (bulk_commit, bulk_wait_read, bulk_wait).
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int col, int row,
                                          int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The issuing thread's committed stores have read their shared source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and have written device memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic shared-memory accesses before later accesses
// of the async proxy (wgmma operand reads, TMA stores and loads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// bf16x2 of (relu(lo), relu(hi)), round to nearest: lo in the low half (the
// lower address), as __floats2bfloat162_rn(lo, hi) after fmaxf(·, 0).
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Four 8×8 bf16 matrices to shared memory: lane l gives the address of row
// l % 8 of matrix l / 8; register i holds matrix i's elements in the mma
// accumulator layout (row l / 4, columns 2·(l % 4), +1).
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets
// (16-byte units), layout (1 = 128-byte swizzle, 0 = none).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The 128 accumulator operands of m64n256, read-write (RW) or write-only
// (W: the product overwrites them, so their earlier values are dead).
#define HOPPER_RW(i) "+f"(d[i])
#define HOPPER_W(i) "=f"(d[i])
#define HOPPER_D8(C, i) C(i), C(i + 1), C(i + 2), C(i + 3), C(i + 4), \
    C(i + 5), C(i + 6), C(i + 7)
#define HOPPER_D128(C)                                                     \
  HOPPER_D8(C, 0), HOPPER_D8(C, 8), HOPPER_D8(C, 16), HOPPER_D8(C, 24),    \
      HOPPER_D8(C, 32), HOPPER_D8(C, 40), HOPPER_D8(C, 48),                \
      HOPPER_D8(C, 56), HOPPER_D8(C, 64), HOPPER_D8(C, 72),                \
      HOPPER_D8(C, 80), HOPPER_D8(C, 88), HOPPER_D8(C, 96),                \
      HOPPER_D8(C, 104), HOPPER_D8(C, 112), HOPPER_D8(C, 120)
#define HOPPER_N256(C, scale)                                              \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "  \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "  \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "  \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
      "%127}, %128, %129, p, 1, 1, %131, 1;\n}\n"                          \
      : HOPPER_D128(C)                                                     \
      : "l"(da), "l"(db), "r"(scale), "n"(kTransA))

// D[64×256] += A·B, B MN-major (transpose bit 1); A K-major (kTransA 0:
// [rows][K] in shared memory) or MN-major (1).
template <int kTransA>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  HOPPER_N256(HOPPER_RW, 1);
}

// D[64×256] = A·B: a product's first k-step.  D is written, not read, so
// the compiler keeps no earlier value of it alive.
template <int kTransA>
__device__ __forceinline__ void wgmma_n256_first(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
  HOPPER_N256(HOPPER_W, 0);
}

#define HOPPER_N8(C, scale)                                     \
  asm volatile(                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"               \
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "    \
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, 1;\n}\n"          \
      : C(0), C(1), C(2), C(3)                                  \
      : "l"(da), "l"(db), "r"(scale), "n"(kTransA))

// D[64×8] += A·B (d[0..3]), B MN-major, A as for wgmma_n256.
template <int kTransA, int kLen>
__device__ __forceinline__ void wgmma_n8(float (&d)[kLen], uint64_t da,
                                         uint64_t db) {
  static_assert(kLen >= 4, "wgmma_n8 needs 4 accumulators");
  HOPPER_N8(HOPPER_RW, 1);
}

// D[64×8] = A·B: the first k-step, D written and not read.
template <int kTransA>
__device__ __forceinline__ void wgmma_n8_first(float (&d)[4], uint64_t da,
                                               uint64_t db) {
  HOPPER_N8(HOPPER_W, 0);
}

// Keeps the compiler from moving accumulator accesses across wgmma.
template <int kLen>
__device__ __forceinline__ void fence_acc(float (&d)[kLen]) {
#pragma unroll
  for (int i = 0; i < kLen; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 [planes, rows, cols] row-major tensor at `ptr` as a tiled map with
// boxes of box_cols × box_rows × 1: 128-byte swizzle for 64-column boxes,
// none for narrower ones; out-of-bounds elements load as zero.  Returns
// false if the driver refuses it.
bool encode_bf16(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                 long long cols, long long rows, long long planes,
                 int box_cols, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)cols * rows * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
