// The field backwards' weight gradients as one grouped GEMM on Hopper's
// tensor cores, written by hand for sm_90a and bound to PyTorch through
// ctypes (texpose_tpu_torch/kernels/dw_gemm.py).
//
// Replaces: the dW half of texpose_tpu/kernels/fused_coarse_field.py::
// _run_bwd (row 7b, the trunk-training backward) and of
// texpose_tpu/kernels/fused_st_field.py::_run_bwd (row 2, the heads'
// backward).  The TPU kernels sum dW in VMEM scratch over a sequential
// grid; Hopper's blocks run in parallel, so each backward is split in two:
// a per-tile kernel walks the layers down (the dX chain, coarse_field.cu /
// st_field.cu) and stores every layer's bf16 output gradient G (and, for
// row 2, the recomputed hidden activations H) to device planes; this file
// then forms every layer's dW = Hᵀ·G over all M rows.
//
// Problems.  The wrapper's descriptor table lists each layer segment (a
// 256×256 hidden layer, a skip layer's xext block, a layer 0's enc⊕pts
// block, the density and output tiles padded to 8 columns) cut into tiles
// of 128 dW rows; one block computes one tile over one split of the rows.
// The operands come straight from the row-major [M, width] bf16 planes:
// H's columns are the product's M dimension and G's its N dimension, both
// contiguous, so wgmma reads both transposed (MN-major, its transpose bits
// for 16-bit types) and nothing is transposed in memory.
//
// Pipeline.  One producer warp keeps a ring of kStages stages in flight:
// per 64 rows, TMA copies the H tile (two 64-column boxes) and the G tile
// (four boxes, or one 8-column box for the narrow tiles) into shared memory
// with the 128-byte swizzle wgmma expects, and signals an mbarrier with the
// bytes.  Two consumer warpgroups (64 dW rows each) issue wgmma
// m64n256k16 (m64n8k16 for the narrow tiles), bf16 in, f32 accumulate, and
// release each stage once its products are done.  Each block writes its f32
// partial tile; dw_reduce_kernel then sums the splits in a fixed order into
// the flat gradient buffer, so dW is the same from run to run and no
// atomics remain.
//
// What bounds it: the planes' bytes.  dW is ~1.38 MFLOP per row for 7b
// (0.18 TFLOP at 131,072 rows, 0.18 ms at 989 TFLOP/s) against ≈1.45 GB
// of H and G reads (0.43 ms at 3.35 TB/s); the G tile of a 256-row segment
// is read by both of its blocks, the second from L2 when they run together.
// Split-K over the rows fills the 132 SMs (one 193 KB block per SM).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                  // rows (the product's K) per stage
constexpr int kStages = 4;
constexpr int kTileI = 128;                // dW rows per block
constexpr int kTileN = 256;                // dW columns per block (wide)
constexpr int kNarrow = 8;                 // dW columns of a narrow tile
constexpr int kBoxBytes = 64 * kRows * 2;  // one 64-column bf16 box: 8 KB
constexpr int kStageA = 2 * kBoxBytes;
constexpr int kStageB = 4 * kBoxBytes;
constexpr int kStageBytes = kStageA + kStageB;
constexpr int kThreads = 288;              // 2 consumer warpgroups + producer
constexpr int kMaps = 5;                   // A sources 0..2, G wide, G narrow
constexpr int kProblemInts = 12;
constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;

struct Params {
  CUtensorMap maps[kMaps];
  const int* problems;   // [tiles][kProblemInts]
  float* partial;        // [tiles][splits][kTileI][kTileN]
  int M, rows_per_split, splits;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
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
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(plane),
      "r"(smem_u32(bar))
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

// D[64×256] += Aᵀ·B, both operands MN-major (transpose bits 1, 1).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D[64×8] += Aᵀ·B (the narrow tiles; d[0..3] of the accumulator).
__device__ __forceinline__ void wgmma_n8(float (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving accumulator accesses across wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    dw_gemm_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* const empty = full + kStages;

  const int* const pr = p.problems + blockIdx.x * kProblemInts;
  const int a_map = pr[0], a_plane = pr[1], a_col = pr[2], k_in = pr[3];
  const int b_map = pr[4], b_plane = pr[5], b_col = pr[6];
  const bool wide = pr[7] == kTileN;
  const int n_a = k_in > 64 ? 2 : 1;       // consumer warpgroups with rows
  const int r0 = blockIdx.y * p.rows_per_split;
  const int r1 = min(p.M, r0 + p.rows_per_split);
  const int chunks = r1 > r0 ? (r1 - r0 + kRows - 1) / kRows : 0;
  const uint32_t tx = n_a * kBoxBytes + (wide ? kStageB : kRows * kNarrow * 2);
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], n_a);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {                               // producer warp
    if ((threadIdx.x & 31) == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int s = c % kStages;
        if (c >= kStages) mbar_wait(&empty[s], ((c / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], tx);
        unsigned char* const st = smem + s * kStageBytes;
        const int row = r0 + c * kRows;
        for (int a = 0; a < n_a; ++a)
          tma_load(st + a * kBoxBytes, &p.maps[a_map], a_col + 64 * a, row,
                   a_plane, &full[s]);
        if (wide) {
          for (int b = 0; b < 4; ++b)
            tma_load(st + kStageA + b * kBoxBytes, &p.maps[b_map],
                     b_col + 64 * b, row, b_plane, &full[s]);
        } else {
          tma_load(st + kStageA, &p.maps[b_map], b_col, row, b_plane,
                   &full[s]);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;                      // dW rows wg*64 ..
  if (wg >= n_a) return;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kStages;
    mbar_wait(&full[s], (c / kStages) & 1);
    const uint32_t a_addr = smem_u32(smem + s * kStageBytes + wg * kBoxBytes);
    const uint32_t b_addr = smem_u32(smem + s * kStageBytes + kStageA);
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kRows / 16; ++k) {
      // A: 64 columns = one 128-byte swizzle row per K row; the second
      // 8-row group 1024 B on.  B: 64-column boxes 8 KB apart (wide) or
      // 16-byte rows, 8-row groups 128 B apart (narrow, unswizzled).
      const uint64_t da = desc(a_addr + k * 2048, kBoxBytes, 1024, 1);
      if (wide)
        wgmma_n256(d, da, desc(b_addr + k * 2048, kBoxBytes, 1024, 1));
      else
        wgmma_n8(d, da, desc(b_addr + k * 256, 128, 128, 0));
    }
    wgmma_commit();
    fence_acc(d);
    wgmma_wait<1>();                             // chunk c-1 is done
    if (c > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(&empty[(c - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_acc(d);

  // this block's partial tile: rows wg*64.., f32
  float* const out = p.partial +
                     ((size_t)blockIdx.x * p.splits + blockIdx.y) * kTileI * kTileN;
  const int t = threadIdx.x & 127;
  const int row = wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
  const int col = 2 * (t & 3);
  const int nj = wide ? kTileN / 8 : 1;
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    if (j < nj) {
      *reinterpret_cast<float2*>(out + (size_t)row * kTileN + 8 * j + col) =
          make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (size_t)(row + 8) * kTileN + 8 * j +
                                 col) = make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

// grads[out + i·n + c] = Σ_splits partial, in split order, for the tile's
// k_in rows and n columns.
__global__ void dw_reduce_kernel(const float* partial, const int* problems,
                                 int splits, float* grads) {
  const int* const pr = problems + blockIdx.y * kProblemInts;
  const int k_in = pr[3], n = pr[7], out = pr[8];
  const float* const src = partial + (size_t)blockIdx.y * splits * kTileI * kTileN;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < k_in * n;
       e += gridDim.x * blockDim.x) {
    const int i = e / n, c = e - i * n;
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      s += src[(size_t)sp * kTileI * kTileN + i * kTileN + c];
    grads[out + e] = s;
  }
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

int g_smem_set[64];

}  // namespace

// Launches the grouped dW GEMM on `stream`.  maps: kMaps × {device pointer,
// columns, rows, planes, box columns} of bf16 [planes, rows, columns]
// row-major sources (box columns 64: 128-byte swizzle; 8: none); problems:
// device int32 [tiles][12] {a map, a plane, a column, dW rows (≤ 128),
// b map, b plane, b column, n (256 or 8), out offset, -, -, -}; partial:
// f32 [tiles][splits][128][256].  Returns a cudaError_t (0 = launched).
extern "C" int dw_gemm(const long long* maps, const void* problems, int tiles,
                       void* partial, int M, int rows_per_split, int splits,
                       void* stream) {
  if (tiles <= 0 || splits <= 0) return 0;
  if (M <= 0 || rows_per_split % kRows) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  Params p = {};
  for (int m = 0; m < kMaps; ++m) {
    const long long* d = maps + 5 * m;
    const cuuint64_t dims[3] = {(cuuint64_t)d[1], (cuuint64_t)d[2],
                                (cuuint64_t)d[3]};
    const cuuint64_t strides[2] = {(cuuint64_t)d[1] * 2,
                                   (cuuint64_t)d[1] * d[2] * 2};
    const cuuint32_t box[3] = {(cuuint32_t)d[4], (cuuint32_t)kRows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(
        &p.maps[m], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
        reinterpret_cast<void*>(d[0]), dims, strides, box, elem,
        CU_TENSOR_MAP_INTERLEAVE_NONE,
        d[4] == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  p.problems = static_cast<const int*>(problems);
  p.partial = static_cast<float*>(partial);
  p.M = M;
  p.rows_per_split = rows_per_split;
  p.splits = splits;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!g_smem_set[dev]) {
    e = cudaFuncSetAttribute(dw_gemm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    g_smem_set[dev] = 1;
  }
  dw_gemm_kernel<<<dim3(tiles, splits), kThreads, kSmem,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Launches the fixed-order sum of the partial tiles into the flat f32
// gradient buffer on `stream`.  Returns a cudaError_t (0 = launched).
extern "C" int dw_reduce(const void* partial, const void* problems, int tiles,
                         int splits, void* grads, void* stream) {
  if (tiles <= 0) return 0;
  dw_reduce_kernel<<<dim3(32, tiles), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<const int*>(problems),
      splits, static_cast<float*>(grads));
  return (int)cudaGetLastError();
}
